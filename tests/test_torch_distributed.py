"""The port's multi-process runtime (``terra_tpu_torch.parallel.distributed``)
on 8 local gloo ranks on the CPU, the twin of tests/test_distributed.py.

This file run as a script is one rank: it joins the group through an
explicit coordinator, builds the ('rows', 'samples') layout with
``pod_mesh(sample_ways=2)``, sums the ranks over both axes and over each,
renders its rows and sample slice of the Cornell box and takes the
sharded gradient, and saves what it holds for the tests to stitch and
compare. The group is launched twice, so the tests can also hold the
gradients of two launches of one layout to each other.

    python tests/test_torch_distributed.py <host:port> <rank> <ranks> <out dir>
"""
import json
import os
import sys

import numpy as np
import pytest

NPROC = 8
OPTS = dict(width=16, height=16, samples_per_pixel=4, bounces=2, subpixel_jitter=0.5)


def _worker(coord: str, rank: str, nproc: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import band_rows_of, render_chunk_sharded

    rank = int(rank)
    dev = distributed.initialize(coordinator_address=coord, num_processes=int(nproc),
                                 process_id=rank, device="cpu")
    again = distributed.initialize(coordinator_address=coord, num_processes=int(nproc),
                                   process_id=rank, device="cpu")  # idempotent
    mesh = distributed.pod_mesh(sample_ways=2, device="cpu")
    info = {"world": dist.get_world_size(), "rank": dist.get_rank(), "device": str(dev),
            "again": str(again), "backend": dist.get_backend(),
            "coordinator": distributed.is_coordinator(), "shape": mesh.shape,
            "row": mesh.row, "sample": mesh.sample}
    x = torch.tensor([float(rank)])
    info["sum_all"] = float(mesh.all_reduce(x.clone())[0])
    info["sum_samples"] = float(mesh.all_reduce(x.clone(), "samples")[0])
    info["sum_rows"] = float(mesh.all_reduce(x.clone(), "rows")[0])

    scene = ttt.scenes.cornell_box(device="cpu")
    cam = ttt.scenes.cornell_camera(device="cpu")
    opts = ttt.RenderOptions(**OPTS, integrator=ttt.Integrator.DIRECT)
    key = rng.key_from_seed(5)
    band = render_chunk_sharded(scene, cam, opts, key, 0, 4, mesh)
    params = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
    gf = optim.make_grad_fn_sharded(cam, opts, torch.zeros((16, 16, 3)), mesh, grad_chunks=2)
    loss, grads = gf(params, scene, key, 0)
    np.savez(os.path.join(out, f"rank{rank}.npz"), band=band.numpy(),
             rows=band_rows_of(mesh, opts.height).numpy(), loss=loss.numpy(),
             **{f"grad_{k}": g.numpy() for k, g in grads.items()})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def _launch(tmp_path_factory, name):
    from tests.test_torch_sharding import run_ranks

    out = tmp_path_factory.mktemp(name)
    run_ranks(__file__, NPROC, out)
    ranks = []
    for i in range(NPROC):
        with np.load(out / f"rank{i}.npz") as z, open(out / f"rank{i}.json") as f:
            ranks.append((json.load(f), dict(z)))
    return ranks


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    return _launch(tmp_path_factory, "launch1")


def test_initialize_pod_mesh_and_coordinator(launch):
    """Explicit-coordinator initialize (twice: idempotent), the default
    gloo backend on the CPU, pod_mesh(2) = (4, 2) with rank = ri * 2 + si,
    and rank 0 alone the coordinator."""
    for i, (info, _) in enumerate(launch):
        assert info["world"] == NPROC and info["rank"] == i
        assert info["device"] == info["again"] == "cpu" and info["backend"] == "gloo"
        assert info["shape"] == {"rows": 4, "samples": 2}
        assert (info["row"], info["sample"]) == divmod(i, 2)
        assert info["coordinator"] == (i == 0)


def test_all_reduce_over_both_axes(launch):
    """Each rank's id summed over every rank is 0 + ... + 7 = 28; over its
    sample group, the two ranks of its row band; over its row group, the
    four ranks of its sample slice."""
    for i, (info, _) in enumerate(launch):
        r, s = divmod(i, 2)
        assert info["sum_all"] == 28.0
        assert info["sum_samples"] == float(2 * r + 2 * r + 1)
        assert info["sum_rows"] == float(sum(2 * k + s for k in range(4)))


def test_stitched_render_matches_single_process(launch):
    """The ranks' row bands (sample slices summed) stitch into the
    single-process frame, within f32 reassociation of the sample sums, and
    terra_tpu's single-process chunk within the golden twin budgets."""
    import jax.numpy as jnp
    import torch

    import terra_tpu as tt
    from terra_tpu.ops import rng as jrng
    from terra_tpu.render import render_chunk
    import terra_tpu_torch as ttt
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import render_rows
    from tests.test_golden import _assert_twin_match

    acc = np.zeros((16, 16, 3), np.float32)
    seen = np.zeros(16, bool)
    for info, z in launch:
        if info["sample"] == 0:
            acc[z["rows"]] = z["band"]
            seen[z["rows"]] = True
        else:  # the other sample slice holds the same summed band
            np.testing.assert_array_equal(z["band"], launch[info["rank"] - 1][1]["band"])
    assert seen.all()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        opts = ttt.RenderOptions(**OPTS, integrator=ttt.Integrator.DIRECT)
        port = render_rows(ttt.scenes.cornell_box(device="cpu"),
                           ttt.scenes.cornell_camera(device="cpu"), opts, rng.key_from_seed(5),
                           0, 4, 0, 16).numpy()
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(acc, port, rtol=1e-5, atol=1e-6 * float(np.abs(port).max()))
    k0, k1 = jrng.key_from_seed(5)
    ref = np.asarray(render_chunk(tt.scenes.cornell_box(), tt.scenes.cornell_camera(),
                                  tt.RenderOptions(**OPTS, integrator=tt.Integrator.DIRECT),
                                  jnp.array([k0, k1], jnp.uint32), jnp.int32(0), 4))
    _assert_twin_match(acc, ref, 2e-3, 8e-3, 5e-3)


def test_gradients_bit_equal_across_ranks_and_launches(launch, tmp_path_factory):
    """The sharded gradient and loss are the same bits on every rank, and
    the same bits in a second launch of the same layout."""
    second = _launch(tmp_path_factory, "launch2")
    keys = [k for k in launch[0][1] if k.startswith("grad_")] + ["loss"]
    assert len(keys) == 3
    for run in (launch, second):
        for _, z in run:
            for k in keys:
                np.testing.assert_array_equal(z[k], launch[0][1][k])
    assert np.isfinite(launch[0][1]["loss"]) and np.abs(launch[0][1]["grad_attrs"]).max() > 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _worker(*sys.argv[1:])
