"""The port's rows x samples sharding (``terra_tpu_torch.parallel.mesh`` and
the sharded gradient of ``optim``) on 8 local gloo ranks on the CPU, the
twins of tests/test_sharding.py.

One 8-rank group (this file run as a script, one process per rank, each
single-threaded) builds every layout the tests need and rank 0 saves the
gathered frames and gradients; the tests hold them against the port's own
single-process ``render_rows`` and ``value_and_grad`` in this process, and
against terra_tpu's sharded functions on this process's 8-device CPU mesh.

    python tests/test_torch_sharding.py <host:port> <rank> <ranks> <out.npz>
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
RENDER = dict(width=16, height=16, samples_per_pixel=8, bounces=2, subpixel_jitter=0.5)
GRAD = dict(width=8, height=8, samples_per_pixel=8, bounces=1)  # test_sharding.py's grad case
BAND = 8  # two bands of 8 rows over 8 row shards: one row per rank and band


def run_ranks(script: str, nproc: int, *args, timeout: float = 600.0) -> list:
    """Run ``script <host:port> <rank> <nproc> *args`` as ``nproc`` local
    processes joined through one coordinator; returns their outputs and
    fails the test on any nonzero exit."""
    from terra_tpu_torch.parallel.distributed import _free_port

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, coord, str(i), str(nproc), *map(str, args)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("ranks timed out\n" + "\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


# --- the ranks ---------------------------------------------------------------

def _worker(coord: str, rank: str, nproc: str, out: str) -> None:
    import torch

    torch.set_num_threads(1)
    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import (band_rows_of, gather_rows, make_mesh,
                                               render_band_sharded, render_chunk_sharded,
                                               render_sharded)

    distributed.initialize(coord, int(nproc), int(rank), device="cpu")
    scene = ttt.scenes.cornell_box(device="cpu")
    cam = ttt.scenes.cornell_camera(device="cpu")
    opts = ttt.RenderOptions(**RENDER, integrator=ttt.Integrator.DIRECT)
    key = rng.key_from_seed(0)
    h = opts.height
    res = {}
    meshes = {shape: make_mesh(shape, device="cpu") for shape in SHAPES}
    for (r, s), mesh in meshes.items():
        band = render_chunk_sharded(scene, cam, opts, key, 0, 8, mesh)
        res[f"chunk_{r}x{s}"] = gather_rows(band, band_rows_of(mesh, h), h, mesh)
    mesh = meshes[(8, 1)]
    parts = torch.cat([render_band_sharded(scene, cam, opts, key, 0, b0, 8, BAND, mesh)
                       for b0 in range(0, h, BAND)])
    res["band"] = gather_rows(parts, band_rows_of(mesh, h, BAND), h, mesh)
    for (r, s) in ((8, 1), (4, 2)):
        film = render_sharded(scene, cam, opts, meshes[(r, s)], seed=0)
        rows = band_rows_of(meshes[(r, s)], h)
        res[f"film_{r}x{s}"] = gather_rows(film.acc, rows, h, meshes[(r, s)])
        res[f"film_samples_{r}x{s}"] = gather_rows(film.samples, rows, h, meshes[(r, s)])

    # gradients: test_sharding.py's chunked case at mesh (4, 2)
    gopts = ttt.RenderOptions(**GRAD, integrator=ttt.Integrator.DIRECT)
    target = torch.zeros((8, 8, 3))
    params = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
    for chunks in (1, 4):
        gf = optim.make_grad_fn_sharded(cam, gopts, target, meshes[(4, 2)], grad_chunks=chunks)
        loss, grads = gf(params, scene, rng.key_from_seed(3), 0)
        res[f"loss_{chunks}"] = loss
        for k, g in grads.items():
            res[f"grad_{chunks}_{k}"] = g
    step = optim.make_train_step_sharded(cam, gopts, target,
                                         lambda ps: torch.optim.SGD(ps, lr=1e-2), meshes[(4, 2)])
    state, loss = step(optim.TrainState(optim.extract_params(scene, ("attrs", "emissive")),
                                        None, 0), scene, rng.key_from_seed(3))
    res["step_loss"] = loss
    for k, p in state.params.items():
        res[f"step_{k}"] = p.detach()
    if int(rank) == 0:
        np.savez(out, **{k: v.detach().numpy() for k, v in res.items()})


# --- the tests -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding") / "rank0.npz"
    run_ranks(__file__, 8, out)
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def single():
    """The port's single-process frame (one thread) and terra_tpu's
    single-device chunk, the same scene, key and options."""
    import torch
    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu.ops import rng as jrng
    from terra_tpu.render import render_chunk
    import terra_tpu_torch as ttt
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import render_rows

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        opts = ttt.RenderOptions(**RENDER, integrator=ttt.Integrator.DIRECT)
        port = render_rows(ttt.scenes.cornell_box(device="cpu"),
                           ttt.scenes.cornell_camera(device="cpu"), opts, rng.key_from_seed(0),
                           0, 8, 0, opts.height).numpy()
    finally:
        torch.set_num_threads(threads)
    jopts = tt.RenderOptions(**RENDER, integrator=tt.Integrator.DIRECT)
    k0, k1 = jrng.key_from_seed(0)
    jref = np.asarray(render_chunk(tt.scenes.cornell_box(), tt.scenes.cornell_camera(), jopts,
                                   jnp.array([k0, k1], jnp.uint32), jnp.int32(0), 8))
    return port, jref


def _close(a, ref):
    """Sample sums added in another order: f32 reassociation only."""
    np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_single_process(ranks, single, shape):
    """Every layout gives the single-process frame: bit for bit when only
    rows are sharded, within f32 reassociation of the sample sums
    otherwise; and terra_tpu's sharded chunk on the same layout of this
    process's 8-device CPU mesh within the golden twin budgets."""
    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu.ops import rng as jrng
    from terra_tpu.parallel.mesh import make_mesh, render_chunk_sharded
    from tests.test_golden import _assert_twin_match

    port, _ = single
    got = ranks[f"chunk_{shape[0]}x{shape[1]}"]
    if shape[1] == 1:
        np.testing.assert_array_equal(got, port)
    else:
        _close(got, port)
    k0, k1 = jrng.key_from_seed(0)
    jopts = tt.RenderOptions(**RENDER, integrator=tt.Integrator.DIRECT)
    ref = np.asarray(render_chunk_sharded(tt.scenes.cornell_box(), tt.scenes.cornell_camera(),
                                          jopts, jnp.array([k0, k1], jnp.uint32), jnp.int32(0), 8,
                                          make_mesh(shape)))
    _assert_twin_match(got, ref, 2e-3, 8e-3, 5e-3)


def test_band_sharded_matches_whole_frame(ranks, single):
    """Rows rendered band by band with global pixel ids: the same frame bit
    for bit."""
    np.testing.assert_array_equal(ranks["band"], single[0])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_render_sharded_film(ranks, single, shape):
    port, jref = single
    r, s = shape
    assert (ranks[f"film_samples_{r}x{s}"] == 8).all()
    film = ranks[f"film_{r}x{s}"]
    if s == 1:
        np.testing.assert_array_equal(film, port)
    else:
        _close(film, port)
    np.testing.assert_allclose(film, jref, rtol=1e-4, atol=1e-4)  # test_sharding.py's budget


def _port_grads():
    """The port's unsharded (loss, grads) of the gradient case."""
    import torch

    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng

    scene = ttt.scenes.cornell_box(device="cpu")
    opts = ttt.RenderOptions(**GRAD, integrator=ttt.Integrator.DIRECT)
    loss_fn = optim.make_loss_fn(ttt.scenes.cornell_camera(device="cpu"), opts,
                                 torch.zeros((8, 8, 3)))
    params = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
    loss, grads = optim.value_and_grad(loss_fn, params, scene, rng.key_from_seed(3), 0)
    return float(loss), dict(zip(sorted(params), (g.numpy() for g in grads)))


def test_chunked_grad_allreduce_matches_unchunked(ranks):
    """grad_chunks 4 (an all-reduce after each chunk's backward) gives the
    gradients of grad_chunks 1, and the sharded train step applies them."""
    assert np.isclose(ranks["loss_1"], ranks["loss_4"], rtol=1e-6)
    for k in ("attrs", "emissive"):
        np.testing.assert_allclose(ranks[f"grad_4_{k}"], ranks[f"grad_1_{k}"], rtol=1e-5,
                                   atol=1e-7)
    import terra_tpu_torch as ttt

    scene = ttt.scenes.cornell_box(device="cpu")
    p0 = {"attrs": scene.materials.attrs.numpy(), "emissive": scene.materials.emissive.numpy()}
    np.testing.assert_allclose(ranks["step_loss"], ranks["loss_1"], rtol=1e-6)
    for k, p in p0.items():
        np.testing.assert_allclose(ranks[f"step_{k}"], p - 1e-2 * ranks[f"grad_1_{k}"],
                                   rtol=1e-6, atol=1e-7)


def test_sharded_grads_match_unsharded_and_terra_tpu(ranks):
    """The sharded gradient is the single-process gradient (no sample-axis
    scaling) to test_torch_grad.py's twin tolerance, and terra_tpu's
    make_grad_fn_sharded on the same (4, 2) layout of the 8-device mesh."""
    import jax.numpy as jnp

    import terra_tpu as tt
    from terra_tpu import optim as joptim
    from terra_tpu.ops import rng as jrng
    from terra_tpu.parallel.mesh import make_mesh
    from tests.test_torch_grad import FLIP_FRAC, GRAD_FLIP_TOL, GRAD_TOL

    loss, grads = _port_grads()
    np.testing.assert_allclose(ranks["loss_1"], loss, rtol=1e-5)
    scene = tt.scenes.cornell_box()
    jopts = tt.RenderOptions(**GRAD, integrator=tt.Integrator.DIRECT)
    k0, k1 = jrng.key_from_seed(3)
    gf = joptim.make_grad_fn_sharded(tt.scenes.cornell_camera(), jopts,
                                     jnp.zeros((8, 8, 3), jnp.float32), make_mesh((4, 2)))
    jloss, jgrads = gf(joptim.extract_params(scene, ("attrs", "emissive")), scene,
                       jnp.array([k0, k1], jnp.uint32), jnp.int32(0))
    np.testing.assert_allclose(ranks["loss_1"], float(jloss), rtol=1e-5)
    for k in ("attrs", "emissive"):
        got = ranks[f"grad_1_{k}"]
        for ref in (grads[k], np.asarray(jgrads[k])):
            scale = np.abs(ref).max()
            assert scale > 0.0
            diff = np.abs(got - ref) / scale
            assert diff.max() <= GRAD_FLIP_TOL, diff.max()
            assert (diff > GRAD_TOL).mean() <= FLIP_FRAC, (diff > GRAD_TOL).mean()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(*sys.argv[1:])
