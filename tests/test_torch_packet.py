"""The port's stackless packet walk (``terra_tpu_torch.accel.traverse.raycast``
and ``_packet_raycast``) against terra_tpu's on the same trees (carried
across with interop): the small courtyard, the Cornell box, a random soup
and a single-leaf tree; closest hit and any hit; octant-sorted and
parent-hit-sorted batches. Hit masks are equal, t is bit-equal wherever
the triangle ids agree, and the ids agree on >= 99% of hits (shared-edge
ties, test_pallas_traverse.py:33-34).

The reference runs op by op (``jax.disable_jit``): compiled, XLA's CPU
code contracts the Moller-Trumbore products into fused multiply-adds and
moves the last bit of about two thirds of the t values of a leaf grid,
while each operation run alone rounds as PyTorch's does."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu.accel import traverse as jtrav
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch.accel import pallas_traverse as tpt
from terra_tpu_torch.accel import traverse as ttrav
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import SMALL_COURTYARD, flatten

N_RAYS = 600  # not a multiple of the packet size: the last packet is padded


def _scene(case):
    if case == "courtyard":
        js = tt.scenes.courtyard(**SMALL_COURTYARD)
    elif case == "cornell":
        js = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    elif case == "random":
        js = tt.scenes.random_triangles(150, seed=4, accelerator=tt.Accelerator.BVH)
    else:
        js = tt.scenes.random_triangles(5, seed=5, accelerator=tt.Accelerator.BVH)
    return js, interop.scene_from_numpy(flatten(js), device="cpu")


def _rays(ts, seed):
    """Rays from inside the root box's neighbourhood, half in random
    directions and half aimed at a random triangle's centroid, with t_max
    seeds and parent-hit hints (-1 for a fifth of them)."""
    r = np.random.default_rng(seed)
    lo, hi = ts.bvh.node_min[0].numpy(), ts.bvh.node_max[0].numpy()
    o = (lo + r.uniform(-0.1, 1.1, (N_RAYS, 3)) * (hi - lo)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    centroids = sum(c.numpy() for c in ts.geometry.corners()) / 3.0
    aim = centroids[r.integers(0, len(centroids), N_RAYS // 2)] - o[: N_RAYS // 2]
    d[: N_RAYS // 2] = aim
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = r.uniform(0.05, 1.0, N_RAYS).astype(np.float32) * float(np.abs(hi - lo).max())
    hint = r.integers(0, ts.geometry.num_triangles, N_RAYS).astype(np.int32)
    hint[r.uniform(size=N_RAYS) < 0.2] = -1
    return o, d, t_max, hint


def _check(got, ref, any_hit):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    t, rt = got.t.numpy(), np.asarray(ref.t)
    if any_hit:  # t: 0 after an accepted hit, else the seed (or a single leaf's t)
        np.testing.assert_array_equal(t, rt)
        return
    assert hit.any()
    same = got.tri.numpy()[hit] == np.asarray(ref.tri)[hit]
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(t[hit][same], rt[hit][same])
    np.testing.assert_array_equal(t[~hit], rt[~hit])


# Every combination on the small scenes; on the larger ones, whose op-by-op
# reference takes seconds a walk, each mode and each sort once.
CASES = [(c, a, s) for c in ("cornell", "single_leaf") for a in (False, True)
         for s in ("octant", "hinted", "unsorted")] + [
    ("courtyard", False, "octant"), ("courtyard", True, "hinted"),
    ("random", False, "hinted"), ("random", True, "octant"), ("random", False, "unsorted")]


@pytest.mark.parametrize("case,any_hit,sort", CASES)
def test_packet_walk_matches_terra_tpu(case, any_hit, sort):
    js, ts = _scene(case)
    assert (ts.bvh.num_internal == 0) == (case == "single_leaf")
    o, d, t_max, hint = _rays(ts, seed=len(case) + 10 * any_hit)
    kw, jkw = {}, {}
    if sort == "hinted":
        kw = dict(sort_hint=torch.as_tensor(hint), leaf_of_tri=ttrav.leaf_of_tri_table(ts.bvh))
        jkw = dict(sort_hint=jnp.asarray(hint), leaf_of_tri=jtrav.leaf_of_tri_table(js.bvh))
    elif sort == "unsorted":
        kw, jkw = dict(sort_rays=False), dict(sort_rays=False)
    if any_hit:
        kw.update(t_max=torch.as_tensor(t_max), any_hit=True)
        jkw.update(t_max=jnp.asarray(t_max), any_hit=True)
    got = ttrav.raycast(ts, torch.as_tensor(o), torch.as_tensor(d), **kw)
    with jax.disable_jit():
        ref = jtrav.raycast(js, jnp.asarray(o), jnp.asarray(d), **jkw)
    _check(got, ref, any_hit)


@pytest.mark.parametrize("algo", ["mt", "watertight"])
def test_packet_walk_matches_the_kernel_walk(algo):
    """The packet walk finds what the port's plain BVH4 walk (the CUDA
    kernel's bit-exact plain version) finds."""
    _, ts = _scene("courtyard")
    o, d, _, _ = _rays(ts, seed=3)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    got = ttrav.raycast(ts, o, d, algo=algo)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    ref = tpt.raycast(ts, o, d, tables=tables, algo=algo)
    _check(got, ref, False)


def test_packet_raycast_takes_packets_and_seeds():
    """_packet_raycast on (P2, P, 3) packets with a t_init seed: a seed
    below every hit leaves best t at the seed and finds nothing."""
    js, ts = _scene("cornell")
    o, d, _, _ = _rays(ts, seed=8)
    o, d = (torch.as_tensor(x[:576]).reshape(9, 64, 3) for x in (o, d))
    corners = ts.geometry.corners()
    t, i = ttrav._packet_raycast(ts.bvh, *corners, o, d)
    with jax.disable_jit():
        jt, ji = jtrav._packet_raycast(js.bvh, *js.geometry.corners(), jnp.asarray(o.numpy()),
                                       jnp.asarray(d.numpy()))
    same = i.numpy() == np.asarray(ji)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(t.numpy()[same], np.asarray(jt)[same])
    seed = torch.full((9, 64), 1e-6)
    t0, _ = ttrav._packet_raycast(ts.bvh, *corners, o, d, t_init=seed)
    assert torch.equal(t0, seed)
