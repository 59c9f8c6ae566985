"""The port's ``intersect.ray_aabb``, ``moller_trumbore`` and
``raycast_brute`` (the reference's parameter order: ``ray_chunk`` before
``tri_block``) against ``terra_tpu.intersect`` on the cases of
tests/test_intersect.py: the analytic triangle and box, and the brute-force
sweeps of random scenes called as that file calls them.

Tolerances: hit flags and triangle ids exactly; t, u and v within 1e-6
relative (the same f32 products in the same order; XLA may contract a
product and a sum into one rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terra_tpu import intersect as jint
from terra_tpu import scenes as jscenes
import terra_tpu_torch as ttt
from terra_tpu_torch import intersect as tint
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-6

TRI = ([[0.0, 0.0, 5.0]], [[2.0, 0.0, 5.0]], [[0.0, 2.0, 5.0]])
MT_RAYS = {"inside": [[0.5, 0.5, 0.0]], "outside": [[3.0, 3.0, 0.0]],
           "behind": [[0.5, 0.5, 10.0]]}


def _both(fn_j, fn_t, *arrays):
    """fn on JAX arrays and on torch tensors of the same float32 arrays."""
    a = [np.asarray(x, np.float32) for x in arrays]
    return ([np.asarray(x) for x in fn_j(*map(jnp.asarray, a))],
            [x.numpy() for x in fn_t(*map(torch.as_tensor, a))])


@pytest.mark.parametrize("ray", sorted(MT_RAYS))
def test_moller_trumbore_matches_reference(ray):
    """test_intersect.py:9-30's rays: (valid, t, u, v) equal, and the
    inside ray's analytic hit t 5, u = v = 0.25."""
    ref, got = _both(jint.moller_trumbore, tint.moller_trumbore, MT_RAYS[ray],
                     [[0.0, 0.0, 1.0]], *TRI)
    np.testing.assert_array_equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=RTOL)
    if ray == "inside":
        assert got[0][0]
        np.testing.assert_allclose([got[1][0], got[2][0], got[3][0]], [5.0, 0.25, 0.25],
                                   atol=1e-5)
    else:
        assert not got[0][0]


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_ray_aabb_matches_reference(sign):
    """test_intersect.py:33-40: toward the unit box (a hit, tmin 4, tmax 6)
    and away from it (a miss), and a flat box that the >= test keeps."""
    o = [[0.0, 0.0, -5.0], [0.3, 0.2, -5.0]]
    inv = [[sign * np.inf, sign * np.inf, sign * 1.0]] * 2  # 1 / d of d = (0, 0, sign)
    lo = [[-1.0, -1.0, -1.0], [-1.0, -1.0, 0.0]]
    hi = [[1.0, 1.0, 1.0], [1.0, 1.0, 0.0]]
    ref, got = _both(jint.ray_aabb, tint.ray_aabb, o, inv, lo, hi)
    np.testing.assert_array_equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=RTOL)
    assert got[0].tolist() == ([True, True] if sign > 0 else [False, False])
    if sign > 0:
        np.testing.assert_allclose([got[1][0], got[2][0]], [4.0, 6.0], atol=1e-5)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("tris,n,seed,ray_chunk,tri_block,algo", [
    (333, 2048, 0, 512, 128, "mt"),         # test_intersect.py:43-59
    (200, 1024, 7, 512, 64, "mt"),          # test_intersect.py:70-80
    (200, 1024, 7, 512, 64, "watertight"),  # test_intersect.py:70-80
])
def test_raycast_brute_matches_reference(tris, n, seed, ray_chunk, tri_block, algo):
    """The brute-force sweep called as test_intersect.py calls it
    (``ray_chunk=..., tri_block=...``) in both packages: hits and ids
    equal, t within RTOL; and the port's result does not depend on the
    chunking (positional arguments in the reference's order, automatic
    chunks, one ray a chunk)."""
    seed_scene = 5 if tris == 333 else 3
    js = jscenes.random_triangles(tris, seed=seed_scene)
    ts = ttt.scenes.random_triangles(tris, seed=seed_scene, device="cpu")
    o, d = _rays(n, seed)
    ref = jint.raycast_brute(jnp.asarray(o), jnp.asarray(d), *js.geometry.corners(),
                             ray_chunk=ray_chunk, tri_block=tri_block, algo=algo)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    got = tint.raycast_brute(ot, dt, *ts.geometry.corners(), ray_chunk=ray_chunk,
                             tri_block=tri_block, algo=algo)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=RTOL)
    for other in (tint.raycast_brute(ot, dt, *ts.geometry.corners(), ray_chunk, tri_block, algo),
                  tint.raycast_brute(ot, dt, *ts.geometry.corners(), tri_block=tri_block,
                                     algo=algo),
                  tint.raycast_brute(ot[:64], dt[:64], *ts.geometry.corners(), 1, tri_block,
                                     algo)):
        k = other.t.shape[0]
        assert torch.equal(other.t, got.t[:k]) and torch.equal(other.tri, got.tri[:k])


@pytest.mark.parametrize("shape", ["flat", "packets"])
@pytest.mark.parametrize("algo", ["mt", "watertight"])
def test_grid_helpers_match_reference(algo, shape):
    """``mt_grid_components`` and ``_closest_hit_block`` against
    terra_tpu.intersect's: the (rays x triangles) grid as brute force calls
    it (``flat``: (N, 3) against (TB, 3)) and as the packet walk does
    (``packets``: (P2, P, 3) against (P2, L, 3)); valid exactly, t within
    RTOL where valid. Every triangle is there twice, so each hit ties, and
    the first index at the least t wins, as in the reference."""
    ts = ttt.scenes.random_triangles(48, seed=9, device="cpu")
    tris = [np.concatenate([x.numpy()] * 2) for x in ts.geometry.corners()]
    o, _ = _rays(256, 13)
    aim = sum(tris)[np.arange(256) % 48] / 3 - o  # each ray at a triangle's centroid
    d = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    if shape == "packets":
        o, d = o.reshape(4, 64, 3), d.reshape(4, 64, 3)
        tris = [np.stack([x[:48], x[48:], x[:48], x[48:]]) for x in tris]
    ref, got = _both(lambda *a: jint.mt_grid_components(*a, algo=algo),
                     lambda *a: tint.mt_grid_components(*a, algo=algo), o, d, *tris)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].shape == ((256, 96) if shape == "flat" else (4, 64, 48))
    np.testing.assert_allclose(np.where(got[0], got[1], 0), np.where(ref[0], ref[1], 0),
                               rtol=RTOL)
    if shape == "flat":
        ref, got = _both(lambda *a: jint._closest_hit_block(*a, jnp.int32(1000), algo=algo),
                         lambda *a: tint._closest_hit_block(*a, 1000, algo=algo), o, d, *tris)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
        hit = got[0] < tint.T_FAR
        assert hit.sum() > 200 and (got[1][hit] < 1048).all() and got[1].dtype == np.int32


def test_table_choice_supports_every_test_tree(monkeypatch):
    """``fits_smem`` and ``supported`` answer true for every tree, as the
    reference's do for these: the paged tables stage at most
    ``PAGED_SMEM_BUDGET`` per block, the others nothing. ``make_raycast_fn``
    consults ``supported`` and raises for a tree it refused."""
    import importlib

    from terra_tpu.accel import pallas_traverse as jpt
    from terra_tpu_torch.accel import pallas_traverse as tpt

    trender = importlib.import_module("terra_tpu_torch.render")

    assert tpt.SMEM_NODE_BUDGET == tpt.MAX_BLOCK_SMEM >= tpt.PAGED_SMEM_BUDGET
    trees = []
    for n in (33, 700, 3000):
        js = jscenes.random_triangles(n, seed=n, accelerator=jscenes.Accelerator.BVH)
        ts = ttt.scenes.random_triangles(n, seed=n, device="cpu",
                                         accelerator=ttt.Accelerator.BVH)
        trees.append(ts.bvh)
        assert jpt.fits_smem(js.bvh) and jpt.supported(js.bvh)
    trees.append(ttt.scenes.courtyard(grid=40, columns=8, device="cpu").bvh)
    for bvh in trees:
        assert tpt.fits_smem(bvh) and tpt.supported(bvh)
    monkeypatch.setattr(tpt, "NODE_TABLE_BUDGET", 1)  # every tree takes the paged tables
    for bvh in trees[1:]:
        assert tpt.wide_mode(bvh) == "paged" and tpt.fits_smem(bvh) and tpt.supported(bvh)
    monkeypatch.setattr(tpt, "supported", lambda bvh: False)
    scene = ttt.scenes.random_triangles(700, seed=700, device="cpu",
                                        accelerator=ttt.Accelerator.BVH)
    with pytest.raises(ValueError, match="supported"):
        trender.make_raycast_fn(scene, ttt.RenderOptions(width=4, height=4))
