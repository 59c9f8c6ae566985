"""Port LBVH builder, threads and refit vs terra_tpu: twins of
tests/test_bvh.py for both builders and of tests/test_components.py's
native-vs-NumPy and SAH-validity checks; the lbvh arrays, threads, refit
and BVH4 overlay bit for bit against terra_tpu's from the same positions
(the two packages compile one C++ source); an lbvh-committed render under
test_golden's twin budgets; and the deep tree the 160-entry stack exists
for, walked by the port's plain walks against terra_tpu's raycast."""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu import intersect as jint
from terra_tpu import native as jnative
from terra_tpu.accel import lbvh as jlbvh
from terra_tpu.accel import pallas_traverse as jpt
from terra_tpu.accel import traverse as jtraverse
import terra_tpu_torch as ttt
from terra_tpu_torch import native as tnative
from terra_tpu_torch.accel import lbvh as tlbvh
from terra_tpu_torch.accel import pallas_traverse as tpt
from tests.test_golden import _assert_twin_match
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import SMALL_COURTYARD
from tests.test_torch_traverse import _assert_match, _rays

BUILDERS = ["sah", "lbvh"]
BVH_FIELDS = ("node_min", "node_max", "node_left", "node_right", "leaf_tri", "tri_order",
              "dfs_next", "dfs_skip", "wide_child", "wide_src")


def _scene(tris, builder):
    """random_triangles(tris) on the CPU, committed with ``builder``."""
    s = ttt.scenes.random_triangles(tris, device="cpu", seed=tris)
    return ttt.commit(s.geometry, s.materials, accelerator=ttt.Accelerator.BVH,
                      bvh_builder=builder)


@pytest.fixture(scope="module", params=[(t, b) for b in BUILDERS for t in (47, 333, 4097)],
                ids=lambda p: f"{p[1]}-{p[0]}")
def built(request):
    return _scene(*request.param)


def test_build_covers_all_triangles(built):
    covered = set(built.bvh.leaf_tri.reshape(-1).tolist())
    assert covered == set(range(built.geometry.num_triangles))


def test_build_child_boxes_contained(built):
    bvh = built.bvh
    ni = bvh.num_internal
    bmin, bmax = bvh.node_min.numpy(), bvh.node_max.numpy()
    assert (bmin <= bmax + 1e-6).all()
    for ch in (bvh.node_left.numpy(), bvh.node_right.numpy()):
        assert (bmin[:ni] <= bmin[ch] + 1e-5).all()
        assert (bmax[:ni] >= bmax[ch] - 1e-5).all()


def test_every_leaf_reachable(built):
    """Every leaf is reached exactly once from the root, and the threads
    visit the nodes in the same preorder."""
    bvh = built.bvh
    ni = bvh.num_internal
    left, right = bvh.node_left.tolist(), bvh.node_right.tolist()
    order, stack = [], [0]
    while stack:
        node = stack.pop()
        order.append(node)
        if node < ni:
            stack += [right[node], left[node]]
    assert sorted(n - ni for n in order if n >= ni) == list(range(bvh.num_leaves))
    assert sorted(n for n in order if n < ni) == list(range(ni))
    nxt, threaded, node = bvh.dfs_next.tolist(), [], 0
    while node != -1:
        threaded.append(node)
        node = nxt[node]
    assert threaded == order


def test_traversal_matches_brute(built):
    o, d = _rays(9, 1024)
    got = tpt.raycast(built, torch.as_tensor(o), torch.as_tensor(d))
    _assert_match(got, jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                                          *(jnp.asarray(c.numpy())
                                            for c in built.geometry.corners())))


@pytest.mark.parametrize("builder", BUILDERS)
def test_refit_tracks_moved_vertices(builder):
    scene = _scene(100, builder)
    moved = dataclasses.replace(scene.geometry, positions=scene.geometry.positions + 10.0)
    bvh2 = tlbvh.refit(scene.bvh, moved)
    np.testing.assert_allclose(bvh2.node_min.numpy(), scene.bvh.node_min.numpy() + 10.0, atol=1e-4)
    scene2 = dataclasses.replace(scene, geometry=moved, bvh=bvh2)
    r = np.random.default_rng(5)
    o = r.uniform(8, 12, (256, 3)).astype(np.float32)
    d = r.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for walk in ("binary", "f32"):
        c = scene2.geometry.corners()
        tab = tpt.pack_tables(bvh2, *c) if walk == "binary" else tpt.pack_tables_wide(bvh2, *c)
        got = tpt.raycast(scene2, torch.as_tensor(o), torch.as_tensor(d), tables=tab)
        ref = jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                                 *(jnp.asarray(x.numpy()) for x in c))
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))


@pytest.mark.parametrize("tris", [5, 33, 700, 3000])
def test_wide_collapse_topology_lbvh(tris):
    """The BVH4 overlay of an lbvh tree: every leaf and every wide node but
    the root referenced once, each child's source of the matching kind."""
    bvh = _scene(tris, "lbvh").bvh
    nw, ni = bvh.num_wide, bvh.num_internal
    wc, ws = bvh.wide_child.numpy(), bvh.wide_src.numpy()
    if ni == 0:
        assert nw == 0
        return
    np.testing.assert_array_equal(np.sort(wc[wc >= nw] - nw), np.arange(bvh.num_leaves))
    np.testing.assert_array_equal(np.sort(wc[(wc >= 0) & (wc < nw)]), np.arange(1, nw))
    valid = wc >= 0
    assert ((wc[valid] >= nw) == (ws[valid] >= ni)).all()
    assert (ws[~valid] == -1).all()


def _geometries(case):
    """(terra_tpu geometry, port geometry) of one raw triangle set."""
    if case == "courtyard":
        return (tt.scenes.courtyard(**SMALL_COURTYARD).geometry,
                ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD).geometry)
    if case == "cornell":
        return tt.scenes.cornell_box().geometry, ttt.scenes.cornell_box(device="cpu").geometry
    n = int(case[6:])
    return (tt.scenes.random_triangles(n, seed=n).geometry,
            ttt.scenes.random_triangles(n, device="cpu", seed=n).geometry)


def _assert_same_tree(tb, jb):
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.leaf_size, tb.num_leaves, tb.depth, tb.num_wide, tb.wide_depth) == \
        (jb.leaf_size, jb.num_leaves, jb.depth, jb.num_wide, jb.wide_depth)


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("case,leaf", [("cornell", 4), ("random777", 8), ("random3000", 16),
                                       ("courtyard", 8)])
def test_build_matches_reference(case, leaf, builder):
    """Every array of the tree (boxes, links, leaves, threads, overlay) and
    its depths equal terra_tpu's bit for bit; so does the refit after a
    vertex move."""
    jg, tg = _geometries(case)
    jb = jlbvh.build(jg, leaf_size=leaf, builder=builder)
    tb = tlbvh.build(tg, leaf_size=leaf, builder=builder)
    _assert_same_tree(tb, jb)
    shift = np.random.default_rng(leaf).normal(0, 0.05, tg.positions.shape).astype(np.float32)
    jm = dataclasses.replace(jg, positions=jg.positions + jnp.asarray(shift))
    tm = dataclasses.replace(tg, positions=tg.positions + torch.as_tensor(shift))
    _assert_same_tree(tlbvh.refit(tb, tm), jlbvh.refit(jb, jm))


def test_native_lbvh_matches_numpy_fallback():
    """The native LBVH and the NumPy LBVH cover the same triangles with the
    same leaf count (both Morton-sorted)."""
    geom = ttt.scenes.random_triangles(777, device="cpu", seed=4).geometry
    bvh_np = tlbvh._build_numpy(geom, leaf_size=16)
    bvh_nat = tlbvh.build(geom, leaf_size=16, builder="lbvh")
    assert bvh_nat.num_leaves == bvh_np.num_leaves
    np.testing.assert_array_equal(np.sort(bvh_nat.leaf_tri.numpy().reshape(-1)),
                                  np.sort(bvh_np.leaf_tri.numpy().reshape(-1)))


def test_numpy_lbvh_matches_reference_numpy():
    """The port's NumPy LBVH equals the reference's NumPy fallback (which
    the reference takes with its native library switched off), array for
    array."""
    jg, tg = _geometries("random777")
    os.environ["TERRA_TPU_NO_NATIVE"] = "1"
    try:
        jnative._tried, jnative._lib = False, None
        jb = jlbvh.build(jg, leaf_size=16)
    finally:
        del os.environ["TERRA_TPU_NO_NATIVE"]
        jnative._tried, jnative._lib = False, None
    _assert_same_tree(tlbvh._build_numpy(tg, leaf_size=16), jb)


def test_native_sah_build_validity():
    """SAH (default): every triangle reachable, leaves at least half full,
    child boxes inside their parents, hits equal to brute force."""
    scene = _scene(777, "sah")
    bvh = scene.bvh
    t = scene.geometry.num_triangles
    assert set(np.unique(bvh.leaf_tri.numpy())) == set(range(t))
    assert bvh.num_leaves <= 2 * ((t + bvh.leaf_size - 1) // bvh.leaf_size)
    ni = bvh.num_internal
    bmin, bmax = bvh.node_min.numpy(), bvh.node_max.numpy()
    for ch in (bvh.node_left.numpy(), bvh.node_right.numpy()):
        assert (bmin[:ni] <= bmin[ch] + 1e-5).all()
        assert (bmax[:ni] >= bmax[ch] - 1e-5).all()
    o, d = _rays(1, 512)
    got = tpt.raycast(scene, torch.as_tensor(o), torch.as_tensor(d))
    ref = jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                             *(jnp.asarray(c.numpy()) for c in scene.geometry.corners()))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))


def test_unknown_builder_raises():
    geom = ttt.scenes.random_triangles(33, device="cpu", seed=1).geometry
    with pytest.raises(ValueError, match="builder"):
        tlbvh.build(geom, builder="median")


@pytest.mark.parametrize("builder", BUILDERS)
def test_native_build_failure_raises(builder):
    """A refused build raises: there is no fallback."""
    with pytest.raises(RuntimeError, match="failed"):
        getattr(tnative, f"{builder}_build")(np.zeros((3, 3), np.float32),
                                             np.zeros((0, 3), np.int32), 8)


def test_lbvh_render_matches_reference():
    """A Cornell render on a commit(bvh_builder="lbvh") tree against
    terra_tpu's on its own lbvh tree, under test_golden's twin budgets."""
    jo = tt.RenderOptions(width=16, height=16, samples_per_pixel=4, bounces=2,
                          integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5)
    to = ttt.RenderOptions(width=16, height=16, samples_per_pixel=4, bounces=2,
                           integrator=int(tt.Integrator.DIRECT), subpixel_jitter=0.5)
    jb = tt.scenes.cornell_box()
    js = tt.commit(jb.geometry, jb.materials, accelerator=tt.Accelerator.BVH, bvh_builder="lbvh")
    tb = ttt.scenes.cornell_box(device="cpu")
    ts = ttt.commit(tb.geometry, tb.materials, accelerator=ttt.Accelerator.BVH,
                    bvh_builder="lbvh")
    ref = np.asarray(tt.render(js, tt.scenes.cornell_camera(), jo, seed=2).mean())
    img = ttt.render(ts, ttt.scenes.cornell_camera(device="cpu"), to, seed=2).mean().numpy()
    _assert_twin_match(img, ref, 2e-3, 8e-3, 5e-3)


def deep_geometry(module, **kw):
    """1,700 unit right triangles in the planes x = 1.05^k: native SAH at
    leaf 8 gives binary depth 22 and BVH4 depth 21, so the BVH4 walk needs
    3 * 21 + 2 = 65 stack entries (more than a 64-entry stack holds)."""
    xs = 1.05 ** np.arange(1700)
    tris = [[(x, 0.0, 0.0), (x, 1.0, 0.0), (x, 0.0, 1.0)] for x in xs]
    return module.scenes.make_geometry(tris, np.zeros(len(tris), np.int32), **kw)


def deep_rays(n, seed):
    """Rays that start just before a random plane (x = 0.99 * 1.05^j) with
    (y, z) inside the triangles' span or, for a tenth of them, outside it,
    and head along +x or, for a fifth, back along -x. The planes are the
    450 nearest the origin, the deepest leaves of the tree: the slab test
    takes 1e12 for the inverse of a zero direction component (as the
    reference's does), so a ray along an axis misses a unit-wide box
    farther away than about 1e11."""
    r = np.random.default_rng(seed)
    j = r.integers(1, 450, n)
    yz = r.uniform(0.05, 0.45, (n, 2)) + (r.random((n, 1)) < 0.1)
    o = np.concatenate([0.99 * 1.05 ** j[:, None], yz], 1)
    d = np.zeros((n, 3))
    d[:, 0] = np.where(r.random(n) < 0.8, 1.0, -1.0)
    return o.astype(np.float32), d.astype(np.float32)


def test_deep_tree_walks_match_reference():
    """C1: the tree needs 65 stack entries in the BVH4 walk, which the
    reference's 160-entry stack holds; the port's plain binary and BVH4
    walks trace it and agree with terra_tpu's raycast on the same tree."""
    tg = deep_geometry(ttt, device="cpu")
    tb = tlbvh.build(tg, leaf_size=8)
    assert (tb.depth, tb.wide_depth) == (22, 21)
    assert 64 < 3 * tb.wide_depth + 2 <= tpt.STACK_CAP == jpt.STACK_DEPTH
    jg = deep_geometry(tt)
    js = dataclasses.replace(tt.commit(jg, tt.scenes.cornell_box().materials),
                             bvh=jlbvh.build(jg, leaf_size=8))
    ts = dataclasses.replace(ttt.commit(tg, ttt.scenes.cornell_box(device="cpu").materials),
                             bvh=tb)
    o, d = deep_rays(2048, 3)
    ref = jtraverse.raycast(js, jnp.asarray(o), jnp.asarray(d))
    assert np.asarray(ref.hit).mean() > 0.5
    c = ts.geometry.corners()
    for tables in (tpt.pack_tables(tb, *c), tpt.pack_tables_wide(tb, *c)):
        got = tpt.raycast(ts, torch.as_tensor(o), torch.as_tensor(d), tables=tables)
        _assert_match(got, ref)
