"""Port ray-sort keys (accel/traverse.py) vs terra_tpu.accel.traverse bit for
bit, and the sorted traversal and render of the port against its unsorted
walk word for word (sorting changes the order rays are walked in, never a
ray's result). JAX scenes are carried across with interop, so both sides
key on one tree."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu.accel import traverse as jtr
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch.accel import pallas_traverse as tpt
from terra_tpu_torch.accel import traverse as ttr
from tests.test_torch_scene import SMALL_COURTYARD, flatten

N = 4096


@functools.cache
def _twins(name):
    if name == "random3000":
        js = tt.scenes.random_triangles(3000, seed=3, accelerator=tt.Accelerator.BVH)
    else:
        js = tt.scenes.courtyard(**SMALL_COURTYARD, accelerator=tt.Accelerator.BVH)
    return js, interop.scene_from_numpy(flatten(js), device="cpu")


def _rays(js, seed, n=N):
    """Origins over the root box and a margin around it, unit directions,
    and parent-hit triangle hints with -1 for about a quarter of the rays."""
    r = np.random.default_rng(seed)
    lo, hi = np.asarray(js.bvh.node_min[0]), np.asarray(js.bvh.node_max[0])
    o = (lo - 1 + r.random((n, 3)) * (hi - lo + 2)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hint = r.integers(0, js.geometry.tri_vidx.shape[0], n).astype(np.int32)
    hint[r.random(n) < 0.25] = -1
    return o, d, hint


KEYS = ["morton", "octant", "dir2", "dir3", "treelet", "hinted"]


@pytest.mark.parametrize("kind", KEYS)
@pytest.mark.parametrize("scene", ["random3000", "courtyard"])
def test_keys_match_reference(scene, kind):
    js, ts = _twins(scene)
    o, d, hint = _rays(js, 1)
    if kind == "morton":  # values past both ends of [0, 2^7) clamp
        x = np.random.default_rng(2).uniform(-20, 150, (N, 3)).astype(np.float32)
        ref = jtr._morton3_bits(jnp.asarray(x), 7)
        got = ttr._morton3_bits(torch.as_tensor(x), 7)
    elif kind == "hinted":
        table = jtr.leaf_of_tri_table(js.bvh)
        ref = jtr.hinted_keys(table, jnp.asarray(hint), jnp.asarray(d))
        got = ttr.hinted_keys(ttr.leaf_of_tri_table(ts.bvh), torch.as_tensor(hint),
                              torch.as_tensor(d))
    else:
        ref = jtr._sort_keys(jnp.asarray(o), jnp.asarray(d), js.bvh.node_min[0],
                             js.bvh.node_max[0], mode=kind, bvh=js.bvh)
        got = ttr._sort_keys(torch.as_tensor(o), torch.as_tensor(d), ts.bvh.node_min[0],
                             ts.bvh.node_max[0], mode=kind, bvh=ts.bvh)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    if kind in ("treelet", "dir3"):  # the high bits are in use
        assert got.max() >= 1 << 29


@pytest.mark.parametrize("scene", ["random3000", "courtyard"])
def test_leaf_of_tri_table(scene):
    js, ts = _twins(scene)
    table = ttr.leaf_of_tri_table(ts.bvh)
    leaf_tri = ts.bvh.leaf_tri.numpy()
    t = ts.geometry.num_triangles
    assert table.dtype == torch.int32 and table.shape == (t,)
    tab = table.numpy()
    assert (leaf_tri[tab] == np.arange(t)[:, None]).any(axis=1).all()  # its leaf holds it
    slots = np.bincount(leaf_tri.reshape(-1), minlength=t)
    single = slots == 1
    assert single.mean() > 0.5
    np.testing.assert_array_equal(tab[single], np.asarray(jtr.leaf_of_tri_table(js.bvh))[single])


@pytest.mark.parametrize("mode", ["octant", "dir2", "dir3", "treelet", "hinted", "occlusion"])
@pytest.mark.parametrize("kind", ["binary", "f32"])
def test_sorted_raycast_equals_unsorted(kind, mode):
    js, ts = _twins("random3000")
    o, d, hint = (torch.as_tensor(x) for x in _rays(js, 5, 2048))
    c = ts.geometry.corners()
    tables = tpt.pack_tables(ts.bvh, *c) if kind == "binary" else tpt.pack_tables_wide(ts.bvh, *c)
    kw = dict(tables=tables)
    if mode == "hinted":
        kw.update(sort_hint=hint, leaf_of_tri=ttr.leaf_of_tri_table(ts.bvh))
    elif mode == "occlusion":
        kw.update(t_max=torch.as_tensor(np.random.default_rng(6).uniform(0.05, 3.0, 2048)
                                        .astype(np.float32)), any_hit=True)
    else:
        kw.update(sort_mode=mode)
    order = ttr.sort_order(ts.bvh, o, d, kw.get("sort_mode", "octant"), kw.get("sort_hint"),
                           kw.get("leaf_of_tri"))
    assert not torch.equal(order, torch.arange(2048))  # the walk order does change
    got = tpt.raycast(ts, o, d, **kw)
    ref = tpt.raycast(ts, o, d, sort_rays=False, **kw)
    for f in ("t", "tri", "hit"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
    assert got.hit.any() and not got.hit.all()


def test_small_batches_are_not_sorted(monkeypatch):
    _, ts = _twins("random3000")
    o, d = torch.zeros((tpt.PACKET, 3)), torch.ones((tpt.PACKET, 3)) / 3 ** 0.5
    calls = []
    monkeypatch.setattr(tpt, "sort_order", lambda *a: calls.append(a))
    tpt.raycast(ts, o, d)
    assert calls == []


def test_render_sorted_equals_unsorted(monkeypatch):
    """The render sorts every raycast by parent-hit keys; the image is the
    unsorted render's bit for bit."""
    scene = ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD)
    cam = ttt.scenes.courtyard_camera(device="cpu")
    opts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=2, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    hinted = []
    real_order = tpt.sort_order

    def spy(bvh, o, d, mode, hint, table):
        hinted.append(hint is not None and table is not None)
        return real_order(bvh, o, d, mode, hint, table)

    monkeypatch.setattr(tpt, "sort_order", spy)
    sorted_img = ttt.render(scene, cam, opts, seed=4).acc
    assert hinted and all(hinted)  # bounce and shadow rays carry the parent hit
    real_raycast = tpt.raycast
    monkeypatch.setattr(tpt, "raycast", functools.partial(real_raycast, sort_rays=False))
    calls = len(hinted)
    plain_img = ttt.render(scene, cam, opts, seed=4).acc
    assert len(hinted) == calls
    assert torch.equal(sorted_img, plain_img) and sorted_img.sum() > 0
