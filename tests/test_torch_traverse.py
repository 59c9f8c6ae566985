"""Port BVH traversal (plain PyTorch version of the CUDA kernel) vs the
Pallas kernel in interpret mode and vs brute force, with the budgets of
test_pallas_traverse.py: hit masks equal, t within rtol 1e-4, >= 99% of
hits on the same triangle (f32 ties on shared edges may differ)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu import intersect as jint
from terra_tpu.accel import pallas_traverse as jpt
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch import intersect as tint
from terra_tpu_torch.accel import pallas_traverse as tpt
from tests.test_torch_scene import SMALL_COURTYARD, flatten


def _rays(seed, n=2048):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _scenes(tris):
    js = tt.scenes.random_triangles(tris, seed=tris, accelerator=tt.Accelerator.BVH)
    ts = ttt.scenes.random_triangles(tris, device="cpu", seed=tris, accelerator=ttt.Accelerator.BVH)
    return js, ts


def _port(ts, o, d, t_max=None, **kw):
    """The binary-tree walk (tests/test_torch_wide.py covers the BVH4 one)."""
    tm = None if t_max is None else torch.as_tensor(t_max)
    tables = tpt.pack_tables(ts.bvh, *ts.geometry.corners())
    return tpt.raycast(ts, torch.as_tensor(o), torch.as_tensor(d), t_max=tm, tables=tables, **kw)


def _assert_match(got, ref):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-4)
    assert (got.tri.numpy()[hit] == np.asarray(ref.tri)[hit]).mean() > 0.99


@pytest.mark.parametrize("algo,tris", [("mt", 33), ("mt", 700), ("mt", 3000),
                                       ("watertight", 33), ("watertight", 3000)])
def test_plain_matches_pallas_and_brute(algo, tris):
    js, ts = _scenes(tris)
    o, d = _rays(1 if algo == "mt" else 3)
    got = _port(ts, o, d, algo=algo)
    _assert_match(got, jpt.raycast(js, jnp.asarray(o), jnp.asarray(d), interpret=True, algo=algo))
    _assert_match(got, jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                                          *js.geometry.corners(), algo=algo))
    # the port's own brute force agrees exactly with its traversal
    tb = tint.raycast_brute(torch.as_tensor(o), torch.as_tensor(d), *ts.geometry.corners(),
                            algo=algo)
    assert torch.equal(tb.hit, got.hit) and torch.equal(tb.t[tb.hit], got.t[got.hit])


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_occlusion_matches_pallas_and_brute(any_hit):
    js, ts = _scenes(700)
    o, d = _rays(11)
    t_max = np.random.default_rng(12).uniform(0.05, 3.0, (len(o),)).astype(np.float32)
    got = _port(ts, o, d, t_max=t_max, any_hit=any_hit)
    ref = jpt.raycast(js, jnp.asarray(o), jnp.asarray(d), interpret=True,
                      t_max=jnp.asarray(t_max), any_hit=any_hit)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    brute = jint.raycast_brute(jnp.asarray(o), jnp.asarray(d), *js.geometry.corners())
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(brute.t) < t_max)
    if any_hit:  # the first accepted hit collapses best t to 0
        assert (got.t.numpy()[got.hit.numpy()] == 0.0).all()


def test_single_leaf_tree():
    js, ts = _scenes(5)
    assert ts.bvh.num_internal == 0 and js.bvh.num_internal == 0
    o, d = _rays(5)
    o *= 0.2
    got = _port(ts, o, d)
    assert got.hit.any()
    _assert_match(got, jpt.raycast(js, jnp.asarray(o), jnp.asarray(d), interpret=True))
    _assert_match(got, jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                                          *js.geometry.corners()))


def _bad_inputs(case, ts):
    o, d = (torch.as_tensor(x) for x in _rays(2, 64))
    tables = tpt.pack_tables(ts.bvh, *ts.geometry.corners())
    if case == "dtype":
        return tpt.raycast, (ts, o.double(), d.double()), TypeError
    if case == "shape":
        return tpt.raycast, (ts, torch.cat([o, o[:, :1]], 1), d), ValueError
    if case == "t_max":
        return tpt.raycast, (ts, o, d, torch.ones(63)), ValueError
    if case == "device":  # the CUDA wrapper refuses CPU tensors, never falls back
        return tpt.raycast_cuda, (tables, o, d), ValueError
    assert tpt.STACK_CAP == jpt.STACK_DEPTH  # the reference's stack depth
    tables.depth = tpt.STACK_CAP
    return tpt.raycast_plain, (tables, o, d), ValueError


@pytest.mark.parametrize("case", ["dtype", "shape", "t_max", "device", "stack"])
def test_wrapper_rejects_bad_inputs(case):
    _, ts = _scenes(33)
    fn, args, exc = _bad_inputs(case, ts)
    before = tpt.launches
    with pytest.raises(exc):
        fn(*args)
    assert tpt.launches == before


@pytest.mark.parametrize("arity", [2, 4])
def test_counted_walk_marks_what_it_pops(arity):
    """The plain walks' counters and visit counts (what the card's least
    time is priced from) leave the result unchanged: every ray pops at
    least the root, leaf tests are pops, the visits add up to the pops and
    the leaf visits to the leaf tests."""
    _, ts = _scenes(700)
    o, d = (torch.as_tensor(v) for v in _rays(5))
    corners = ts.geometry.corners()
    if arity == 2:
        tables = tpt.pack_tables(ts.bvh, *corners)
        walk, n_ids, inner = tpt.raycast_plain, tables.nodes.shape[0], tables.ni
    else:
        tables = tpt.pack_tables_wide(ts.bvh, *corners, box_enc="f32")
        walk, inner = tpt.raycast4_plain, tables.num_wide
        n_ids = inner + tables.tri_id.shape[0] // tables.leaf_size
    visits = torch.zeros(n_ids, dtype=torch.int32)
    t, i, counts = walk(tables, o, d, count=True, visits=visits)
    t0, i0 = walk(tables, o, d)
    assert torch.equal(t, t0) and torch.equal(i, i0)
    assert bool((counts[:, 0] >= 1).all()) and bool((counts[:, 1] <= counts[:, 0]).all())
    assert int(visits[0]) == len(o) and 0 < int((visits[inner:] > 0).sum()) <= n_ids - inner
    assert int(visits.sum()) == int(counts[:, 0].sum())
    assert int(visits[inner:].sum()) == int(counts[:, 1].sum())


def _make(mod, case, **kw):
    """The BVH scene ``case`` from ``mod`` (terra_tpu or terra_tpu_torch)."""
    if case == "courtyard":
        return mod.scenes.courtyard(**SMALL_COURTYARD, **kw)
    if case == "cornell":
        return mod.scenes.cornell_box(accelerator=mod.Accelerator.BVH, **kw)
    return mod.scenes.random_triangles(1500, seed=4, accelerator=mod.Accelerator.BVH, **kw)


def _leaf_scenes(case, source):
    """(terra_tpu scene, port scene) of ``case``: the port's built by its
    native SAH (``source`` = "native") or carried across from terra_tpu's
    with interop."""
    js = _make(tt, case)
    if source == "native":
        return js, _make(ttt, case, device="cpu")
    return js, interop.scene_from_numpy(flatten(js), device="cpu")


LEAF_CASES = [(c, s) for c in ("courtyard", "cornell", "random") for s in ("native", "interop")]


@pytest.mark.parametrize("case,source", LEAF_CASES)
def test_leaf_padding_is_trailing_repeats(case, source):
    """What the kernels' leaf test relies on to stop early: every leaf's
    slots are distinct triangle ids followed by repeats of the last one."""
    _, ts = _leaf_scenes(case, source)
    lt = ts.bvh.leaf_tri.numpy()
    c, ls = lt.shape
    real = np.where((lt[:, 1:] == lt[:, :-1]).any(axis=1),
                    (lt[:, 1:] == lt[:, :-1]).argmax(axis=1) + 1, ls)
    prefix = np.arange(ls)[None, :] < real[:, None]
    last = lt[np.arange(c), real - 1]
    assert (lt[~prefix] == np.broadcast_to(last[:, None], lt.shape)[~prefix]).all()
    i, j = np.triu_indices(ls, k=1)
    both = prefix[:, i] & prefix[:, j]
    assert not (both & (lt[:, i] == lt[:, j])).any()
    assert (lt >= 0).all()
    tables = tpt.pack_tables(ts.bvh, *ts.geometry.corners())
    np.testing.assert_array_equal(tpt.leaf_real_counts(tables).numpy(), real)


@pytest.mark.parametrize("arity", [2, 4])
@pytest.mark.parametrize("case,source", [("courtyard", "native"), ("random", "interop")])
def test_padding_slots_change_no_result(case, source, arity):
    """A leaf's padding slots (repeats of its last triangle) can never win a
    leaf test, so the least work of a walk counts real triangles only
    (``leaf_real_counts``, which prices the kernels' bound): with every
    padding slot's corners set to NaN (a triangle no ray hits) the walk
    gives the same words, counters included, and agrees with terra_tpu's
    Pallas kernel (interpret mode)."""
    js, ts = _leaf_scenes(case, source)
    corners = ts.geometry.corners()
    tables = tpt.pack_tables(ts.bvh, *corners) if arity == 2 else \
        tpt.pack_tables_wide(ts.bvh, *corners)
    real = tpt.leaf_real_counts(tables)
    pad = torch.arange(tables.leaf_size)[None, :] >= real[:, None]
    assert bool(pad.any())  # the scene has padding
    nan = dataclasses.replace(tables, slots=tables.slots.clone())
    nan.slots.view(-1, tables.leaf_size, 10)[..., :9][pad] = float("nan")
    walk = tpt.raycast_plain if arity == 2 else tpt.raycast4_plain
    lo, hi = ts.bvh.node_min[0].numpy(), ts.bvh.node_max[0].numpy()
    o, d = _rays(31)
    o = lo + (o + 2.0) / 4.0 * (hi - lo)
    tm = np.random.default_rng(32).uniform(0.05, 5.0, len(o)).astype(np.float32)
    o, d, tm = (torch.as_tensor(x) for x in (o, d, tm))
    for t_max, any_hit in ((None, False), (tm, True)):
        full = walk(tables, o, d, t_max, any_hit, count=True)
        real_only = walk(nan, o, d, t_max, any_hit, count=True)
        for a, b in zip(full, real_only):
            assert torch.equal(a, b)
    ref = jpt.raycast(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True)
    _assert_match(tpt.raycast(ts, o, d, tables=nan), ref)


@pytest.mark.parametrize("kind", ["binary", "f32", "bf16", "paged"])
def test_slots_hold_the_corners_and_ids(kind):
    """The 40-byte slot rows hold each leaf slot's corners and its id's
    bits: the same values as the leaf-ordered corners and ``leaf_tri``."""
    _, ts = _leaf_scenes("random", "native")
    c = ts.geometry.corners()
    tab = {"binary": lambda: tpt.pack_tables(ts.bvh, *c),
           "f32": lambda: tpt.pack_tables_wide(ts.bvh, *c),
           "bf16": lambda: tpt.pack_tables_wide(ts.bvh, *c, box_enc="bf16"),
           "paged": lambda: tpt.pack_tables_paged(ts.bvh, *c, resident_cap=4)}[kind]()
    slot = ts.bvh.leaf_tri.reshape(-1).long()
    assert tab.slots.shape == (slot.shape[0], 10) and tab.slots.is_contiguous()
    assert tab.slots.dtype == torch.float32 and tab.slots.stride(0) * 4 == 40
    for k in range(3):
        assert torch.equal(tab.tris[:, 3 * k:3 * k + 3], c[k][slot])
    assert tab.tri_id.dtype == torch.int32
    assert torch.equal(tab.tri_id, slot.to(torch.int32))
