"""Port BVH traversal (plain PyTorch version of the CUDA kernel) vs the
Pallas kernel in interpret mode and vs brute force, with the budgets of
test_pallas_traverse.py: hit masks equal, t within rtol 1e-4, >= 99% of
hits on the same triangle (f32 ties on shared edges may differ)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu import intersect as jint
from terra_tpu.accel import pallas_traverse as jpt
import terra_tpu_torch as ttt
from terra_tpu_torch import intersect as tint
from terra_tpu_torch.accel import pallas_traverse as tpt


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
    """The plain walks' counters and touched-node marks (what the card's
    least time is priced from) leave the result unchanged: every ray pops
    at least the root, leaf tests are pops, and the touched ids are the
    root plus nodes below it."""
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
    touched = torch.zeros(n_ids, dtype=torch.bool)
    t, i, counts = walk(tables, o, d, count=True, touched=touched)
    t0, i0 = walk(tables, o, d)
    assert torch.equal(t, t0) and torch.equal(i, i0)
    assert bool((counts[:, 0] >= 1).all()) and bool((counts[:, 1] <= counts[:, 0]).all())
    assert bool(touched[0]) and 0 < int(touched[inner:].sum()) <= n_ids - inner
    assert int(counts[:, 1].sum()) >= int(touched[inner:].sum())
