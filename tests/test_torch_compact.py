"""Port compacted two-phase traversal (accel/compact.py) and the start links
of the plain walks vs terra_tpu: the start-link walks against the Pallas
kernel in interpret mode with the traversal budgets (hit masks equal, t
within rtol 1e-4, >= 99% same triangle); the frontier, phase 1, pack_round
and merge_round exactly; raycast_compact against terra_tpu's (interpret
mode) and against the classic walk (hit masks equal, t within rtol 1e-5,
>= 99% same triangle, as tests/test_compact.py). Two reference faults are
pinned: the tail rounds' padded scatter and the silent drop after
max_rounds."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terra_tpu.accel import compact as jc
from terra_tpu.accel import pallas_traverse as jpt
from terra_tpu_torch.accel import compact as tc
from terra_tpu_torch.accel import pallas_traverse as tpt
from terra_tpu_torch.intersect import T_FAR
from terra_tpu_torch.scripts import compact_bench
from tests.test_torch_traverse import _rays
from tests.test_torch_wide import _assert_hits, _twins

twins = functools.cache(_twins)


def _start_rays(ts, fr, seed):
    """Three 1024-ray packets started at the root, at a wide-node frontier
    root and at a single-leaf frontier root. Packets 1 and 2 aim at their
    subtree's box. Returns (o, d, per-packet links, per-ray links)."""
    w = ts.bvh.num_wide
    roots = fr.roots.numpy()
    links = np.array([0, roots[(roots > 0) & (roots < w)][0], roots[roots >= w][0]], np.int32)
    o, d = _rays(seed, 3 * 1024)
    rng = np.random.default_rng(seed + 1)
    for p, link in enumerate(links[1:], start=1):
        k = int(np.nonzero(roots == link)[0][0])
        lo, hi = fr.bmin[k].numpy(), fr.bmax[k].numpy()
        aim = lo + rng.random((1024, 3), np.float32) * (hi - lo) - o[p * 1024:(p + 1) * 1024]
        d[p * 1024:(p + 1) * 1024] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return o, d, links, np.repeat(links, 1024)


@pytest.mark.parametrize("kind", ["f32", "bf16", "binary", "f32_t_max"])
def test_start_links_match_pallas(kind):
    js, ts = twins(3000, 5)
    fr = tc.build_frontier(ts.bvh, 4)  # 76 subtrees, 12 of them single leaves
    o, d, links, per_ray = _start_rays(ts, fr, 31)
    tm = None
    if kind.endswith("t_max"):
        r = np.random.default_rng(33)
        tm = np.where(r.random(len(o)) < 0.5, r.uniform(0.05, 3.0, len(o)), T_FAR)
        tm = tm.astype(np.float32)
    jcorners, tcorners = js.geometry.corners(), ts.geometry.corners()
    kw = dict(interpret=True, packet_rows=8, ways=1,
              t_max=None if tm is None else jnp.asarray(tm))
    start = torch.as_tensor(per_ray)
    if kind == "binary":
        bstart = tc.binary_starts(ts.bvh, start)
        assert bstart[0] == 0 and bstart[-1] == ts.bvh.num_internal + links[2] - ts.bvh.num_wide
        jt, ji = jpt._traverse_pallas(js.bvh, *jpt.pack_tables(js.bvh, *jcorners), jnp.asarray(o),
                                      jnp.asarray(d), arity=2, box_enc="f32",
                                      start_links=jnp.asarray(bstart.numpy()[::1024]), **kw)
        bt, bi = tpt.raycast_plain(tpt.pack_tables(ts.bvh, *tcorners), torch.as_tensor(o),
                                   torch.as_tensor(d), start=bstart)
        # the BVH4 walk from the same subtrees finds the same hits
        wt, _ = tpt.raycast4_plain(tpt.pack_tables_wide(ts.bvh, *tcorners), torch.as_tensor(o),
                                   torch.as_tensor(d), start=start)
        assert torch.equal(wt, bt)
    else:
        enc = kind[:4].rstrip("_")
        jt, ji = jpt._traverse_pallas(js.bvh, *jpt.pack_tables_wide(js.bvh, *jcorners,
                                                                    box_enc=enc),
                                      jnp.asarray(o), jnp.asarray(d), arity=4, box_enc=enc,
                                      start_links=jnp.asarray(links), **kw)
        bt, bi = tpt.raycast4_plain(tpt.pack_tables_wide(ts.bvh, *tcorners, box_enc=enc),
                                    torch.as_tensor(o), torch.as_tensor(d),
                                    None if tm is None else torch.as_tensor(tm), start=start)
    far = T_FAR if tm is None else tm
    _assert_hits(bt, bi, jt, ji, far)
    hits = (bt.numpy() < far).reshape(3, 1024).sum(axis=1)
    assert (hits > 50).all(), hits
    if tm is None:  # a subtree start finds no more than the root start would
        full = tpt.raycast4_plain(tpt.pack_tables_wide(ts.bvh, *tcorners), torch.as_tensor(o),
                                  torch.as_tensor(d))[0]
        assert (full <= bt).all() and torch.equal(full[:1024], bt[:1024])


@pytest.mark.parametrize("m", [4, 8, 16, 128])
def test_frontier_matches_reference_and_partitions(m):
    js, ts = twins(3000, 5)
    ref = jc.build_frontier(js.bvh, max_leaves=m)
    got = tc.build_frontier(ts.bvh, max_leaves=m)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.roots.dtype == torch.int32 and got.bmin.dtype == torch.float32
    # every binary leaf is reachable from exactly one frontier root
    w = ts.bvh.num_wide
    child = ts.bvh.wide_child.numpy()
    seen = np.zeros(ts.bvh.num_leaves, np.int32)
    for r in got.roots.tolist():
        stack = [r]
        while stack:
            nd = stack.pop()
            if nd >= w:
                seen[nd - w] += 1
            else:
                stack.extend(int(c) for c in child[nd] if c >= 0)
    assert (seen == 1).all()
    assert bool((got.roots >= w).any()) == (m == 4)  # leaves above the cut are roots


def _ray_batch(n, seed):
    o, d = _rays(seed, n)
    return o, d, torch.as_tensor(o), torch.as_tensor(d)


def test_phase1_ranks_match_reference():
    js, ts = twins(3000, 5)
    jf, tf = jc.build_frontier(js.bvh, 16), tc.build_frontier(ts.bvh, 16)
    o, d, to, td = _ray_batch(1500, 41)
    ref = jc.first_ranks(jf, jnp.asarray(o), jnp.asarray(d), 2, block=512)
    got = tc.first_ranks(tf, to, td, 2, block=512)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    k2, f2 = got[2], got[3]
    assert (f2 >= 0).any() and (f2 < 0).any()
    ref = jc.next_rank(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(k2.numpy()),
                       jnp.asarray(f2.numpy()), block=512)
    got = tc.next_rank(tf, to, td, k2, f2, block=512)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_entry_key_of_negative_zero_matches_xla():
    """A ray starting on a frontier box's max-x plane and heading to -x has
    entry t = -0.0. XLA's CPU ``maximum(-0.0, 0.0)`` is +0.0, so the key is
    0; a sign-bit key (0x80000000) would sort below every rank bound and
    lose the pair."""
    js, ts = twins(3000, 5)
    jf, tf = jc.build_frontier(js.bvh, 16), tc.build_frontier(ts.bvh, 16)
    lo, hi = tf.bmin[3].numpy(), tf.bmax[3].numpy()
    o = np.array([[hi[0], (lo[1] + hi[1]) / 2, (lo[2] + hi[2]) / 2]], np.float32)
    d = np.array([[-0.9, 0.3, 0.3]], np.float32)
    ref = np.asarray(jc._entry_keys(jf, jnp.asarray(o), jnp.asarray(d)))
    got = tc._entry_keys(tf, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    assert ref[0, 3] == 0 and got[0, 3] == 0
    np.testing.assert_array_equal(got, ref)


def _pack_inputs(seed, n_all=900, n=700, rowsz=16):
    """A tail-round-like pack: ``n`` of ``n_all`` rays, about 70% of the
    pairs valid."""
    js, ts = twins(3000, 5)
    tf = tc.build_frontier(ts.bvh, 16)
    f = int(tf.roots.shape[0])
    r = np.random.default_rng(seed)
    rid = np.sort(r.choice(n_all, n, replace=False)).astype(np.int32)
    fid = r.integers(0, f, n).astype(np.int32)
    valid = r.random(n) < 0.7
    o, d = _rays(seed, n_all)
    best_t = r.uniform(0.5, 5.0, n_all).astype(np.float32)
    cap = (-(-n // rowsz) + f) * rowsz
    return (rid, fid, valid, o, d, best_t, tf.roots.numpy()), f, cap, rowsz


def test_pack_round_matches_reference():
    args, f, cap, rowsz = _pack_inputs(51)
    ref = jc.pack_round(*(jnp.asarray(a) for a in args), f, cap, rowsz)
    got = tc.pack_round(*(torch.as_tensor(a) for a in args), f, cap, rowsz)
    names = ("o_p", "d_p", "seed_p", "rid_p", "live", "starts")
    for name, a, b in zip(names, got, ref):
        b = np.asarray(b)
        if name == "rid_p":  # the reference's dump lane keeps some invalid pair's ray
            a, b = a[:-1], b[:-1]
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    live = got[4]
    assert int(live.sum()) == int(args[2].sum()) and not live[-1]


def test_merge_round_matches_reference():
    args, f, cap, rowsz = _pack_inputs(61)
    o_p, d_p, seed_p, rid_p, live, starts = tc.pack_round(*(torch.as_tensor(a) for a in args),
                                                          f, cap, rowsz)
    r = np.random.default_rng(62)
    best_t = torch.as_tensor(args[5])
    best_i = torch.as_tensor(r.integers(0, 3000, best_t.shape[0]).astype(np.int32))
    # lanes of one ray more than once, with equal t, to exercise the ties
    rid_p = rid_p.clone()
    rid_p[1::7] = rid_p[0::7][: rid_p[1::7].shape[0]]
    t_ret = torch.as_tensor(r.uniform(0.0, 6.0, cap).astype(np.float32))
    t_ret[1::7] = t_ret[0::7][: t_ret[1::7].shape[0]]
    i_ret = torch.as_tensor(r.integers(0, 3000, cap).astype(np.int32))
    ins = (best_t, best_i, rid_p, live, seed_p, t_ret, i_ret)
    ref = jc.merge_round(*(jnp.asarray(x.numpy()) for x in ins))
    got = tc.merge_round(*ins)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[0] < best_t).any() and (got[1] != best_i).any()


def _classic(tables, to, td):
    t, i = tpt.raycast4_plain(tables, to, td)
    return t, torch.where(t < T_FAR, i, 0)


def _assert_compact(got, ref_t, ref_i, rtol=1e-5):
    hit = ref_t < T_FAR
    assert torch.equal(got.hit, hit)
    np.testing.assert_allclose(got.t[hit].numpy(), ref_t[hit].numpy(), rtol=rtol)
    assert (got.tri[hit] == ref_i[hit]).float().mean() > 0.99
    assert hit.any() and not hit.all()


def test_raycast_compact_matches_reference_and_classic():
    """tests/test_compact.py's case (3000 triangles, 2048 rays, M = 16). The
    reference runs with one 1024-lane row per packet and one tail bucket
    (TPU knobs that change no result) to bound its interpret-mode compiles;
    the port runs with the same rows of 1024 lanes and with 128."""
    js, ts = twins(3000, 5)
    r = np.random.default_rng(3)
    o = r.uniform(-2, 2, (2048, 3)).astype(np.float32)
    d = r.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jf, tf = jc.build_frontier(js.bvh, 16), tc.build_frontier(ts.bvh, 16)
    packed = jpt.pack_tables_wide(js.bvh, *js.geometry.corners(), box_enc="f32")
    ref = jc.raycast_compact(js.bvh, packed, jf, jnp.asarray(o), jnp.asarray(d), rows_pp=8,
                             ways=1, rowsz=1024, interpret=True, tail_buckets=(1,))
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    classic = _classic(tables, to, td)
    jax_ref = torch.tensor(np.array(ref.t)), torch.tensor(np.array(ref.tri))
    for rowsz in (1024, 128):
        stats = {}
        got = tc.raycast_compact(ts.bvh, tables, tf, to, td, rowsz=rowsz, stats=stats)
        assert stats["rounds"] > 3
        _assert_compact(got, *jax_ref)
        _assert_compact(got, *classic)
        assert got.t.grad_fn is None and not got.t.requires_grad


@pytest.mark.parametrize("enc", ["f32", "bf16"])
def test_raycast_compact_matches_classic(enc):
    js, ts = twins(1500, 15)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners(), box_enc=enc)
    _, _, to, td = _ray_batch(3000, 71)
    fr = tc.build_frontier(ts.bvh, 8)
    got = tc.raycast_compact(ts.bvh, tables, fr, to, td, block=1024)
    _assert_compact(got, *_classic(tables, to, td))


def test_tail_rounds_advance_ray_zero():
    """Ray 0 needs tail rounds while most rays have finished. The reference
    pads the active set with ray 0 and scatters its next rank through the
    padding, so ray 0 may stall; the port scatters through the active rays
    only and matches the classic walk on ray 0 and everywhere."""
    _, ts = twins(3000, 5)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    fr = tc.build_frontier(ts.bvh, 4)
    _, _, to, td = _ray_batch(600, 81)
    ref_t, ref_i = _classic(tables, to, td)
    # pairs entered before the closest hit: the ray with the most goes first
    keys = tc._entry_keys(fr, to, td)
    before = ((keys != tc.KEY_INF) & (keys.view(torch.float32) < ref_t[:, None])).sum(1)
    first = int(torch.argmax(torch.where(ref_t < T_FAR, before, 0)))
    perm = torch.cat([torch.tensor([first]), torch.arange(600)[torch.arange(600) != first]])
    to, td, ref_t, ref_i = to[perm], td[perm], ref_t[perm], ref_i[perm]
    assert before[first] >= 5  # ranks 3 and on come in tail rounds
    stats = {}
    got = tc.raycast_compact(ts.bvh, tables, fr, to, td, stats=stats)
    assert stats["rounds"] >= int(before[first]) and stats["active"][-1] < 60
    assert got.hit[0] and got.t[0] == ref_t[0] and got.tri[0] == ref_i[0]
    _assert_compact(got, ref_t, ref_i)


def test_exhausted_rounds_raise():
    _, ts = twins(3000, 5)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    _, _, to, td = _ray_batch(512, 91)
    with pytest.raises(RuntimeError, match=r"\d+ rays still have pairs to walk after 2 rounds"):
        tc.raycast_compact(ts.bvh, tables, tc.build_frontier(ts.bvh, 4), to, td, max_rounds=2)


def _bad(case):
    _, ts = twins(700, 3)
    c = ts.geometry.corners()
    fr = tc.build_frontier(ts.bvh, 8)
    _, _, o, d = _ray_batch(64, 2)
    wide = tpt.pack_tables_wide(ts.bvh, *c)
    top = ts.bvh.num_wide + ts.bvh.num_leaves
    if case == "paged":
        return lambda: tc.raycast_compact(ts.bvh, tpt.pack_tables_paged(ts.bvh, *c), fr, o, d)
    if case == "binary":
        return lambda: tc.raycast_compact(ts.bvh, tpt.pack_tables(ts.bvh, *c), fr, o, d)
    if case == "start_range4":
        return lambda: tpt.traverse_packed(wide, o, d, start=torch.full((64,), top).int())
    if case == "start_range2":
        binary = tpt.pack_tables(ts.bvh, *c)
        return lambda: tpt.traverse_packed(binary, o, d, start=torch.full((64,), -1).int())
    if case == "start_dtype":
        return lambda: tpt.traverse_packed(wide, o, d, start=torch.zeros(64, dtype=torch.int64))
    return lambda: tpt.raycast4_cuda(wide, o, d, start=torch.zeros(64, dtype=torch.int32))


@pytest.mark.parametrize("case", ["paged", "binary", "start_range4", "start_range2",
                                  "start_dtype", "start_device"])
def test_compact_and_start_links_reject_bad_inputs(case):
    fn = _bad(case)
    before = tpt.launches4
    with pytest.raises(ValueError):
        fn()
    assert tpt.launches4 == before


def test_compact_bench_runs_on_plain_walks():
    out = compact_bench.main(["--grid", "12", "--rays", "2048", "--M", "32", "--device", "cpu"])
    row = out["M"][32]
    assert out["device"] == "cpu" and out["rays"] == 2048
    assert row["hit_mismatch"] == 0 and row["t_mismatch"] == 0 and row["same_tri"] >= 0.99
    assert row["rounds"] >= 2 and row["F"] > 1 and row["launches"] == 0
