"""The compacted traversal's units (``accel/compact.py``: ``raycast_compact``
as a head unit (phase 1, rounds 0 and 1) and one tail unit per bucket over
a run's static buffers, with the reference's ``tail_buckets``; a stage
whose rank sweep exceeds ``GRAPH_SWEEP`` entries op by op at its exact
size) on the CPU, where each unit's body runs eagerly through the code the
card captures:

  * ``_bucket`` equals ``terra_tpu.accel.compact._bucket``;
  * ``raycast_compact`` with tail buckets (1,) and (1, 8, 64) against
    terra_tpu's in interpret mode (hit masks equal, t within rtol 1e-5,
    >= 99% same triangle, as tests/test_torch_compact.py) and against the
    classic walk, and word for word against ``raycast_compact_eager``;
  * the ray-0 and exhausted-round cases under buckets;
  * stages above ``GRAPH_SWEEP`` at their exact sizes, units below it;
  * ``pack_round`` (group counts by ``searchsorted``) word for word
    against the reference's, edge cases included;
  * the run cache: a later call makes no unit, another frontier or a
    table written in place makes a new run, a dead BVH drops its runs;
  * a frontier root beyond the tables raises when its run is made.
"""
import functools
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terra_tpu.accel import compact as jc
from terra_tpu.accel import pallas_traverse as jpt
from terra_tpu_torch import graphs
from terra_tpu_torch.accel import compact as tc
from terra_tpu_torch.accel import pallas_traverse as tpt
from tests.test_torch_compact import _assert_compact, _classic, _pack_inputs, _ray_batch
from tests.test_torch_wide import _twins

twins = functools.cache(_twins)
BUCKETS = [(1,), (1, 8, 64)]


def _same_words(a, b):
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    assert torch.equal(a.tri, b.tri) and torch.equal(a.hit, b.hit)


@pytest.mark.parametrize("divs", [(1,), (1, 8, 64), (1, 4), (2, 16, 128)])
def test_bucket_matches_reference(divs):
    for n in (1, 7, 600, 2048, 3000, 1 << 20):
        for blk in (1, 128, 1024):
            sizes = {1, 2, n // 128, n // 64, n // 64 + 1, n // 8, n // 8 + 1, n // 2, n - 1, n}
            for size in sorted(s for s in sizes if 1 <= s <= n):
                got = tc._bucket(size, n, divs, blk)
                assert got == jc._bucket(size, n, divs, blk), (size, n, blk)
                assert got >= size and got % blk == 0


@functools.cache
def _reference_case():
    """tests/test_compact.py's case (3000 triangles, 2048 rays, M = 16) with
    ray 0 aimed away from the scene, so it has no pair and never enters a
    tail round: the reference's padding (ray 0) then scatters only ray 0's
    own unchanged rank, and its fault cannot fire. The reference runs as
    test_torch_compact.py runs it (rows of 1024 lanes, one tail bucket)."""
    js, ts = twins(3000, 5)
    r = np.random.default_rng(3)
    o = r.uniform(-2, 2, (2048, 3)).astype(np.float32)
    d = r.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0], d[0] = 10.0, np.float32(0.5773503)
    jf, tf = jc.build_frontier(js.bvh, 16), tc.build_frontier(ts.bvh, 16)
    packed = jpt.pack_tables_wide(js.bvh, *js.geometry.corners(), box_enc="f32")
    ref = jc.raycast_compact(js.bvh, packed, jf, jnp.asarray(o), jnp.asarray(d), rows_pp=8,
                             ways=1, rowsz=1024, interpret=True, tail_buckets=(1,))
    ref = torch.tensor(np.array(ref.t)), torch.tensor(np.array(ref.tri))
    return ts, tf, torch.as_tensor(o), torch.as_tensor(d), ref


@pytest.mark.parametrize("rowsz", [128, 1024])
@pytest.mark.parametrize("buckets", BUCKETS)
def test_units_match_reference_eager_and_classic(buckets, rowsz):
    ts, tf, to, td, ref = _reference_case()
    assert int(tc.first_ranks(tf, to[:1], td[:1])[1][0]) == -1  # ray 0 has no pair
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    stats, eager_stats = {}, {}
    got = tc.raycast_compact(ts.bvh, tables, tf, to, td, rowsz=rowsz, tail_buckets=buckets,
                             stats=stats)
    eager = tc.raycast_compact_eager(ts.bvh, tables, tf, to, td, rowsz=rowsz,
                                     stats=eager_stats)
    _same_words(got, eager)
    assert stats["rounds"] == eager_stats["rounds"] > 3
    assert stats["active"] == eager_stats["active"]
    assert stats["buckets"] == [tc._bucket(a, 2048, buckets, rowsz) for a in stats["active"]]
    assert stats["replays"] == stats["rounds"] - 1  # the head, then one a tail round
    assert sorted(stats["units"]) == sorted(
        ["head"] + [f"tail/{b}" for b in set(stats["buckets"])])
    _assert_compact(got, *ref)
    _assert_compact(got, *_classic(tables, to, td))
    assert got.t.grad_fn is None and not got.t.requires_grad


def _ray_zero_case():
    """test_torch_compact.py::test_tail_rounds_advance_ray_zero's rays: ray
    0 is the one with the most pairs entered before its closest hit."""
    _, ts = twins(3000, 5)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    fr = tc.build_frontier(ts.bvh, 4)
    _, _, to, td = _ray_batch(600, 81)
    ref_t, ref_i = _classic(tables, to, td)
    keys = tc._entry_keys(fr, to, td)
    before = ((keys != tc.KEY_INF) & (keys.view(torch.float32) < ref_t[:, None])).sum(1)
    first = int(torch.argmax(torch.where(ref_t < tc.T_FAR, before, 0)))
    perm = torch.cat([torch.tensor([first]), torch.arange(600)[torch.arange(600) != first]])
    return ts, tables, fr, to[perm], td[perm], ref_t[perm], ref_i[perm], int(before[first])


@pytest.mark.parametrize("buckets", BUCKETS)
def test_tail_rounds_advance_ray_zero_under_buckets(buckets):
    """Ray 0 stays active through tail rounds padded beyond the active set:
    the padding lanes carry the dump row's id, never ray 0, so ray 0's
    rank advances and its hit is the classic walk's."""
    ts, tables, fr, to, td, ref_t, ref_i, need = _ray_zero_case()
    assert need >= 5  # ranks 3 and on come in tail rounds
    stats = {}
    got = tc.raycast_compact(ts.bvh, tables, fr, to, td, tail_buckets=buckets, stats=stats)
    assert stats["rounds"] >= need and stats["active"][-1] < 60
    assert stats["buckets"][-1] > stats["active"][-1]  # the last rounds ran padded
    assert got.hit[0] and got.t[0] == ref_t[0] and got.tri[0] == ref_i[0]
    _assert_compact(got, ref_t, ref_i)
    _same_words(got, tc.raycast_compact_eager(ts.bvh, tables, fr, to, td))


@pytest.mark.parametrize("buckets", BUCKETS)
def test_exhausted_rounds_raise_under_buckets(buckets):
    _, ts = twins(3000, 5)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    _, _, to, td = _ray_batch(512, 91)
    fr = tc.build_frontier(ts.bvh, 4)
    for rounds in (2, 3):
        with pytest.raises(RuntimeError,
                           match=rf"\d+ rays still have pairs to walk after {rounds} rounds"):
            tc.raycast_compact(ts.bvh, tables, fr, to, td, max_rounds=rounds,
                               tail_buckets=buckets)
    # the run's buffers are whole again for the next call
    _same_words(tc.raycast_compact(ts.bvh, tables, fr, to, td, tail_buckets=buckets),
                tc.raycast_compact_eager(ts.bvh, tables, fr, to, td))


@pytest.mark.parametrize("sweep", ["head_exact", "mixed", "all_exact"])
def test_device_bound_stages_run_at_exact_size(sweep, monkeypatch):
    """A stage whose rank sweep (lanes x F) exceeds ``GRAPH_SWEEP`` runs op
    by op at its exact size, one below it replays its unit at its bucket;
    the words are the same either way."""
    ts, tables, fr, to, td, ref_t, ref_i, _ = _ray_zero_case()
    n, f = to.shape[0], int(fr.roots.shape[0])
    eager_stats = {}
    eager = tc.raycast_compact_eager(ts.bvh, tables, fr, to, td, stats=eager_stats)
    active = eager_stats["active"]
    limit = {"head_exact": (n - 1) * f, "mixed": 128 * f, "all_exact": 0}[sweep]
    monkeypatch.setattr(tc, "GRAPH_SWEEP", limit)
    graphs.clear()
    stats = {}
    got = tc.raycast_compact(ts.bvh, tables, fr, to, td, tail_buckets=(1, 8, 64), stats=stats)
    graphs.clear()
    _same_words(got, eager)
    assert stats["active"] == active and ("head" in stats["units"]) == (n * f <= limit)
    for a, lanes in zip(active, stats["buckets"]):
        b = tc._bucket(a, n, (1, 8, 64), 128)
        assert lanes == (b if b * f <= limit else a)
        assert (f"tail/{b}" in stats["units"]) == (b * f <= limit)
    if sweep == "mixed":
        assert stats["buckets"][0] == active[0] and stats["buckets"][-1] > active[-1]
    assert stats["replays"] == int(n * f <= limit) + sum(
        tc._bucket(a, n, (1, 8, 64), 128) * f <= limit for a in active)
    _assert_compact(got, ref_t, ref_i)


@pytest.mark.parametrize("case", ["tail", "none_valid", "all_valid", "one_group", "tiny_rows"])
def test_pack_round_counts_match_reference(case):
    """Group counts and first lanes from ``searchsorted`` on the sorted
    subtree ids give the reference's layout word for word (its dump lane's
    ray id aside)."""
    args, f, cap, rowsz = _pack_inputs(71 if case == "tail" else 72)
    rid, fid, valid, o, d, best_t, roots = args
    if case == "none_valid":
        valid = np.zeros_like(valid)
    elif case == "all_valid":
        valid = np.ones_like(valid)
    elif case == "one_group":
        fid = np.full_like(fid, f // 2)
    elif case == "tiny_rows":
        rowsz = 1
        cap = (len(rid) + f) * rowsz
    args = (rid, fid, valid, o, d, best_t, roots)
    ref = jc.pack_round(*(jnp.asarray(a) for a in args), f, cap, rowsz)
    got = tc.pack_round(*(torch.as_tensor(a) for a in args), f, cap, rowsz)
    for name, a, b in zip(("o_p", "d_p", "seed_p", "rid_p", "live", "starts"), got, ref):
        b = np.asarray(b)
        if name == "rid_p":
            a, b = a[:-1], b[:-1]
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert int(got[4].sum()) == int(valid.sum())


def test_run_cache():
    """One run per (BVH, tables, frontier, rays, options): a later call
    makes no unit and gives the same words; another frontier, tables
    written in place or another ray count make a run of their own; a dead
    BVH takes its runs with it."""
    _, ts = twins(1500, 15)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    _, _, to, td = _ray_batch(1000, 73)
    fr = tc.build_frontier(ts.bvh, 8)
    graphs.clear()
    first, again = {}, {}
    a = tc.raycast_compact(ts.bvh, tables, fr, to, td, block=256, stats=first)
    b = tc.raycast_compact(ts.bvh, tables, fr, to, td, block=256, stats=again)
    _same_words(a, b)
    assert first["captures"] == len(first["units"]) >= 2 and again["captures"] == 0
    assert again["units"] is first["units"] and len(graphs._COMPACT_RUNS) == 1
    tc.raycast_compact(ts.bvh, tables, tc.build_frontier(ts.bvh, 16), to, td, block=256)
    tc.raycast_compact(ts.bvh, tables, fr, to[:500], td[:500], block=256)
    assert len(graphs._COMPACT_RUNS) == 3
    tables.slots.add_(0.0)  # written in place: the graphs would read stale tables
    third = {}
    _same_words(tc.raycast_compact(ts.bvh, tables, fr, to, td, block=256, stats=third), a)
    assert third["captures"] >= 2 and graphs.units() == []  # no captured unit on the CPU
    _, other = _twins(700, 3)
    tc.raycast_compact(other.bvh, tpt.pack_tables_wide(other.bvh, *other.geometry.corners()),
                       tc.build_frontier(other.bvh, 8), to, td)
    assert len(graphs._COMPACT_RUNS) == graphs.MAX_COMPACT_RUNS
    del other
    gc.collect()
    assert len(graphs._COMPACT_RUNS) == graphs.MAX_COMPACT_RUNS - 1
    graphs.clear()
    assert len(graphs._COMPACT_RUNS) == 0


def test_frontier_roots_are_checked_once_per_run():
    """The units launch with start links built from the frontier's roots
    and skip the per-launch range check (it reads back to the host), so a
    run checks the roots when it is made: a root beyond the tables' nodes
    raises before any walk."""
    _, ts = twins(700, 3)
    tables = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners())
    fr = tc.build_frontier(ts.bvh, 8)
    _, _, to, td = _ray_batch(64, 5)
    top = ts.bvh.num_wide + ts.bvh.num_leaves
    for roots in (fr.roots.clone().fill_(top), fr.roots - fr.roots.max() - 1):
        with pytest.raises(ValueError, match="frontier roots span"):
            tc.raycast_compact(ts.bvh, tables, fr._replace(roots=roots), to, td)
