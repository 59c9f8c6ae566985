"""Compacted two-phase traversal: port of ``terra_tpu/accel/compact.py``.

The reference cut the SIMD packet dilation of its 1024-lane TPU kernel:

  1. The BVH4 overlay is cut into subtrees of at most ``max_leaves``
     leaves (the frontier, :func:`build_frontier`).
  2. Phase 1 slab-tests every ray against the F frontier boxes and
     extracts each ray's (subtree, entry) pairs in entry order by repeated
     lexicographic (entry key, subtree id) min passes (:func:`first_ranks`,
     :func:`next_rank`).
  3. Phase 2 runs the pairs in entry-ranked rounds: each round's pairs are
     grouped by subtree, padded per subtree to ``rowsz``-lane rows
     (:func:`pack_round`), and walked by the traversal kernel with each
     ray's stack started at its subtree's root (start links) and its best t
     seeded with the ray's best so far (``t_max``).
  4. A scatter-min merge folds each round into the per-ray (t, tri)
     (:func:`merge_round`); rounds repeat until no ray has a pair left
     whose entry is below its best hit. A pair is dropped only when its
     box entry is at or beyond the ray's proven best, so the result is the
     closest hit, as the classic walk finds it.

On the H100 the kernel walks one ray per thread, so there is no packet to
dilate; the port keeps the path for what it computes, holds it to the
classic traversal, and measures whether it pays (PERF.md). Phase 1 and the
pack and merge steps are plain torch ops on ``(block, F)`` tiles, as they
were plain XLA in the reference; the kernel launch goes through
``pallas_traverse.traverse_packed``, so CPU tensors take the plain walk and
CUDA tensors the CUDA kernel.

As the reference fuses each round's device work into a jitted segment
cached per shape, :func:`raycast_compact` runs its dispatch-bound stages
(phase 1 with the first two rounds, and the tail rounds, each padded to one
of a few bucket sizes so a few captures serve every round) as units: CUDA
graphs on the card, captured once per shape and replayed. Its device-bound
stages, whose rank sweeps a graph would not shorten and a bucket would
pad, run op by op at their exact sizes. The host reads only the active
count between rounds. :func:`raycast_compact_eager` is the same walk with
every stage op by op.

Two faults of the reference are not carried over: its tail rounds pad the
active set with ray 0 and scatter through the padded indices, so ray 0's
rank may not advance; and rays still active after ``max_rounds`` are
dropped without notice. Here the padding lanes carry the id of a dump row
that no read takes unmasked, and an exhausted round budget raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..intersect import RayHit, T_FAR
from . import pallas_traverse as pt

__all__ = ["Frontier", "build_frontier", "binary_starts", "first_ranks", "next_rank",
           "pack_round", "merge_round", "raycast_compact", "raycast_compact_eager", "KEY_INF",
           "TRI_BIG", "GRAPH_SWEEP"]

TRI_BIG = 1 << 24
KEY_INF = 0x7F800000  # +inf bit pattern: the top of the sortable-int keys
_FID_BIG = 1 << 30
_PAD_O = 1e8          # origin and direction of the lanes that carry no pair
_PAD_D = 0.5773503
# A stage replays a captured unit only where host dispatch, not the device,
# bounds it: where its rank sweep spans at most this many (ray, subtree)
# entries. On an H100 a tail round dispatched op by op takes 2.3-4.6 ms at
# any small size, and a replayed one ~0.6 ms plus ~0.11 ns an entry, so a
# unit wins up to ~16 M entries; above that a graph saves nothing and a
# bucket's padding adds to the sweep (scripts/compact_bench.py's per-stage
# times; PERF.md).
GRAPH_SWEEP = 1 << 23


class Frontier(NamedTuple):
    """Subtree cut of the BVH4 overlay (built on the host once per scene)."""
    roots: torch.Tensor  # (F,) i32 start links: wide id, or W + leaf id
    bmin: torch.Tensor   # (F, 3) f32 subtree bounds
    bmax: torch.Tensor   # (F, 3)


def build_frontier(bvh, max_leaves: int = 128) -> Frontier:
    """Maximal wide-tree subtrees with at most ``max_leaves`` binary
    leaves, in the reference's order. A leaf hanging above the cut becomes
    its own subtree (its start link is the stack's leaf encoding). Tensors
    land on the BVH's device."""
    w = int(bvh.num_wide)
    ni = int(bvh.num_internal)
    child = bvh.wide_child.cpu().numpy()
    src = bvh.wide_src.cpu().numpy()
    nmin = bvh.node_min.cpu().numpy()
    nmax = bvh.node_max.cpu().numpy()
    kids = child.tolist()

    # post-order leaf counts
    order, stack = [], [0]
    while stack:
        n = stack.pop()
        if n < 0:
            order.append(~n)
            continue
        stack.append(~n)
        stack.extend(c for c in kids[n] if 0 <= c < w)
    cnt = [0] * w
    for n in order:
        cnt[n] = sum(1 if c >= w else cnt[c] for c in kids[n] if c >= 0)

    roots, stack = [], [0]
    while stack:
        n = stack.pop()
        if cnt[n] <= max_leaves:
            roots.append(n)
            continue
        for c in kids[n]:
            if c < 0:
                continue
            if c >= w or cnt[c] <= max_leaves:
                roots.append(c)
            else:
                stack.append(c)

    r = np.asarray(roots, np.int64)
    leaf = r >= w
    s = src[np.where(leaf, 0, r)]                     # (F, 4) binary ids of wide roots
    empty = (s < 0)[..., None]
    bmin = np.where(empty, np.inf, nmin[np.maximum(s, 0)]).min(axis=1)
    bmax = np.where(empty, -np.inf, nmax[np.maximum(s, 0)]).max(axis=1)
    b = ni + (r - w)
    bmin = np.where(leaf[:, None], nmin[np.where(leaf, b, 0)], bmin).astype(np.float32)
    bmax = np.where(leaf[:, None], nmax[np.where(leaf, b, 0)], bmax).astype(np.float32)
    dev = bvh.node_min.device
    return Frontier(torch.as_tensor(r.astype(np.int32), device=dev),
                    torch.as_tensor(bmin, device=dev), torch.as_tensor(bmax, device=dev))


def binary_starts(bvh, links):
    """BVH4 start links (a wide id, or W + leaf id) as start links of the
    binary tree the overlay collapses (the binary node a wide node stands
    for, or num_internal + leaf id): the same subtrees, for the binary
    walk."""
    w = bvh.num_wide
    child, src = bvh.wide_child.long(), bvh.wide_src.long()
    inner = (child >= 0) & (child < w)
    bin_of = torch.zeros((w,), dtype=torch.int64, device=child.device)  # wide root 0 is node 0
    bin_of[child[inner]] = src[inner]
    links = links.long()
    return torch.where(links < w, bin_of[links.clamp(max=w - 1)],
                       links - w + bvh.num_internal).to(torch.int32)


def _entry_keys(fr: Frontier, o, d):
    """(B, F) i32 sortable entry keys: the bits of the clamped (>= 0) box
    entry t, KEY_INF on a miss. Non-negative f32 order as their i32 bits.

    The clamp gives +0.0 for an entry of -0.0 (a ray starting on a box
    plane), as XLA's ``maximum(tmin, 0.0)`` does on the CPU; a -0.0 would
    give the key 0x80000000, below every extraction bound. Computed one
    axis at a time on (B, F) tiles; the max over the axes differs from the
    reference's reduction at most in the sign of a zero, which the clamp
    removes."""
    inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)
    tmin = tmax = None
    for a in range(3):
        t1 = (fr.bmin[None, :, a] - o[:, a, None]) * inv[:, a, None]
        t2 = (fr.bmax[None, :, a] - o[:, a, None]) * inv[:, a, None]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    e = torch.where(tmin > 0.0, tmin, 0.0)
    return torch.where(tmax >= e, e.view(torch.int32), KEY_INF)


def _rank_mins(keys, prev_key, prev_fid, n_out: int):
    """First ``n_out`` (key, fid) pairs strictly after (prev_key,
    prev_fid) in lexicographic order, per row of ``keys`` (B, F); fid -1
    once a row has none left."""
    fids = torch.arange(keys.shape[1], dtype=torch.int32, device=keys.device)
    out = []
    pk, pf = prev_key, prev_fid
    for _ in range(n_out):
        cand = (keys > pk[:, None]) | ((keys == pk[:, None]) & (fids > pf[:, None]))
        k1 = torch.where(cand, keys, KEY_INF).amin(dim=1)
        at = cand & (keys == k1[:, None])
        f1 = torch.where(at, fids, _FID_BIG).amin(dim=1)
        f1 = torch.where(k1 == KEY_INF, -1, f1)
        out.append((k1, f1))
        pk, pf = k1, f1
    return out


def first_ranks(fr: Frontier, o, d, n_out: int = 2, block: int = 16384):
    """Phase 1 in blocks of ``block`` rays: each ray's first ``n_out``
    (entry key, fid) pairs in entry order, as [k1, f1, k2, f2, ...]."""
    neg = -(1 << 30)
    parts = []
    for s in range(0, max(o.shape[0], 1), block):
        ks = _entry_keys(fr, o[s:s + block], d[s:s + block])
        start = torch.full((ks.shape[0],), neg, dtype=torch.int32, device=ks.device)
        parts.append([x for kf in _rank_mins(ks, start, start, n_out) for x in kf])
    return [torch.cat(col) for col in zip(*parts)]


def next_rank(fr: Frontier, o, d, prev_key, prev_fid, block: int = 16384):
    """Each ray's next (entry key, fid) pair after (prev_key, prev_fid),
    in blocks of ``block`` rays."""
    parts = []
    for s in range(0, max(o.shape[0], 1), block):
        ks = _entry_keys(fr, o[s:s + block], d[s:s + block])
        parts.append(_rank_mins(ks, prev_key[s:s + block], prev_fid[s:s + block], 1)[0])
    return tuple(torch.cat(col) for col in zip(*parts))


def pack_round(rid, fid, valid, o, d, best_t, roots, F: int, cap: int, rowsz: int = 128):
    """Lay a round's valid (ray ``rid``, subtree ``fid``) pairs out for one
    launch of ``cap`` lanes (a multiple of ``rowsz``): grouped by subtree in
    a stable order, each group padded to whole ``rowsz``-lane rows.

    Returns (o_p, d_p, seed_p, rid_p, live, starts): per lane the ray, its
    best-t seed, its ray id and whether it carries a pair; per row the
    start link (root 0 for rows beyond the data, whose lanes are dead).
    Invalid pairs are written to the dump lane ``cap - 1`` (never a data
    lane: the groups fill at most ``cap - F`` lanes), which is then reset
    in every output, so the duplicate writes there leave nothing behind."""
    n = rid.shape[0]
    dev = rid.device
    order = torch.argsort(torch.where(valid, fid, _FID_BIG), stable=True)  # valid first
    rid_s = rid[order].long()
    valid_s = valid[order]
    fid_s = torch.where(valid_s, fid[order], F).long()  # ascending, sentinel group F last
    # each group's first lane, found in the sorted ids (bincount would read
    # its length back to the host)
    first = torch.searchsorted(fid_s, torch.arange(F + 1, device=dev))
    counts = first[1:] - first[:-1]
    first = first[:-1]
    padded = (counts + rowsz - 1) // rowsz * rowsz
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    offs = torch.cat([zero, torch.cumsum(padded, 0)])[:-1]
    g = fid_s.clamp(max=F - 1)
    pos = offs[g] + (torch.arange(n, device=dev) - first[g])
    pos = torch.where(valid_s, pos, cap - 1).clamp(max=cap - 1)

    o_p = torch.full((cap, 3), _PAD_O, dtype=torch.float32, device=dev)
    d_p = torch.full((cap, 3), _PAD_D, dtype=torch.float32, device=dev)
    seed_p = torch.zeros((cap,), dtype=torch.float32, device=dev)
    rid_p = torch.zeros((cap,), dtype=torch.int32, device=dev)
    live = torch.zeros((cap,), dtype=torch.bool, device=dev)
    o_p[pos] = o[rid_s]
    d_p[pos] = d[rid_s]
    seed_p[pos] = best_t[rid_s]
    rid_p[pos] = rid_s.to(torch.int32)
    live[pos] = valid_s
    # fill_ launches a kernel; assigning a Python number copies it from the host
    o_p[cap - 1].fill_(_PAD_O)
    d_p[cap - 1].fill_(_PAD_D)
    seed_p[cap - 1].fill_(0.0)
    rid_p[cap - 1].fill_(0)
    live[cap - 1].fill_(False)

    row0 = torch.arange(cap // rowsz, device=dev) * rowsz
    grp = torch.searchsorted(offs, row0, right=True) - 1
    in_data = row0 < (offs + padded)[grp.clamp(min=0)]
    starts = torch.where(in_data, roots[grp.clamp(0, F - 1)], 0)
    return o_p, d_p, seed_p, rid_p, live, starts


def merge_round(best_t, best_i, rid_p, live, seed_p, t_ret, i_ret):
    """Exact scatter-min fold of a round's results into (t, tri): a lane
    counts where it found a hit below its seed; among a ray's lanes at the
    new best t, the lowest triangle id wins."""
    found = live & (t_ret < seed_p)
    t_eff = torch.where(found, t_ret, float("inf"))
    r = rid_p.long()
    b2 = best_t.scatter_reduce(0, r, t_eff, "amin", include_self=True)
    cand = torch.where(found & (t_eff <= b2[r]), i_ret, TRI_BIG)
    tmin = torch.full_like(best_i, TRI_BIG).scatter_reduce(0, r, cand, "amin", include_self=True)
    return b2, torch.where((b2 < best_t) & (tmin < TRI_BIG), tmin, best_i)


def _check_tables(bvh, tables) -> None:
    if not isinstance(tables, pt.WideTables) or tables.s_resident:
        raise ValueError("the compact path needs resident BVH4 tables (f32 or bf16)")
    if tables.num_wide != bvh.num_wide:
        raise ValueError(f"tables hold {tables.num_wide} wide nodes, the BVH {bvh.num_wide}")


def _lane_starts(starts, rowsz: int):
    """Per-row start links repeated over each row's ``rowsz`` lanes."""
    return starts[:, None].expand(-1, rowsz).reshape(-1)


def _bucket(size: int, n: int, divs, blk: int) -> int:
    """Lanes of a tail round whose active set holds ``size`` of ``n`` rays:
    the smallest ``ceil(n / div)`` over ``divs`` that holds it, rounded up
    to whole blocks of ``blk`` lanes, so a few captured shapes serve every
    round (the reference's rule)."""
    for dv in reversed(divs):
        c = -(-n // dv)
        if size <= c:
            return -(-c // blk) * blk
    return -(-n // blk) * blk


class _Body:
    """One unit of a :class:`_Run` for ``graphs.staged_unit``: its stages
    run ``step(stage)`` on the run's buffers, and the warm-up's writes to
    the carry are undone by the run's save and restore."""

    keep = ()  # the run holds the buffers and tables as long as its units

    def __init__(self, run, label: str, stages: tuple, step):
        self.label, self.stages, self._step, self._run = label, stages, step, run
        self.inputs = run.o

    def run(self, stage: str):
        return self._step(stage)

    replay = run

    def save(self):
        return self._run.save()

    def restore(self, saved) -> None:
        self._run.restore(saved)


class _Run:
    """Compacted walks of ``n`` rays through one (tables, frontier): static
    buffers, and the units that run on them, each made on first use and
    captured into the run's one pool.

    Buffers: the rays (``o``, ``d``; row ``n`` a pad ray), phase 1's ranks,
    the carry (best t and triangle, last entry key and subtree; row ``n``
    a dump row that a tail round's padding lanes write and no read takes
    unmasked), and the active list (ray ids in ascending order, padded
    with ``n``; ``top``, the largest bucket, is its dump slot) with its
    count. Stages: ``phase1``, ``round0`` and ``round1`` (the head, the
    last also writing the first active list), then tail rounds, each of
    which gathers the active rays, extracts their next ranks, walks and
    merges them, and writes the next active list. The host reads the count
    once per tail round.

    A stage runs as a captured unit (``head``, or ``tail/<lanes>`` for a
    tail round padded to its bucket) only where host dispatch bounds it:
    where its rank sweep spans at most :data:`GRAPH_SWEEP` (ray, subtree)
    entries. Otherwise, and always when ``graphed`` is false, it runs op
    by op at its exact size."""

    def __init__(self, tables, fr: Frontier, n: int, rowsz: int, algo: str, block: int,
                 buckets: tuple, dev, graphed: bool = True):
        f = int(fr.roots.shape[0])
        if f:  # every start link comes from here; check once, on the host
            lo, hi = (int(v) for v in torch.aminmax(fr.roots))
            if lo < 0 or hi >= pt._wide_nodes(tables):
                raise ValueError(f"frontier roots span [{lo}, {hi}]; the tables hold nodes "
                                 f"[0, {pt._wide_nodes(tables)})")
        self.tables, self.fr, self.f = tables, fr, f
        self.n, self.rowsz, self.algo, self.block, self.buckets = n, rowsz, algo, block, buckets
        self.graphed = graphed
        self.top = _bucket(n, n, buckets, rowsz)
        f32, i32 = torch.float32, torch.int32
        self.o = torch.full((n + 1, 3), _PAD_O, dtype=f32, device=dev)
        self.d = torch.full((n + 1, 3), _PAD_D, dtype=f32, device=dev)
        self.ranks = torch.zeros((4, n), dtype=i32, device=dev)  # k1, f1, k2, f2
        self.best_t = torch.zeros((n + 1,), dtype=f32, device=dev)
        self.best_i = torch.zeros((n + 1,), dtype=i32, device=dev)
        self.pk = torch.zeros((n + 1,), dtype=i32, device=dev)
        self.pf = torch.zeros((n + 1,), dtype=i32, device=dev)
        self.ids = torch.arange(n, device=dev)
        self.act = torch.full((self.top + 1,), n, dtype=torch.int64, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.pool = torch.cuda.graph_pool_handle() if graphed and self.o.is_cuda else None
        self.units: dict = {}

    def _carry(self) -> tuple:
        return self.best_t, self.best_i, self.pk, self.pf, self.act, self.count

    def save(self) -> list:
        return [x.clone() for x in self._carry()]

    def restore(self, saved) -> None:
        for x, v in zip(self._carry(), saved):
            x.copy_(v)

    def _unit(self, name: str, stages: tuple, step):
        u = self.units.get(name)
        if u is None:
            label = f"compact {name} (n={self.n}, F={self.f}, rows of {self.rowsz})"
            u = self.units[name] = graphs.staged_unit(_Body(self, label, stages, step), self.pool)
        return u

    def _capture(self, lanes: int) -> bool:
        """Whether a stage whose rank sweep covers ``lanes`` rays replays a
        unit (dispatch-bound) or runs op by op (device-bound)."""
        return self.graphed and lanes * self.f <= GRAPH_SWEEP

    def _head(self, stage):
        n = self.n
        if stage == "phase1":
            for dst, src in zip(self.ranks, first_ranks(self.fr, self.o[:n], self.d[:n], 2,
                                                        self.block)):
                dst.copy_(src)
            self.best_t.fill_(T_FAR)
            self.best_i.zero_()
            self.pk.fill_(KEY_INF)
            self.pf.zero_()
            return
        # rounds 0 and 1: each ray's rank-0, then rank-1 pair
        k, f = self.ranks[:2] if stage == "round0" else self.ranks[2:]
        self._walk(self.ids, f, (f >= 0) & (k.view(torch.float32) < self.best_t[:n]))
        if stage == "round1":
            pk = self.pk[:n]
            pk.copy_(torch.where(f >= 0, k, KEY_INF))
            self.pf[:n] = torch.where(f >= 0, f, _FID_BIG)
            # a ray stays active while its last pair entered below its proven
            # best (pairs come in entry order, so the test is exhaustive)
            self._compact(self.ids, (pk != KEY_INF) & (pk.view(torch.float32) < self.best_t[:n]))

    def _walk(self, rid, fid, valid) -> None:
        """Pack, walk and merge one round's pairs into the carry."""
        rowsz = self.rowsz
        cap = (-(-rid.shape[0] // rowsz) + self.f) * rowsz
        o_p, d_p, seed_p, rid_p, live, starts = pack_round(
            rid, fid.clamp(min=0), valid, self.o, self.d, self.best_t, self.fr.roots, self.f,
            cap, rowsz)
        t_r, i_r = pt.traverse_packed(self.tables, o_p, d_p, seed_p, algo=self.algo,
                                      start=_lane_starts(starts, rowsz), start_checked=True)
        best_t, best_i = merge_round(self.best_t, self.best_i, rid_p, live, seed_p, t_r, i_r)
        self.best_t.copy_(best_t)
        self.best_i.copy_(best_i)

    def _compact(self, ids, still) -> None:
        """The active list: ``ids`` where ``still``, in order, padded with n."""
        pos = torch.cumsum(still, 0) - 1
        self.act.fill_(self.n)
        self.act[torch.where(still, pos, self.top)] = ids
        self.count.copy_(still.sum())

    def _tail(self, lanes: int):
        """One tail round over the first ``lanes`` entries of the active
        list: its active rays, then padding (id n) up to a bucket."""
        idx = self.act[:lanes].clone()
        real = idx < self.n
        ka, fa = next_rank(self.fr, self.o[idx], self.d[idx],
                           torch.where(real, self.pk[idx], KEY_INF),
                           torch.where(real, self.pf[idx], _FID_BIG), self.block)
        has = real & (fa >= 0)
        ea = ka.view(torch.float32)
        self._walk(idx, fa, has & (ea < self.best_t[idx]))
        self.pk[idx] = ka  # the real rays once each; the padding lanes into row n
        self.pf[idx] = fa
        self._compact(idx, has & (ea < self.best_t[idx]))

    def __call__(self, o, d, max_rounds: int, stats: dict | None) -> RayHit:
        n = self.n
        made, replays = len(self.units), 0
        self.o[:n].copy_(o)
        self.d[:n].copy_(d)
        head = ("phase1", "round0", "round1")
        if self._capture(n):
            unit = self._unit("head", head, self._head)
            for s in head:
                unit.replay(s)
            replays += 1
        else:
            for s in head:
                self._head(s)
        count = int(self.count)
        active, lanes_run = [], []
        for _ in range(max_rounds - 2):
            if count == 0:
                break
            active.append(count)
            lanes = _bucket(count, n, self.buckets, self.rowsz)
            if self._capture(lanes):
                self._unit(f"tail/{lanes}", ("tail",),
                           lambda _stage, lanes=lanes: self._tail(lanes)).replay("tail")
                replays += 1
            else:
                lanes = count
                self._tail(lanes)
            lanes_run.append(lanes)
            count = int(self.count)
        if stats is not None:
            stats.update(rounds=2 + len(active), active=active, buckets=lanes_run,
                         replays=replays, captures=len(self.units) - made, units=self.units)
        if count:
            raise RuntimeError(f"{count} rays still have pairs to walk after {max_rounds} "
                               "rounds; raise max_rounds")
        best_t = self.best_t[:n].clone()
        hit = best_t < T_FAR
        return RayHit(t=best_t, tri=torch.where(hit, self.best_i[:n], 0), hit=hit)


def _prepare(bvh, tables, o, d):
    _check_tables(bvh, tables)
    return o.detach().contiguous(), d.detach().contiguous()


@torch.no_grad()
def raycast_compact(bvh, tables, fr: Frontier, o, d, rowsz: int = 128, max_rounds: int = 24,
                    algo: str = "mt", block: int = 16384, tail_buckets=(1, 8, 64),
                    stats: dict | None = None) -> RayHit:
    """Closest hit through the compacted two-phase pipeline.

    ``tables``: resident BVH4 tables of ``bvh`` (``pack_tables_wide``, f32
    or bf16); paged tables are refused, as in the reference. Each round's
    launch has one start link per ray, the root of its pair's subtree,
    given per ``rowsz``-lane row by :func:`pack_round`. The reference's
    ``rows_pp`` and ``ways`` (the TPU kernel's packet shape) have no
    counterpart: the CUDA kernel walks one ray per thread, and a tail
    round's active set is padded to the buckets of ``tail_buckets`` in
    blocks of ``rowsz`` lanes (:func:`_bucket`).

    The walk runs on the buffers of a cached :class:`_Run` (keyed on the
    BVH, held weakly, the tables' and frontier's tensors, the ray count and
    the options; up to ``graphs.MAX_COMPACT_RUNS`` runs, each holding its
    buffers and its units' one pool until it is evicted or
    ``graphs.clear()``). A stage whose rank sweep spans at most
    :data:`GRAPH_SWEEP` (ray, subtree) entries, where host dispatch and not
    the device bounds it, replays a unit (phase 1 with rounds 0 and 1, or a
    tail round padded to its bucket): on a CUDA device a CUDA graph captured
    on first use, on the CPU its body run eagerly. A larger stage runs op
    by op at its exact size, as in :func:`raycast_compact_eager`. The only
    host reads are the active count, once per tail round. The result equals
    :func:`raycast_compact_eager`'s word for word. Raises RuntimeError if
    rays are still active after ``max_rounds``. ``stats``, if given,
    receives ``rounds`` (rounds run), ``active`` (active rays entering each
    tail round), ``buckets`` (the lanes each tail round ran: its bucket if
    it replayed a unit, else its active count), ``replays`` (unit
    replays), ``captures`` (units made by this call) and ``units`` (the
    run's units by name: ``graphs.StagedUnit`` on the card, the bodies on
    the CPU; ``replay(stage)`` runs either)."""
    o, d = _prepare(bvh, tables, o, d)
    n = o.shape[0]
    buckets = tuple(tail_buckets)
    key = ("compact", graphs.fingerprint(tables, fr), n, rowsz, algo, block, buckets, o.device)
    run = graphs.compact_run((bvh,), key,
                             lambda: _Run(tables, fr, n, rowsz, algo, block, buckets, o.device))
    return run(o, d, max_rounds, stats)


@torch.no_grad()
def raycast_compact_eager(bvh, tables, fr: Frontier, o, d, rowsz: int = 128,
                          max_rounds: int = 24, algo: str = "mt", block: int = 16384,
                          stats: dict | None = None) -> RayHit:
    """:func:`raycast_compact` with every stage dispatched op by op at its
    exact size and nothing captured or cached: the A/B its units are held
    to."""
    o, d = _prepare(bvh, tables, o, d)
    n = o.shape[0]
    return _Run(tables, fr, n, rowsz, algo, block, (1,), o.device, graphed=False)(
        o, d, max_rounds, stats)
