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

Two faults of the reference are not carried over: its tail rounds pad the
active set with ray 0 and scatter through the padded indices, so ray 0's
rank may not advance; and rays still active after ``max_rounds`` are
dropped without notice. Here the tail rounds scatter through the active
rays only, and an exhausted round budget raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..intersect import RayHit, T_FAR
from . import pallas_traverse as pt

__all__ = ["Frontier", "build_frontier", "binary_starts", "first_ranks", "next_rank",
           "pack_round", "merge_round", "raycast_compact", "KEY_INF", "TRI_BIG"]

TRI_BIG = 1 << 24
KEY_INF = 0x7F800000  # +inf bit pattern: the top of the sortable-int keys
_FID_BIG = 1 << 30
_PAD_O = 1e8          # origin and direction of the lanes that carry no pair
_PAD_D = 0.5773503


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
    fid_s = torch.where(valid_s, fid[order], F).long()  # sentinel group F
    counts = torch.bincount(fid_s, minlength=F + 1)[:F]
    padded = (counts + rowsz - 1) // rowsz * rowsz
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    offs = torch.cat([zero, torch.cumsum(padded, 0)])[:-1]
    first = torch.cat([zero, torch.cumsum(counts, 0)])[:-1]
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
    o_p[cap - 1] = _PAD_O
    d_p[cap - 1] = _PAD_D
    seed_p[cap - 1] = 0.0
    rid_p[cap - 1] = 0
    live[cap - 1] = False

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


@torch.no_grad()
def raycast_compact(bvh, tables, fr: Frontier, o, d, rowsz: int = 128, max_rounds: int = 24,
                    algo: str = "mt", block: int = 16384, stats: dict | None = None) -> RayHit:
    """Closest hit through the compacted two-phase pipeline.

    ``tables``: resident BVH4 tables of ``bvh`` (``pack_tables_wide``, f32
    or bf16); paged tables are refused, as in the reference. Each round's
    launch has one start link per ray, the root of its pair's subtree,
    given per ``rowsz``-lane row by :func:`pack_round`. The reference's
    ``rows_pp`` and ``ways`` (the TPU kernel's packet shape) have no
    counterpart: the CUDA kernel walks one ray per thread. The active set
    of each tail round is read back to the host, as in the reference.
    Raises RuntimeError if rays are still active after ``max_rounds``.
    ``stats``, if given, receives ``rounds`` (rounds run) and ``active``
    (active rays entering each tail round)."""
    if not isinstance(tables, pt.WideTables) or tables.s_resident:
        raise ValueError("the compact path needs resident BVH4 tables (f32 or bf16)")
    if tables.num_wide != bvh.num_wide:
        raise ValueError(f"tables hold {tables.num_wide} wide nodes, the BVH {bvh.num_wide}")
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    f = int(fr.roots.shape[0])
    n = o.shape[0]
    dev = o.device

    def run_round(rid, fid, key, best_t, best_i):
        valid = (fid >= 0) & (key.view(torch.float32) < best_t[rid])
        cap = (-(-rid.shape[0] // rowsz) + f) * rowsz
        o_p, d_p, seed_p, rid_p, live, starts = pack_round(
            rid, fid.clamp(min=0), valid, o, d, best_t, fr.roots, f, cap, rowsz)
        t_r, i_r = pt.traverse_packed(tables, o_p, d_p, seed_p, algo=algo,
                                      start=starts.repeat_interleave(rowsz).contiguous())
        return merge_round(best_t, best_i, rid_p, live, seed_p, t_r, i_r)

    k1, f1, k2, f2 = first_ranks(fr, o, d, 2, block)
    best_t = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    # rounds 0 and 1: each ray's rank-0, then rank-1 pair
    best_t, best_i = run_round(rid, f1, k1, best_t, best_i)
    best_t, best_i = run_round(rid, f2, k2, best_t, best_i)
    pk = torch.where(f2 >= 0, k2, KEY_INF)
    pf = torch.where(f2 >= 0, f2, _FID_BIG)

    # tail rounds: a ray stays active while its last pair entered below its
    # proven best (pairs come in entry order, so the test is exhaustive)
    act = torch.nonzero((pk != KEY_INF) & (pk.view(torch.float32) < best_t)).squeeze(1)
    active, rounds = [], 2
    for _ in range(max_rounds - 2):
        if act.numel() == 0:
            break
        active.append(act.numel())
        rounds += 1
        ka, fa = next_rank(fr, o[act], d[act], pk[act], pf[act], block)
        best_t, best_i = run_round(act, fa, ka, best_t, best_i)
        pk[act] = ka  # exactly the active rays: no index is written twice
        pf[act] = fa
        act = act[(fa >= 0) & (ka.view(torch.float32) < best_t[act])]
    if stats is not None:
        stats.update(rounds=rounds, active=active)
    if act.numel():
        raise RuntimeError(f"{act.numel()} rays still have pairs to walk after {max_rounds} "
                           "rounds; raise max_rounds")
    hit = best_t < T_FAR
    return RayHit(t=best_t, tri=torch.where(hit, best_i, 0), hit=hit)
