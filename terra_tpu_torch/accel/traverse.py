"""Ray-sort keys and the stackless packet walk of ``terra_tpu/accel/traverse.py``.

The traversal wrappers sort a batch by these keys before they launch the
kernel and restore the order after it, so that neighbouring threads of a
warp walk neighbouring parts of the tree. Sorting changes no per-ray
result. The keys equal the reference's bit for bit.

The reference computes the keys in uint32. PyTorch supports few uint32
operations, so each key here is an int64 tensor holding a value in
``[0, 2**32)``, as ``ops/rng.py`` holds its words; every mask is below
2**32, so no step needs an explicit wrap, and int64 keys sort as the
uint32 ones do.

:func:`raycast` and :func:`_packet_raycast` are the reference's stackless
packet walk, in plain PyTorch: rays grouped in packets of
:data:`PACKET_SIZE` share one cursor that follows the tree's preorder
threads (``dfs_next`` to descend, ``dfs_skip`` past a subtree), so a
packet carries no stack. The render never takes it (``render.make_raycast_fn``
launches the CUDA kernels, which have no shared-memory budget to fall back
from); it is reached by name, as a second exact walk to hold the kernels to.
"""
from __future__ import annotations

import torch

from ..intersect import RayHit, T_FAR, mt_grid_components

__all__ = ["hinted_keys", "leaf_of_tri_table", "sort_order", "raycast", "PACKET_SIZE"]

PACKET_SIZE = 64
ADVANCE_UNROLL = 8  # skip-link steps per advance iteration


def _spread3(v):
    """10-bit Morton spread of int64 words."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton3_bits(x, bits: int):
    """Interleaved Morton code of (..., 3) f32 values already scaled to
    [0, 2^bits); returns 3*bits-bit codes as int64. The f32 -> integer
    conversion truncates toward zero, as the reference's cast to uint32
    does for the clamped, non-negative values."""
    q = torch.clamp(x, 0.0, float((1 << bits) - 1)).to(torch.int64)
    return ((_spread3(q[..., 0]) << 2) | (_spread3(q[..., 1]) << 1)
            | _spread3(q[..., 2])) & ((1 << (3 * bits)) - 1)


def _sort_keys(o, d, scene_min, scene_max, mode: str = "octant", bvh=None):
    """Coherence keys (int64 in [0, 2^32)):

      octant  — direction octant (3 high bits) + 7-bit/axis origin Morton
      dir2    — 2-bit/axis quantized direction (6 high bits) + origin Morton
      dir3    — 3-bit/axis direction (9 high bits) + origin Morton
      treelet — first-descent subtree path (8 high bits, needs ``bvh``) +
                origin Morton
    """
    inv_ext = 1.0 / torch.clamp(scene_max - scene_min, min=1e-12)
    on = (o - scene_min) * inv_ext  # [0,1] inside the scene
    morton = _morton3_bits(on * 127.0, 7)  # 21 bits
    if mode == "treelet":
        return (_treelet_path(bvh, o, d, depth=8) << 24) | morton
    dir_bits = {"octant": 1, "dir2": 2, "dir3": 3}[mode]
    dn = (d + 1.0) * 0.5
    dkey = _morton3_bits(dn * float(1 << dir_bits), dir_bits)
    return (dkey << 21) | morton


def _treelet_path(bvh, o, d, depth: int = 8):
    """Per-ray first-descent path bits (int64): from the binary root, step
    ``depth`` times to the child with the smaller slab entry t, recording
    left (0) or right (1) per level; a ray that reaches a leaf or misses
    both children stays and records 0."""
    ni = bvh.num_internal
    n = o.shape[0]
    inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)

    def entry(nid):
        t1 = (bvh.node_min[nid] - o) * inv
        t2 = (bvh.node_max[nid] - o) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        tmin = torch.where(tmin > 0.0, tmin, 0.0)
        return torch.where(tmax >= tmin, tmin, float("inf"))

    node = torch.zeros((n,), dtype=torch.int64, device=o.device)
    path = torch.zeros((n,), dtype=torch.int64, device=o.device)
    if ni == 0:
        return path
    left, right = bvh.node_left.long(), bvh.node_right.long()
    for _ in range(depth):
        is_int = node < ni
        safe = torch.where(is_int, node, 0)
        l, r = left[safe], right[safe]
        el, er = entry(l), entry(r)
        pick_r = er < el
        ok = is_int & (torch.minimum(el, er) < float("inf"))
        node = torch.where(ok, torch.where(pick_r, r, l), node)
        path = (path << 1) | (ok & pick_r).to(torch.int64)
    return path


def hinted_keys(leaf_of_tri, sort_hint, d):
    """Parent-hit coherence keys: the BVH leaf holding the parent hit's
    triangle (``sort_hint``, -1 for a lane with no parent) above a
    3-bit/axis direction code. Leaf ids are clamped below the dead-lane
    sentinel 0x3FFFFF, as in the reference."""
    hint = sort_hint.long()
    leaf = torch.where(hint >= 0,
                       torch.clamp(leaf_of_tri[torch.clamp(hint, min=0)].long(), max=0x3FFFFE),
                       0x3FFFFF)
    dn = (d + 1.0) * 0.5
    return (leaf << 9) | _morton3_bits(dn * 8.0, 3)


def leaf_of_tri_table(bvh):
    """(T,) i32: the BVH leaf holding each triangle. A triangle in several
    slots (leaves padded by repetition) gets the last of its leaves in slot
    order, which is the reference's last writer; its scatter leaves the
    winner among duplicates unspecified, and any holding leaf serves."""
    leaf_tri = bvh.leaf_tri.long()
    c, per = leaf_tri.shape
    t = max(int(bvh.tri_order.shape[0]), 1)
    leaf_ids = torch.arange(c, dtype=torch.int64, device=leaf_tri.device).repeat_interleave(per)
    table = torch.zeros((t,), dtype=torch.int64, device=leaf_tri.device)
    table = table.scatter_reduce(0, leaf_tri.reshape(-1), leaf_ids, "amax", include_self=True)
    return table.to(torch.int32)


def sort_order(bvh, o, d, mode: str = "octant", sort_hint=None, leaf_of_tri=None):
    """Stable permutation that sorts the rays by their coherence keys:
    :func:`hinted_keys` when both the hint and the table are given, else
    :func:`_sort_keys` over the root box in ``mode``."""
    if sort_hint is not None and leaf_of_tri is not None:
        keys = hinted_keys(leaf_of_tri, sort_hint, d)
    else:
        keys = _sort_keys(o, d, bvh.node_min[0], bvh.node_max[0], mode=mode, bvh=bvh)
    return torch.argsort(keys, stable=True)


def _packet_raycast(bvh, tri_a, tri_b, tri_c, o, d, max_outer: int = 4096, algo: str = "mt",
                    t_init=None, any_hit: bool = False):
    """o, d: (P2, P, 3) packets. Returns (best_t, best_tri), each (P2, P).
    ``t_init``: optional (P2, P) best-t seed (occlusion queries).

    Each iteration takes :data:`ADVANCE_UNROLL` skip-link steps per packet
    (a step tests the cursor's box against every ray of the packet: a hit
    descends, a miss skips the subtree, a hit leaf stays), then tests every
    packet resting on a leaf against all its triangles at once. The
    reference's ``lax.while_loop`` over ``any(cur >= 0)`` is a Python loop
    here, which reads that flag from the device once per iteration.
    ``max_outer`` is the reference's argument, which its loop does not use
    either."""
    p2, p, _ = o.shape
    ni = bvh.num_internal
    inv_d = torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)
    leaf_tri = bvh.leaf_tri.long()
    flat = leaf_tri.reshape(-1)
    la, lb, lc = (x[flat].reshape(bvh.num_leaves, bvh.leaf_size, 3) for x in (tri_a, tri_b, tri_c))
    best_t = torch.full((p2, p), T_FAR, dtype=torch.float32, device=o.device) \
        if t_init is None else t_init
    if ni == 0:  # a single leaf: test it directly
        valid, t = mt_grid_components(o, d, la[:1], lb[:1], lc[:1], algo=algo)
        t = torch.where(valid & (t < best_t[..., None]), t, T_FAR)
        t_leaf, arg = torch.min(t, dim=2)
        return torch.minimum(t_leaf, best_t), leaf_tri[0][arg].to(torch.int32)
    dfs_next, dfs_skip = bvh.dfs_next.long(), bvh.dfs_skip.long()

    def box_any_hit(cur, best_t):
        """Does any ray of the packet hit the cursor's box closer than its best?"""
        safe = torch.clamp(cur, min=0)
        t1 = (bvh.node_min[safe][:, None, :] - o) * inv_d
        t2 = (bvh.node_max[safe][:, None, :] - o) * inv_d
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        # >= not >: a flat box gives tmin == tmax for every ray through it
        hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < best_t)
        return hit.any(dim=1)

    cur = torch.zeros((p2,), dtype=torch.int64, device=o.device)
    best_i = torch.zeros((p2, p), dtype=torch.int32, device=o.device)
    while bool((cur >= 0).any()):
        for _ in range(ADVANCE_UNROLL):  # descend or skip; a hit leaf stays
            live = cur >= 0
            hit = box_any_hit(cur, best_t) & live
            ready = (cur >= ni) & hit
            safe = torch.clamp(cur, min=0)
            nxt = torch.where(hit, dfs_next[safe], dfs_skip[safe])
            cur = torch.where(live & ~ready, nxt, cur)
        at_leaf = cur >= ni
        leaf_id = torch.where(at_leaf, cur - ni, 0)
        valid, t = mt_grid_components(o, d, la[leaf_id], lb[leaf_id], lc[leaf_id],
                                      algo=algo)
        t = torch.where(valid & at_leaf[:, None, None], t, T_FAR)
        t_leaf, arg = torch.min(t, dim=2)
        tri = leaf_tri[leaf_id[:, None], arg].to(torch.int32)
        take = t_leaf < best_t
        # an occlusion query's accepted hit collapses best t to 0, which
        # prunes the ray from every later box test
        best_t = torch.where(take, 0.0 if any_hit else t_leaf, best_t)
        best_i = torch.where(take, tri, best_i)
        cur = torch.where(at_leaf, dfs_skip[torch.clamp(cur, min=0)], cur)
    return best_t, best_i


def raycast(scene, o, d, packet_size: int = PACKET_SIZE, sort_rays: bool = True,
            algo: str = "mt", t_max=None, any_hit: bool = False, sort_hint=None,
            leaf_of_tri=None) -> RayHit:
    """Closest hit by the stackless packet walk. o, d: (N, 3).

    ``sort_rays`` walks a batch of more than ``packet_size`` rays in the
    order of the coherence keys (parent-hit keys when ``sort_hint`` and
    ``leaf_of_tri`` are given, else octant keys over the root box) and
    scatters the results back. ``t_max``: optional (N,) per-ray best-t
    seed, the occlusion query; ``hit`` then means occluded within t_max.
    No result carries a gradient."""
    bvh = scene.bvh
    with torch.no_grad():
        tri_a, tri_b, tri_c = (c.detach() for c in scene.geometry.corners())
        o, d = o.detach(), d.detach()
        tm = None if t_max is None else t_max.detach()
        n = o.shape[0]
        order = None
        if sort_rays and n > packet_size:
            order = sort_order(bvh, o, d, "octant", sort_hint, leaf_of_tri)
            o, d = o[order], d[order]
            if tm is not None:
                tm = tm[order]
        pad = -n % packet_size
        if pad:
            o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
            d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype, device=d.device)])
            if tm is not None:
                tm = torch.cat([tm, torch.zeros((pad,), dtype=tm.dtype, device=tm.device)])
        p2 = o.shape[0] // packet_size
        best_t, best_i = _packet_raycast(
            bvh, tri_a, tri_b, tri_c, o.reshape(p2, packet_size, 3),
            d.reshape(p2, packet_size, 3), algo=algo,
            t_init=None if tm is None else tm.reshape(p2, packet_size), any_hit=any_hit)
        best_t, best_i = best_t.reshape(-1)[:n], best_i.reshape(-1)[:n]
        if order is not None:
            back_t, back_i = torch.empty_like(best_t), torch.empty_like(best_i)
            back_t[order], back_i[order] = best_t, best_i
            best_t, best_i = back_t, back_i
        hit = best_t < (T_FAR if t_max is None else t_max.detach())
        return RayHit(t=best_t, tri=torch.where(hit, best_i, 0), hit=hit)
