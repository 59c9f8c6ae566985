"""Ray-sort keys: the coherence keys of ``terra_tpu/accel/traverse.py``.

The traversal wrappers sort a batch by these keys before they launch the
kernel and restore the order after it, so that neighbouring threads of a
warp walk neighbouring parts of the tree. Sorting changes no per-ray
result. The keys equal the reference's bit for bit.

The reference computes the keys in uint32. PyTorch supports few uint32
operations, so each key here is an int64 tensor holding a value in
``[0, 2**32)``, as ``ops/rng.py`` holds its words; every mask is below
2**32, so no step needs an explicit wrap, and int64 keys sort as the
uint32 ones do.

The stackless XLA packet walk of the same reference module
(``_packet_raycast``, ``raycast``) is not ported (ROADMAP queue A).
"""
from __future__ import annotations

import torch

__all__ = ["hinted_keys", "leaf_of_tri_table", "sort_order"]


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
