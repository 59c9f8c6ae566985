"""BVH traversal: the hand-written CUDA kernels and their plain PyTorch versions.

The module keeps the path of ``terra_tpu/accel/pallas_traverse.py``, whose
Pallas kernel it replaces; there is no Pallas here. The reference kernel
walks either the binary tree (``arity=2``) or its BVH4 overlay
(``arity=4``, with f32, bf16-quantized or paged node tables); the port has
one CUDA kernel for each tree shape:

  * :func:`pack_tables` — the binary tree and the leaf-ordered triangles in
    the layout ``csrc/bvh_traverse.cu`` reads; :func:`raycast_plain` and
    :func:`raycast_cuda` walk it;
  * :func:`pack_tables_wide` / :func:`pack_tables_paged` — the BVH4
    overlay's f32 or bf16 tables, or the paged split (nodes ``[0, S)``
    staged in shared memory, the rest read from device memory) that
    ``csrc/bvh4_traverse.cu`` reads; :func:`raycast4_plain` and
    :func:`raycast4_cuda` walk them, optionally counting per-ray steps
    (:func:`count_decode`);
  * :func:`wide_mode` / :func:`pack_tables_auto` — the reference's choice
    of table kind, priced against the port's :data:`NODE_TABLE_BUDGET`;
  * :func:`raycast` / :func:`traverse_packed` — dispatch on the table kind
    and on the tensors' device (CPU tensors take the plain version, CUDA
    tensors the kernel; there is no fallback); :func:`raycast` sorts the
    rays by the reference's coherence keys (``traverse.py``) first.

Every walk takes optional per-ray start links (the reference's
``start_links``, one per packet there): the node each ray's stack starts
from instead of the root, popped without a box test as the root is. The
compacted two-phase traversal (``compact.py``) starts rays in subtrees.

Every plain version pops the same nodes in the same order as its kernel,
with the same rounding, so the two agree bit for bit. Outputs carry no
gradient, as the reference stops gradients at the hit.
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch

from .._build import build_shared, nvcc
from ..profile import kernel_launches
from ..intersect import RayHit, T_FAR, leaf_test
from .traverse import sort_order

__all__ = ["Tables", "WideTables", "pack_tables", "pack_tables_wide", "pack_tables_paged",
           "pack_tables_auto", "paged_resident", "wide_mode", "use_wide", "raycast",
           "raycast_plain", "raycast_cuda", "raycast4_plain", "raycast4_cuda",
           "traverse_packed", "count_decode", "leaf_real_counts", "load_kernel", "load_kernel4",
           "occupancy", "fits_smem", "supported",
           "STACK_CAP", "NODE_TABLE_BUDGET", "PAGED_SMEM_BUDGET", "SMEM_NODE_BUDGET",
           "PACKET"]

# Per-thread stack entries, the reference's STACK_DEPTH. The ordered binary
# DFS holds at most depth + 2 entries, the BVH4 walk 3 * wide_depth + 2;
# the wrappers refuse deeper trees, as the reference does (the 1M-triangle
# courtyard at leaf 8 needs 23 and 38). A walk touches only the entries
# its rays push, so the kernels' local frame costs what a tree uses.
STACK_CAP = 160
# The reference's packet size; :func:`raycast` sorts only larger batches,
# as the reference does.
PACKET = 1024
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNEL_SRC = os.path.join(_CSRC, "bvh_traverse.cu")
KERNEL4_SRC = os.path.join(_CSRC, "bvh4_traverse.cu")
COMMON_HDR = os.path.join(_CSRC, "traverse_common.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_ALGOS = {"mt": 0, "watertight": 1}

# Bytes per node of each table kind, as the reference prices them: a BVH4
# node is four child boxes (24 f32, or 12 packed bf16-pair words) and four
# i32 links; a binary node is one box (6 f32) and two links.
WIDE_F32_NODE_BYTES = 24 * 4 + 4 * 4
WIDE_BF16_NODE_BYTES = 12 * 4 + 4 * 4
# Node-table bytes up to which :func:`wide_mode` keeps a table kind. On the
# TPU this was the scalar memory Mosaic could compile (792 KB). On the
# H100 every kind is read from device memory through the 50 MB L2, and the
# budget says how large a node table may grow before the smaller kinds are
# preferred. Measured on an H100 80GB HBM3 at 700 W (PERF.md): the f32
# overlay was the fastest kind on the 242k- and the 1M-triangle
# courtyards (1.9 MB and 8.1 MB of f32 nodes) for camera, random and
# occlusion rays; the bf16 overlay's dilated boxes cost 40-83% more leaf
# tests there and ran 24-97% slower. 16 MiB takes the f32 overlay on both
# and leaves two thirds of L2 to the triangle slots; no larger scene has
# been measured.
NODE_TABLE_BUDGET = 16 << 20
# Shared memory that a block of the paged kernel stages for the resident
# wide nodes [0, S): at most 227 KB on the H100, and above 48 KB only by
# opting in (the wrapper does). Staging more cuts the blocks an SM holds
# at once; on both courtyards 8-16 KB (128-256 bf16 nodes) ran fastest
# and 96 KB up to 2x slower (same card, PERF.md). The budget sets S
# through pack_tables_paged and paged_resident.
PAGED_SMEM_BUDGET = 16 << 10
MAX_BLOCK_SMEM = 227 << 10
# Node-table bytes a block of a traversal kernel may stage in shared
# memory: the H100's per-block maximum. Only the paged tables stage nodes
# (their resident [0, S), sized by PAGED_SMEM_BUDGET); every other kind is
# read from device memory. The reference's 792 KB was the TPU's scalar
# memory, which held its whole node table.
SMEM_NODE_BUDGET = MAX_BLOCK_SMEM


@dataclass
class Tables:
    """The tree as the kernel reads it.

    nodes  : (ni + C, 8) f32 boxes [minx miny minz maxx maxy maxz 0 0]
    links  : (max(ni, 1), 2) i32 child ids (unified id space)
    slots  : (C * leaf_size, 10) f32 leaf slots, one 40-byte row each: the
             corners a, b, c, then the triangle id's i32 bits
    """

    nodes: torch.Tensor
    links: torch.Tensor
    slots: torch.Tensor
    ni: int
    leaf_size: int
    depth: int

    @property
    def tris(self) -> torch.Tensor:
        """(C * leaf_size, 9) f32 corners a, b, c of every leaf slot (a view)."""
        return self.slots[:, :9]

    @property
    def tri_id(self) -> torch.Tensor:
        """(C * leaf_size,) i32 triangle id of every leaf slot (a view)."""
        return self.slots.view(torch.int32)[:, 9]


def pack_tables(bvh, tri_a, tri_b, tri_c) -> Tables:
    """Pack ``bvh`` and the triangle corners (T, 3) for the traversal, on
    the corners' device. Leaf slots repeat the leaf's last triangle, as
    ``leaf_tri`` does."""
    dev = tri_a.device
    nn = bvh.node_min.shape[0]
    nodes = torch.zeros((nn, 8), dtype=torch.float32, device=dev)
    nodes[:, 0:3] = bvh.node_min
    nodes[:, 3:6] = bvh.node_max
    ni = bvh.num_internal
    if ni > 0:
        links = torch.stack([bvh.node_left, bvh.node_right], dim=1).to(torch.int32)
    else:
        links = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    return Tables(nodes=nodes.contiguous(), links=links.contiguous(),
                  slots=_pack_slots(bvh, tri_a, tri_b, tri_c), ni=ni, leaf_size=bvh.leaf_size,
                  depth=bvh.depth)


def _pack_slots(bvh, tri_a, tri_b, tri_c):
    """(C * leaf_size, 10) f32 rows of every leaf slot: its triangle's
    corners and the id's i32 bits. One 40-byte row holds what a slot test
    reads, as five 8-byte loads; the corners are the same floats as the
    reference's ``(C * leaf_size, 10)`` table, whose id column is a float."""
    slot = bvh.leaf_tri.reshape(-1).long()
    ids = slot.to(torch.int32)[:, None].view(torch.float32)
    return torch.cat([tri_a[slot], tri_b[slot], tri_c[slot], ids], dim=1).contiguous()


def _check_stack(tables: Tables) -> int:
    """Stack entries the binary walk of ``tables`` needs (at most STACK_CAP)."""
    if tables.depth + 2 > STACK_CAP:
        raise ValueError(f"BVH depth {tables.depth} needs a {tables.depth + 2}-entry stack; "
                         f"the traversal has {STACK_CAP}. Rebuild with a larger leaf_size.")
    return tables.depth + 2


def _check_rays(o, d, t_max):
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got o {o.dtype}, d {d.dtype}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays must be (N, 3), got o {tuple(o.shape)}, d {tuple(d.shape)}")
    if t_max is not None and (t_max.dtype != torch.float32 or t_max.shape != o.shape[:1]):
        raise ValueError(f"t_max must be float32 (N,), got {t_max.dtype} {tuple(t_max.shape)}")


def _check_start(start, n: int, num_nodes: int, checked: bool = False):
    """Start links: (n,) i32 node ids of the walk's id space (a node, or
    the inner-node count + a leaf id), each in [0, num_nodes). The range
    check reads the minimum and maximum back to the host; ``checked``
    (links the caller built from ids it checked) skips it."""
    if start is None:
        return
    if start.dtype != torch.int32 or start.shape != (n,):
        raise ValueError(f"start must be int32 ({n},), got {start.dtype} {tuple(start.shape)}")
    if n and not checked:
        lo, hi = (int(v) for v in torch.aminmax(start))
        if lo < 0 or hi >= num_nodes:
            raise ValueError(f"start links span [{lo}, {hi}]; the tables hold nodes "
                             f"[0, {num_nodes})")


def _seed_stack(n, start, dev, need: int):
    """Per-ray stacks of the ``need`` entries the tree's walk can hold,
    holding one entry: the root, or the start link."""
    stack = torch.zeros((n, need), dtype=torch.int64, device=dev)
    if start is not None:
        stack[:, 0] = start
    return stack, torch.ones((n,), dtype=torch.int64, device=dev)


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)


def _entry(nodes, child, o, inv, best_t):
    """Entry t into each ray's box ``child``; T_FAR on a miss or when the
    box starts beyond best_t."""
    return _slab(nodes[child], o, inv, best_t)


def _slab(box, o, inv, best_t):
    """Entry t of each ray into its box ``box`` (k, >= 6) [min xyz, max
    xyz]; T_FAR on a miss or when the box starts beyond best_t."""
    t1x = (box[:, 0] - o[:, 0]) * inv[:, 0]
    t2x = (box[:, 3] - o[:, 0]) * inv[:, 0]
    t1y = (box[:, 1] - o[:, 1]) * inv[:, 1]
    t2y = (box[:, 4] - o[:, 1]) * inv[:, 1]
    t1z = (box[:, 2] - o[:, 2]) * inv[:, 2]
    t2z = (box[:, 5] - o[:, 2]) * inv[:, 2]
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < best_t)
    return torch.where(hit, tmin, T_FAR)


def leaf_real_counts(tables):
    """(C,) i64 real triangles of each leaf: its slots up to the first one
    whose id equals the previous slot's. A leaf's slots are its distinct
    triangles followed by repeats of the last one (``leaf_tri``'s
    padding); a repeat gives the same t and id as the slot before it and
    can never win a leaf test."""
    ids = tables.tri_id.reshape(-1, tables.leaf_size)
    return 1 + (ids[:, 1:] != ids[:, :-1]).to(torch.int64).cumprod(dim=1).sum(dim=1)


def _leaf(tables, isect, rays, leaf, o, d, best_t, best_i, any_hit):
    """Dense test of one leaf per ray (``rays`` indexes the batch); updates
    best_t/best_i in place and returns the mask of rays it improved."""
    ls = tables.leaf_size
    slot = leaf[:, None] * ls + torch.arange(ls, device=leaf.device)
    tri = tables.tris[slot]                     # (k, L, 9)
    ro, rd = o[rays], d[rays]
    valid, t = isect(tuple(ro[:, None, k] for k in range(3)),
                     tuple(rd[:, None, k] for k in range(3)),
                     tuple(tri[..., k] for k in range(0, 3)),
                     tuple(tri[..., k] for k in range(3, 6)),
                     tuple(tri[..., k] for k in range(6, 9)))
    t_m = torch.where(valid, t, T_FAR)
    lt = torch.amin(t_m, dim=1)
    ids = tables.tri_id[slot]
    li = torch.amin(torch.where(t_m <= lt[:, None], ids, torch.iinfo(torch.int32).max), dim=1)
    better = lt < best_t[rays]
    win = rays[better]
    best_i[win] = li[better]
    best_t[win] = 0.0 if any_hit else lt[better]
    return better


def raycast_plain(tables: Tables, o, d, t_max=None, any_hit: bool = False, algo: str = "mt",
                  start=None, count: bool = False, visits=None):
    """Plain PyTorch traversal with the kernel's rules and visit order:
    every live ray pops one node per step. ``start``: optional (N,) i32
    start links (an internal id, or ni + leaf id; a single-leaf tree
    ignores them). Returns (best_t, best_i), and with ``count`` also the
    (N, 2) i32 per-ray counts of pops and leaf tests, which the kernel's
    walk shares. ``visits``: optional (ni + C,) i32 tensor to which every
    pop adds 1 at the popped id."""
    _check_rays(o, d, t_max)
    need = _check_stack(tables)
    _check_start(start, o.shape[0], tables.nodes.shape[0])
    isect = leaf_test(algo)
    n = o.shape[0]
    dev = o.device
    with torch.no_grad():
        inv = _inv_dir(d)
        best_t = t_max.clone() if t_max is not None else torch.full((n,), T_FAR, device=dev)
        best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
        counts = torch.zeros((n, 2), dtype=torch.int32, device=dev)
        ni = tables.ni
        if ni == 0:
            zero = torch.zeros((n,), dtype=torch.int64, device=dev)
            _leaf(tables, isect, torch.arange(n, device=dev), zero, o, d, best_t, best_i, any_hit)
            counts[:] = 1
            if visits is not None:
                visits[0] += n
            return (best_t, best_i, counts) if count else (best_t, best_i)
        stack, sp = _seed_stack(n, start, dev, need)
        live = torch.arange(n, device=dev)
        while live.numel() > 0:
            top = sp[live] - 1
            node = stack[live, top]
            sp[live] = top
            counts[live, 0] += 1
            if visits is not None:
                visits.index_add_(0, node, torch.ones_like(node, dtype=visits.dtype))
            is_leaf = node >= ni
            lr = live[is_leaf]
            if lr.numel():
                counts[lr, 1] += 1
                better = _leaf(tables, isect, lr, node[is_leaf] - ni, o, d, best_t, best_i, any_hit)
                if any_hit:  # the kernel stops a ray at its first hit
                    sp[lr[better]] = 0
            ir = live[~is_leaf]
            if ir.numel():
                ch = tables.links[node[~is_leaf]].long()
                l, r = ch[:, 0], ch[:, 1]
                el = _entry(tables.nodes, l, o[ir], inv[ir], best_t[ir])
                er = _entry(tables.nodes, r, o[ir], inv[ir], best_t[ir])
                near = el <= er
                first = torch.where(near, l, r)
                second = torch.where(near, r, l)
                push2 = torch.maximum(el, er) < T_FAR
                push1 = torch.minimum(el, er) < T_FAR
                spi = sp[ir]
                stack[ir[push2], spi[push2]] = second[push2]
                spi = spi + push2
                stack[ir[push1], spi[push1]] = first[push1]
                sp[ir] = spi + push1
            live = live[sp[live] > 0]
    return (best_t, best_i, counts) if count else (best_t, best_i)


# ---------------------------------------------------------------------------
# BVH4 overlay: tables, the reference's choice of table kind, plain walk


@dataclass
class WideTables:
    """The BVH4 overlay as ``csrc/bvh4_traverse.cu`` reads it.

    nodes : resident node boxes, one row per wide node: (R, 24) f32 with
            child c's [minx miny minz maxx maxy maxz] at [6c, 6c + 6)
            (``box_enc="f32"``), or (R, 12) i32 with child c's axis a at
            [3c + a], min in the high half-word rounded toward -inf and max
            in the low half-word rounded toward +inf (``box_enc="bf16"``:
            conservatively dilated boxes). An empty child slot is a point
            box at +inf, which no ray enters.
    links : (R, 4) i32 children: a wide id, or num_wide + leaf id (0 for an
            empty slot)
    pboxes, plinks : paged tables only, the f32 boxes (W - S, 24) and links
            (W - S, 4) of wide nodes S..W-1; None for resident tables
    slots : as :class:`Tables` (with its ``tris`` and ``tri_id`` views)
    s_resident : S, the rows of ``nodes`` (R == S) of paged tables; 0 for
            resident tables (R == W)
    """

    nodes: torch.Tensor
    links: torch.Tensor
    pboxes: torch.Tensor | None
    plinks: torch.Tensor | None
    slots: torch.Tensor
    box_enc: str
    s_resident: int
    num_wide: int
    leaf_size: int
    wide_depth: int

    tris = Tables.tris
    tri_id = Tables.tri_id

    @property
    def mode(self) -> str:
        """``"f32"``, ``"bf16"`` or ``"paged"``: the reference's names."""
        return "paged" if self.s_resident else self.box_enc


def _bf16_down_bits(x):
    """Bit pattern (i32) of the largest bf16 <= x (round toward -inf).
    IEEE 754 is sign-magnitude: dropping mantissa bits rounds toward zero,
    so a negative value with dropped bits steps one bf16 ulp away from 0.
    A subnormal counts as zero and is truncated, as on the reference's
    hardware, which flushes subnormals in the comparison."""
    b = x.contiguous().view(torch.int32)
    trunc = b & ~0xFFFF
    step = (b < 0) & ((b & 0x7F800000) != 0) & ((b & 0xFFFF) != 0)
    return torch.where(step, trunc + 0x10000, trunc)


def _bf16_up_bits(x):
    """Bit pattern (i32) of the smallest bf16 >= x (round toward +inf);
    subnormals truncated as in :func:`_bf16_down_bits`."""
    b = x.contiguous().view(torch.int32)
    trunc = b & ~0xFFFF
    step = (b > 0) & ((b & 0x7F800000) != 0) & ((b & 0xFFFF) != 0)
    return torch.where(step, trunc + 0x10000, trunc)


def _bf16_words(g):
    """Pack (..., 6) f32 boxes into (..., 3) i32 words, one per axis."""
    mn = _bf16_down_bits(g[..., 0:3])
    mx = _bf16_up_bits(g[..., 3:6])
    return (mn & ~0xFFFF) | ((mx >> 16) & 0xFFFF)


def _bf16_boxes(words):
    """Decode (..., 3) i32 words into (..., 6) f32 boxes: min from the high
    half-word, max from the low one shifted up (in int64, then wrapped to
    the i32 bit pattern)."""
    lo = (words & 0xFFFF).to(torch.int64) << 16
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)
    return torch.cat([(words & ~0xFFFF).view(torch.float32), lo.view(torch.float32)], dim=-1)


def _wide_boxes_links(bvh):
    """(W, 4, 6) child boxes (empty slots: +inf point boxes) and (W, 4)
    links of the BVH4 overlay, gathered from the live binary boxes."""
    boxes = torch.cat([bvh.node_min, bvh.node_max], dim=1)
    src = bvh.wide_src.long()
    g = boxes[src.clamp(min=0)]
    g = torch.where((src < 0)[..., None], torch.full_like(g, float("inf")), g)
    return g, bvh.wide_child.clamp(min=0).to(torch.int32)


def _check_wide(bvh):
    if bvh.num_wide <= 0:
        raise ValueError("a single-leaf tree has no BVH4 overlay (wide_mode is None for it); "
                         "use pack_tables")


def _encode(g, box_enc: str):
    """(R, 4, 6) f32 child boxes as table rows: (R, 24) f32 or (R, 12) i32."""
    if box_enc == "f32":
        return g.reshape(-1, 24).contiguous()
    if box_enc == "bf16":
        return _bf16_words(g).reshape(-1, 12).contiguous()
    raise ValueError(f"unknown box encoding {box_enc!r}")


def pack_tables_wide(bvh, tri_a, tri_b, tri_c, box_enc: str = "f32") -> WideTables:
    """Pack the BVH4 overlay with f32 or bf16-pair boxes (the reference's
    words, row by row) on the corners' device."""
    _check_wide(bvh)
    g, links = _wide_boxes_links(bvh)
    nodes = _encode(g, box_enc)
    return WideTables(nodes=nodes, links=links.contiguous(), pboxes=None, plinks=None,
                      slots=_pack_slots(bvh, tri_a, tri_b, tri_c), box_enc=box_enc, s_resident=0,
                      num_wide=bvh.num_wide, leaf_size=bvh.leaf_size,
                      wide_depth=bvh.wide_depth)


def paged_resident(num_wide: int, resident_enc: str = "f32") -> int:
    """Resident wide-node count S of paged tables: as many nodes in
    ``resident_enc`` as a block's :data:`PAGED_SMEM_BUDGET` holds."""
    per_node = WIDE_BF16_NODE_BYTES if resident_enc == "bf16" else WIDE_F32_NODE_BYTES
    return max(1, min(num_wide, PAGED_SMEM_BUDGET // per_node))


def pack_tables_paged(bvh, tri_a, tri_b, tri_c, resident_cap: int | None = None,
                      resident_enc: str = "bf16") -> WideTables:
    """Pack for the paged walk: wide nodes [0, S) resident (staged in each
    block's shared memory) in ``resident_enc``, nodes [S, W) as f32 boxes
    and links read from device memory per visit. S fills
    :data:`PAGED_SMEM_BUDGET`, or is ``resident_cap`` (tests force heavy
    paging with tiny caps).

    The reference's paged rows, ``((W - S) * 28, 128)`` f32, hold the same
    numbers: row ``28p + 6c + f`` is ``pboxes[p, 6c + f]`` and row
    ``28p + 24 + c`` is ``float(plinks[p, c])``, each replicated over the
    128 lanes for the TPU's vector unit. The port keeps one copy, with the
    links as i32."""
    _check_wide(bvh)
    g, links = _wide_boxes_links(bvh)
    w = bvh.num_wide
    s_res = paged_resident(w, resident_enc) if resident_cap is None else \
        max(1, min(w, resident_cap))
    nodes = _encode(g[:s_res], resident_enc)
    return WideTables(nodes=nodes, links=links[:s_res].contiguous(),
                      pboxes=g[s_res:].reshape(-1, 24).contiguous(),
                      plinks=links[s_res:].contiguous(),
                      slots=_pack_slots(bvh, tri_a, tri_b, tri_c), box_enc=resident_enc,
                      s_resident=s_res, num_wide=w, leaf_size=bvh.leaf_size,
                      wide_depth=bvh.wide_depth)


def _binary_bytes(bvh) -> int:
    nn = 2 * bvh.num_leaves - 1 if bvh.num_leaves else 1
    return nn * 6 * 4 + max(bvh.num_internal, 1) * 2 * 4


def wide_mode(bvh):
    """Table kind the traversal takes, in the reference's order of
    preference: the f32 BVH4 overlay when its table fits
    :data:`NODE_TABLE_BUDGET`, else the binary tables (None) when they fit,
    else the bf16 overlay (half the f32 bytes), else ``"paged"``."""
    nw = getattr(bvh, "num_wide", 0)
    if nw <= 0:
        return None
    if nw * WIDE_F32_NODE_BYTES <= NODE_TABLE_BUDGET:
        return "f32"
    if _binary_bytes(bvh) <= NODE_TABLE_BUDGET:
        return None
    if nw * WIDE_BF16_NODE_BYTES <= NODE_TABLE_BUDGET:
        return "bf16"
    return "paged"


def use_wide(bvh) -> bool:
    """Traverse the BVH4 overlay (rather than the binary tree)."""
    return wide_mode(bvh) is not None


def fits_smem(bvh) -> bool:
    """The node bytes a block stages for the tables :func:`pack_tables_auto`
    picks fit :data:`SMEM_NODE_BUDGET`: true for every tree, since the
    paged tables stage at most :data:`PAGED_SMEM_BUDGET` and the other kinds
    stage nothing."""
    if wide_mode(bvh) != "paged":
        return True
    return paged_resident(bvh.num_wide, "bf16") * WIDE_BF16_NODE_BYTES <= SMEM_NODE_BUDGET


def supported(bvh) -> bool:
    """The kernels can walk the whole scene: only the staged node bytes
    gate, as in the reference (the triangle slots live in device memory,
    so the triangle count is unbounded)."""
    return fits_smem(bvh)


def pack_tables_auto(bvh, tri_a, tri_b, tri_c):
    """The tables of the kind :func:`wide_mode` picks."""
    mode = wide_mode(bvh)
    if mode == "paged":
        return pack_tables_paged(bvh, tri_a, tri_b, tri_c)
    if mode is not None:
        return pack_tables_wide(bvh, tri_a, tri_b, tri_c, box_enc=mode)
    return pack_tables(bvh, tri_a, tri_b, tri_c)


def _check_stack4(tables: WideTables) -> int:
    """Stack entries the BVH4 walk of ``tables`` needs (at most STACK_CAP)."""
    need = 3 * tables.wide_depth + 2
    if need > STACK_CAP:
        raise ValueError(f"BVH4 depth {tables.wide_depth} needs a {need}-entry stack; "
                         f"the traversal has {STACK_CAP}. Rebuild with a larger leaf_size.")
    return need


# The reference's 5-exchange sorting network over four (entry, link) pairs
# (decide_push4): swap on strictly smaller entry.
_SORT4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def _wide_f32(tables: WideTables):
    """(W, 4, 6) f32 boxes and (W, 4) links of every wide node, decoded as
    the kernel decodes them."""
    res = tables.nodes.view(-1, 4, 6) if tables.box_enc == "f32" else \
        _bf16_boxes(tables.nodes.view(-1, 4, 3))
    if not tables.s_resident:
        return res, tables.links
    return (torch.cat([res, tables.pboxes.view(-1, 4, 6)]),
            torch.cat([tables.links, tables.plinks]))


def _wide_nodes(tables: WideTables) -> int:
    """Size of the BVH4 walk's id space: wide nodes, then leaves."""
    return tables.num_wide + tables.tri_id.shape[0] // tables.leaf_size


def raycast4_plain(tables: WideTables, o, d, t_max=None, any_hit: bool = False,
                   algo: str = "mt", count: bool = False, start=None, visits=None):
    """Plain PyTorch walk of the BVH4 overlay with the kernel's rules and
    visit order: every live ray pops one entry per step; a wide node tests
    its four child boxes, sorts the hits by entry t with the reference's
    network and pushes them far-first; a leaf is tested at once. ``start``:
    optional (N,) i32 start links (a wide id, or num_wide + leaf id).
    Returns (best_t, best_i), and with ``count`` also the (N, 3) i32
    per-ray counts of pops, leaf tests and paged-node visits (nodes >= S).
    ``visits``: optional (num_wide + C,) i32 tensor to which every pop adds
    1 at the popped id."""
    _check_rays(o, d, t_max)
    need = _check_stack4(tables)
    _check_start(start, o.shape[0], _wide_nodes(tables))
    isect = leaf_test(algo)
    n = o.shape[0]
    dev = o.device
    w = tables.num_wide
    with torch.no_grad():
        boxes, links = _wide_f32(tables)
        inv = _inv_dir(d)
        best_t = t_max.clone() if t_max is not None else torch.full((n,), T_FAR, device=dev)
        best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
        counts = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        stack, sp = _seed_stack(n, start, dev, need)
        live = torch.arange(n, device=dev)
        while live.numel() > 0:
            top = sp[live] - 1
            node = stack[live, top]
            sp[live] = top
            counts[live, 0] += 1
            if visits is not None:
                visits.index_add_(0, node, torch.ones_like(node, dtype=visits.dtype))
            is_leaf = node >= w
            lr = live[is_leaf]
            if lr.numel():
                counts[lr, 1] += 1
                better = _leaf(tables, isect, lr, node[is_leaf] - w, o, d, best_t, best_i, any_hit)
                if any_hit:  # the kernel stops a ray at its first hit
                    sp[lr[better]] = 0
            ir = live[~is_leaf]
            if ir.numel():
                nd = node[~is_leaf]
                if tables.s_resident:
                    counts[ir[nd >= tables.s_resident], 2] += 1
                box = boxes[nd]
                lk = links[nd].long()
                oi, ii, bi = o[ir], inv[ir], best_t[ir]
                e = [_slab(box[:, c], oi, ii, bi) for c in range(4)]
                lc = [lk[:, c] for c in range(4)]
                for i, j in _SORT4:
                    sw = e[j] < e[i]
                    e[i], e[j] = torch.where(sw, e[j], e[i]), torch.where(sw, e[i], e[j])
                    lc[i], lc[j] = torch.where(sw, lc[j], lc[i]), torch.where(sw, lc[i], lc[j])
                spi = sp[ir]
                for k in (3, 2, 1, 0):  # far first; the nearest ends on top
                    push = e[k] < T_FAR
                    stack[ir[push], spi[push]] = lc[k][push]
                    spi = spi + push
                sp[ir] = spi
            live = live[sp[live] > 0]
    return (best_t, best_i, counts) if count else (best_t, best_i)


def count_decode(steps) -> dict:
    """Per-warp aggregates of the (N, 3) per-ray counters of a counted run,
    under the reference's names: ``iters`` = the warp's largest pop count
    (its lockstep length), ``pops``, ``leaves`` and ``paged`` = sums over
    the warp's 32 rays (the last warp padded with zeros). NumPy int64
    arrays, one entry per warp.

    The reference's counters are per 1024-ray packet on the TPU (fill
    iterations of the packet's scalar loop, pops summed over interleaved
    packets); these are per 32-ray warp on the GPU. The units differ, and
    the two are not to be compared."""
    s = steps.detach().to(torch.int64).cpu()
    pad = -s.shape[0] % 32
    s = torch.cat([s, s.new_zeros((pad, 3))]).view(-1, 32, 3)
    return {"iters": s[..., 0].amax(dim=1).numpy(), "pops": s[..., 0].sum(dim=1).numpy(),
            "leaves": s[..., 1].sum(dim=1).numpy(), "paged": s[..., 2].sum(dim=1).numpy()}


@functools.cache
def load_kernel(stack_cap: int = STACK_CAP) -> ctypes.CDLL:
    """Build ``csrc/bvh_traverse.cu`` with a ``stack_cap``-entry stack (once
    per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path(stack_cap))
    p = ctypes.c_void_p
    lib.terra_bvh_raycast.restype = ctypes.c_int
    lib.terra_bvh_raycast.argtypes = [p, p, p, p, p, p, p, ctypes.c_int64] + \
        [ctypes.c_int] * 4 + [p, p, p]
    lib.terra_bvh_query.restype = ctypes.c_int
    lib.terra_bvh_query.argtypes = [ctypes.c_int] * 3 + [p]
    return lib


def _nvcc_cmd(stack_cap: int) -> list:
    return [nvcc(), *NVCC_FLAGS, f"-DTERRA_STACK_CAP={stack_cap}"]


def kernel_path(stack_cap: int = STACK_CAP) -> str:
    """Path of the built binary-tree kernel library (builds it if needed)."""
    return build_shared(_nvcc_cmd(stack_cap), [KERNEL_SRC], "bvh_traverse", deps=[COMMON_HDR])


@functools.cache
def load_kernel4(stack_cap: int = STACK_CAP) -> ctypes.CDLL:
    """Build ``csrc/bvh4_traverse.cu`` with a ``stack_cap``-entry stack (once
    per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel4_path(stack_cap))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.terra_bvh4_raycast.restype = ctypes.c_int
    lib.terra_bvh4_raycast.argtypes = [p] * 9 + [ctypes.c_int64] + [i] * 6 + [p] * 4
    lib.terra_bvh4_query.restype = ctypes.c_int
    lib.terra_bvh4_query.argtypes = [i] * 6 + [p]
    return lib


def kernel4_path(stack_cap: int = STACK_CAP) -> str:
    """Path of the built BVH4 kernel library (builds it if needed)."""
    return build_shared(_nvcc_cmd(stack_cap), [KERNEL4_SRC], "bvh4_traverse", deps=[COMMON_HDR])


def _check_cuda(ins, name):
    dev = ins[0].device
    for x in ins:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} needs every tensor on one CUDA device; got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
    return dev


def _ptr(x):
    """Device pointer of an optional tensor (None when absent or empty)."""
    return x.data_ptr() if x is not None and x.numel() else None


def raycast_cuda(tables: Tables, o, d, t_max=None, any_hit: bool = False, algo: str = "mt",
                 start=None):
    """Launch the CUDA kernel on the current stream. Every tensor must be
    contiguous and on the same CUDA device; ``start`` as for
    :func:`raycast_plain`. Returns (best_t, best_i)."""
    _check_rays(o, d, t_max)
    if algo not in _ALGOS:
        raise ValueError(f"unknown intersector {algo!r}")
    ins = [o, d, tables.nodes, tables.links, tables.slots]
    ins += [x for x in (t_max, start) if x is not None]
    dev = _check_cuda(ins, "raycast_cuda")
    _check_stack(tables)
    _check_start(start, o.shape[0], tables.nodes.shape[0])
    lib = load_kernel()
    n = o.shape[0]
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_i = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.terra_bvh_raycast(
        o.data_ptr(), d.data_ptr(), _ptr(t_max), _ptr(start), tables.nodes.data_ptr(),
        tables.links.data_ptr(), tables.slots.data_ptr(), n, tables.ni, tables.leaf_size,
        _ALGOS[algo], int(any_hit), best_t.data_ptr(), best_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {rc}")
    kernel_launches["binary"] += 1
    return best_t, best_i


def raycast4_cuda(tables: WideTables, o, d, t_max=None, any_hit: bool = False,
                  algo: str = "mt", count: bool = False, start=None,
                  start_checked: bool = False):
    """Launch the BVH4 CUDA kernel on the current stream. Every tensor must
    be contiguous and on the same CUDA device; ``start`` as for
    :func:`raycast4_plain`. ``start_checked``: the caller built ``start``
    from node ids it checked, so the launch reads nothing back to the host
    and can be captured in a CUDA graph. Returns (best_t, best_i), and
    with ``count`` also the (N, 3) i32 per-ray counters."""
    _check_rays(o, d, t_max)
    if algo not in _ALGOS:
        raise ValueError(f"unknown intersector {algo!r}")
    ins = [o, d, tables.nodes, tables.links, tables.slots]
    if tables.s_resident:
        ins += [tables.pboxes, tables.plinks]
    ins += [x for x in (t_max, start) if x is not None]
    dev = _check_cuda(ins, "raycast4_cuda")
    _check_stack4(tables)
    _check_start(start, o.shape[0], _wide_nodes(tables), start_checked)
    per_node = WIDE_BF16_NODE_BYTES if tables.box_enc == "bf16" else WIDE_F32_NODE_BYTES
    if tables.s_resident * per_node > MAX_BLOCK_SMEM:
        raise ValueError(f"{tables.s_resident} resident nodes need "
                         f"{tables.s_resident * per_node} B of shared memory; a block has "
                         f"{MAX_BLOCK_SMEM}")
    lib = load_kernel4()
    n = o.shape[0]
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_i = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = torch.empty((n, 3), dtype=torch.int32, device=dev) if count else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.terra_bvh4_raycast(
        o.data_ptr(), d.data_ptr(), _ptr(t_max), _ptr(start), tables.nodes.data_ptr(),
        tables.links.data_ptr(), _ptr(tables.pboxes), _ptr(tables.plinks),
        tables.slots.data_ptr(), n, tables.num_wide, tables.s_resident, tables.leaf_size,
        int(tables.box_enc == "bf16"), _ALGOS[algo],
        int(any_hit), best_t.data_ptr(), best_i.data_ptr(), _ptr(counts), stream)
    if rc != 0:
        raise RuntimeError(f"bvh4_traverse launch failed: cudaError {rc}")
    kernel_launches["bvh4"] += 1
    return (best_t, best_i, counts) if count else (best_t, best_i)


def occupancy(tables, has_tmax: bool = False, any_hit: bool = False, algo: str = "mt",
              count: bool = False) -> tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of the kernel
    instance that would walk ``tables`` with these options, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current device.
    Launches nothing."""
    out = (ctypes.c_int * 2)()
    if isinstance(tables, WideTables):
        rc = load_kernel4().terra_bvh4_query(
            int(has_tmax), int(any_hit), int(tables.box_enc == "bf16"), tables.s_resident,
            int(count), _ALGOS[algo], out)
    else:
        rc = load_kernel().terra_bvh_query(int(has_tmax), int(any_hit), _ALGOS[algo], out)
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {rc}")
    return out[0], out[1]


def traverse_packed(tables, o, d, t_max=None, any_hit: bool = False, algo: str = "mt",
                    count_steps: bool = False, start=None, start_checked: bool = False):
    """Bench entry: walk pre-packed tables of any kind on (N, 3) rays in
    the order given, the plain version for CPU tensors and the kernel for
    CUDA tensors. ``start``: optional (N,) i32 start links in the tables'
    id space (``start_checked`` as for :func:`raycast4_cuda`, BVH4 tables
    only). Returns (best_t, best_i), and with ``count_steps`` (BVH4
    tables only) also the per-ray counters for :func:`count_decode`. The
    tables carry their own kind, so the reference's ``bvh`` and ``mode``
    arguments have no counterpart."""
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no traversal for device {o.device}")
    cpu = o.device.type == "cpu"
    if isinstance(tables, WideTables):
        if cpu:
            return raycast4_plain(tables, o, d, t_max, any_hit, algo, count=count_steps,
                                  start=start)
        return raycast4_cuda(tables, o, d, t_max, any_hit, algo, count=count_steps, start=start,
                             start_checked=start_checked)
    if count_steps:
        raise ValueError("step counters are kept by the BVH4 walk only")
    fn = raycast_plain if cpu else raycast_cuda
    return fn(tables, o, d, t_max, any_hit, algo, start=start)


def _unsort(order, x):
    """``x`` (in sorted order) scattered back through the permutation."""
    out = torch.empty_like(x)
    out[order] = x
    return out


def raycast(scene, o, d, t_max=None, any_hit: bool = False, sort_hint=None,
            algo: str = "mt", tables=None, sort_rays: bool = True, sort_mode: str = "octant",
            leaf_of_tri=None) -> RayHit:
    """Closest hit (or, with ``t_max``, occlusion within t_max) through the
    BVH: the tables ``tables`` (default: :func:`pack_tables_auto` of the
    scene) by their kind, CPU tensors by the plain version and CUDA tensors
    by the kernel.

    With ``sort_rays``, a batch of more than :data:`PACKET` rays is walked
    in the order of the reference's coherence keys and its results are
    scattered back, so no per-ray result changes: parent-hit keys
    (``traverse.hinted_keys``) when both ``sort_hint`` (the parent hit's
    triangle per ray, -1 for none) and ``leaf_of_tri``
    (``traverse.leaf_of_tri_table``) are given, else ``sort_mode``'s keys
    over the root box (``"octant"``, ``"dir2"``, ``"dir3"``, ``"treelet"``)."""
    if tables is None:
        tables = pack_tables_auto(scene.bvh, *scene.geometry.corners())
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    tm = t_max = None if t_max is None else t_max.detach().contiguous()
    order = None
    if sort_rays and o.shape[0] > PACKET:
        order = sort_order(scene.bvh, o, d, sort_mode, sort_hint, leaf_of_tri)
        o, d = o[order], d[order]
        if tm is not None:
            tm = tm[order]
    best_t, best_i = traverse_packed(tables, o, d, tm, any_hit, algo)
    if order is not None:
        best_t, best_i = _unsort(order, best_t), _unsort(order, best_i)
    hit = best_t < (T_FAR if t_max is None else t_max)
    return RayHit(t=best_t, tri=torch.where(hit, best_i, 0), hit=hit)
