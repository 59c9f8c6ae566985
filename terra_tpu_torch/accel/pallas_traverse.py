"""BVH traversal: the hand-written CUDA kernel and its plain PyTorch version.

The module keeps the path of ``terra_tpu/accel/pallas_traverse.py``, whose
Pallas kernel it replaces; there is no Pallas here. It holds

  * :func:`pack_tables` — the binary tree and the leaf-ordered triangles in
    the layout the kernel reads;
  * :func:`raycast_plain` — a vectorised stack traversal in PyTorch with
    the kernel's rules, popping the same nodes in the same order for every
    ray, on any device;
  * :func:`raycast_cuda` — checks its inputs and launches
    ``csrc/bvh_traverse.cu`` (built with nvcc for sm_90a at first use);
  * :func:`raycast` — dispatches on the tensors' device (CPU tensors take
    the plain version, CUDA tensors the kernel; there is no fallback) and
    applies the reference's epilogue.

Outputs carry no gradient, as the reference stops gradients at the hit.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
from dataclasses import dataclass

import torch

from .._build import build_shared
from ..intersect import RayHit, T_FAR, leaf_test

__all__ = ["Tables", "pack_tables", "raycast", "raycast_plain", "raycast_cuda",
           "load_kernel", "launches", "STACK_CAP"]

# Per-thread stack entries. The ordered binary DFS holds at most depth + 2
# entries; the wrapper refuses deeper trees (the 242k-triangle courtyard
# at leaf 8 needs far fewer).
STACK_CAP = 64
KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "csrc", "bvh_traverse.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DTERRA_STACK_CAP={STACK_CAP}"]
_ALGOS = {"mt": 0, "watertight": 1}

# Number of kernel launches made through raycast_cuda.
launches = 0


@dataclass
class Tables:
    """The tree as the kernel reads it.

    nodes  : (ni + C, 8) f32 boxes [minx miny minz maxx maxy maxz 0 0]
    links  : (max(ni, 1), 2) i32 child ids (unified id space)
    tris   : (C * leaf_size, 9) f32 corners a, b, c of every leaf slot
    tri_id : (C * leaf_size,) i32 triangle id of every leaf slot
    """

    nodes: torch.Tensor
    links: torch.Tensor
    tris: torch.Tensor
    tri_id: torch.Tensor
    ni: int
    leaf_size: int
    depth: int


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
    slot = bvh.leaf_tri.reshape(-1).long()
    tris = torch.cat([tri_a[slot], tri_b[slot], tri_c[slot]], dim=1)
    return Tables(nodes=nodes.contiguous(), links=links.contiguous(), tris=tris.contiguous(),
                  tri_id=slot.to(torch.int32).contiguous(), ni=ni,
                  leaf_size=bvh.leaf_size, depth=bvh.depth)


def _check_stack(tables: Tables):
    if tables.depth + 2 > STACK_CAP:
        raise ValueError(f"BVH depth {tables.depth} needs a {tables.depth + 2}-entry stack; "
                         f"the traversal has {STACK_CAP}. Rebuild with a larger leaf_size.")


def _check_rays(o, d, t_max):
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got o {o.dtype}, d {d.dtype}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays must be (N, 3), got o {tuple(o.shape)}, d {tuple(d.shape)}")
    if t_max is not None and (t_max.dtype != torch.float32 or t_max.shape != o.shape[:1]):
        raise ValueError(f"t_max must be float32 (N,), got {t_max.dtype} {tuple(t_max.shape)}")


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-12, 1.0 / d, 1e12)


def _entry(nodes, child, o, inv, best_t):
    """Entry t into each ray's box ``child``; T_FAR on a miss or when the
    box starts beyond best_t."""
    box = nodes[child]
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


def raycast_plain(tables: Tables, o, d, t_max=None, any_hit: bool = False, algo: str = "mt"):
    """Plain PyTorch traversal with the kernel's rules and visit order:
    every live ray pops one node per step. Returns (best_t, best_i)."""
    _check_rays(o, d, t_max)
    _check_stack(tables)
    isect = leaf_test(algo)
    n = o.shape[0]
    dev = o.device
    with torch.no_grad():
        inv = _inv_dir(d)
        best_t = t_max.clone() if t_max is not None else torch.full((n,), T_FAR, device=dev)
        best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
        ni = tables.ni
        if ni == 0:
            zero = torch.zeros((n,), dtype=torch.int64, device=dev)
            _leaf(tables, isect, torch.arange(n, device=dev), zero, o, d, best_t, best_i, any_hit)
            return best_t, best_i
        stack = torch.zeros((n, STACK_CAP), dtype=torch.int64, device=dev)
        sp = torch.ones((n,), dtype=torch.int64, device=dev)
        live = torch.arange(n, device=dev)
        while live.numel() > 0:
            top = sp[live] - 1
            node = stack[live, top]
            sp[live] = top
            is_leaf = node >= ni
            lr = live[is_leaf]
            if lr.numel():
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
    return best_t, best_i


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/bvh_traverse.cu`` (once per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path())
    p = ctypes.c_void_p
    lib.terra_bvh_raycast.restype = ctypes.c_int
    lib.terra_bvh_raycast.argtypes = [p, p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p]
    return lib


def kernel_path() -> str:
    """Path of the built kernel library (builds it if needed)."""
    return build_shared([_nvcc(), *NVCC_FLAGS], [KERNEL_SRC], "bvh_traverse")


def raycast_cuda(tables: Tables, o, d, t_max=None, any_hit: bool = False, algo: str = "mt"):
    """Launch the CUDA kernel on the current stream. Every tensor must be
    contiguous and on the same CUDA device. Returns (best_t, best_i)."""
    global launches
    _check_rays(o, d, t_max)
    if algo not in _ALGOS:
        raise ValueError(f"unknown intersector {algo!r}")
    ins = [o, d, tables.nodes, tables.links, tables.tris, tables.tri_id]
    if t_max is not None:
        ins.append(t_max)
    dev = o.device
    for x in ins:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"raycast_cuda needs every tensor on one CUDA device; got {x.device}")
        if not x.is_contiguous():
            raise ValueError("raycast_cuda needs contiguous tensors")
    _check_stack(tables)
    lib = load_kernel()
    n = o.shape[0]
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_i = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.terra_bvh_raycast(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr() if t_max is not None else None,
        tables.nodes.data_ptr(), tables.links.data_ptr(), tables.tris.data_ptr(),
        tables.tri_id.data_ptr(), n, tables.ni, tables.leaf_size, _ALGOS[algo],
        int(any_hit), best_t.data_ptr(), best_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {rc}")
    launches += 1
    return best_t, best_i


def raycast(scene, o, d, t_max=None, any_hit: bool = False, sort_hint=None,
            algo: str = "mt", tables: Tables | None = None) -> RayHit:
    """Closest hit (or, with ``t_max``, occlusion within t_max) through the
    BVH. CPU tensors take :func:`raycast_plain`, CUDA tensors
    :func:`raycast_cuda`. ``sort_hint`` (the parent hit's triangle per ray)
    is accepted for the reference's signature and unused until the kernel
    sorts rays. ``tables`` skips re-packing."""
    del sort_hint
    if tables is None:
        tables = pack_tables(scene.bvh, *scene.geometry.corners())
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    if t_max is not None:
        t_max = t_max.detach().contiguous()
    if o.device.type == "cpu":
        best_t, best_i = raycast_plain(tables, o, d, t_max, any_hit, algo)
    elif o.device.type == "cuda":
        best_t, best_i = raycast_cuda(tables, o, d, t_max, any_hit, algo)
    else:
        raise ValueError(f"no traversal for device {o.device}")
    hit = best_t < (T_FAR if t_max is None else t_max)
    return RayHit(t=best_t, tri=torch.where(hit, best_i, 0), hit=hit)
