"""Ray/triangle intersection, wavefront-wide (port of ``terra_tpu/intersect.py``).

The leaf tests (Moller-Trumbore and the Wald2013-style watertight test)
work on component tuples so the same functions serve the dense brute-force
sweep and the plain BVH traversal; the CUDA kernels (the traversal and
``csrc/sweep.cu``) repeat their arithmetic in the same order. Raycasts
return discrete ids and distances without gradients; ``surface.py``
recomputes the continuous hit.

The brute-force raycast of the render is :func:`raycast_sweep`: CPU
tensors take the plain grid :func:`raycast_brute`, CUDA tensors the sweep
kernel (one launch, counted as ``sweep`` in ``profile.kernel_launches``),
which gives the same words.
"""
from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch

from ._build import build_shared
from .ops import math3
from .profile import kernel_launches

__all__ = [
    "RayHit", "mask_dead_rays", "ray_aabb", "moller_trumbore", "mt_components",
    "watertight_components", "mt_grid_components", "raycast_brute", "raycast_sweep",
    "pack_sweep", "load_kernel", "RAY_OFFSET_DIR", "SURFACE_OFFSET_NORMAL", "T_FAR",
    "MISS_ORIGIN",
]

RAY_OFFSET_DIR = 1e-3        # origin nudge along the direction
SURFACE_OFFSET_NORMAL = 1e-4  # origin offset along the normal
T_FAR = 3.4e38
# Origin of the canonical ray of a terminated lane: far outside any scene.
MISS_ORIGIN = 3.0e5
KERNEL_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "sweep.cu")
_ALGOS = {"mt": 0, "watertight": 1}


@dataclass
class RayHit:
    """t (N,) f32 hit distance (T_FAR on a miss); tri (N,) i32 triangle
    (0 on a miss); hit (N,) bool."""

    t: torch.Tensor
    tri: torch.Tensor
    hit: torch.Tensor


def mask_dead_rays(active, o, d):
    """Replace rays of inactive lanes with the canonical miss ray."""
    live = active[..., None]
    o_q = torch.where(live, o, MISS_ORIGIN)
    # (1, 0, 0) made on the device: no host copy inside a captured graph
    d_q = torch.where(live, d, torch.eye(1, 3, dtype=o.dtype, device=o.device))
    return o_q, d_q


def ray_aabb(o, inv_d, box_min, box_max):
    """Branchless slab test; all arguments broadcastable (..., 3). Returns
    (hit, tmin, tmax). ``>=`` keeps perfectly flat boxes (tmin == tmax for
    every ray through them), as the reference does."""
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tmax >= torch.clamp(tmin, min=0.0), tmin, tmax


def moller_trumbore(o, d, a, b, c, eps: float = 1e-4):
    """Moller-Trumbore on (..., 3) rays against broadcastable (..., 3)
    triangles. Returns (valid, t, u, v): ``valid`` needs |det| > eps, the
    barycentrics inside and t > eps (no self-hit at the origin)."""
    e1 = b - a
    e2 = c - a
    h = math3.cross(d, e2)
    det = math3.dot(e1, h)
    valid = torch.abs(det) > eps
    f = torch.where(valid, torch.reciprocal(torch.where(valid, det, 1.0)), 0.0)
    s = o - a
    u = f * math3.dot(s, h)
    q = math3.cross(s, e1)
    v = f * math3.dot(d, q)
    t = f * math3.dot(e2, q)
    valid = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return valid, t, u, v


def mt_components(oc, dc, ac, bc, cc, eps: float = 1e-4):
    """Moller-Trumbore on (x, y, z) tuples of broadcastable tensors.
    Returns (valid, t)."""
    ox, oy, oz = oc
    dx, dy, dz = dc
    ax, ay, az = ac
    bx, by, bz = bc
    cx, cy, cz = cc
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    ok_det = torch.abs(det) > eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return valid, t


def watertight_components(oc, dc, ac, bc, cc, eps: float = 1e-4):
    """Wald2013-style watertight test on component tuples: shear to the
    ray's dominant axis, sign-consistent scaled barycentrics (a hit iff no
    two of U, V, W carry opposite signs), products that cancel to within a
    few ulps snapped to 0. Returns (valid, t)."""
    ox, oy, oz = oc
    dx, dy, dz = dc
    adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    m0 = (adx >= ady) & (adx >= adz)
    m1 = (~m0) & (ady >= adz)

    def perm(vx, vy, vz):
        pz = torch.where(m0, vx, torch.where(m1, vy, vz))
        px = torch.where(m0, vy, torch.where(m1, vz, vx))
        py = torch.where(m0, vz, torch.where(m1, vx, vy))
        return px, py, pz

    dpx, dpy, dpz = perm(dx, dy, dz)
    swap = dpz < 0.0
    dpx, dpy = torch.where(swap, dpy, dpx), torch.where(swap, dpx, dpy)
    sz = 1.0 / torch.where(dpz != 0.0, dpz, 1.0)
    sx = dpx * sz
    sy = dpy * sz

    def shear(vx, vy, vz):
        px, py, pz = perm(vx - ox, vy - oy, vz - oz)
        px, py = torch.where(swap, py, px), torch.where(swap, px, py)
        return px - sx * pz, py - sy * pz, pz

    def dop(p1, p2, q1, q2):
        p = p1 * p2
        q = q1 * q2
        r = p - q
        snap = torch.abs(r) <= torch.maximum(torch.abs(p), torch.abs(q)) * 4e-7
        return torch.where(snap, 0.0, r)

    axp, ayp, azp = shear(*ac)
    bxp, byp, bzp = shear(*bc)
    cxp, cyp, czp = shear(*cc)
    u = dop(cxp, byp, cyp, bxp)
    v = dop(axp, cyp, ayp, cxp)
    w = dop(bxp, ayp, byp, axp)
    any_neg = (u < 0.0) | (v < 0.0) | (w < 0.0)
    any_pos = (u > 0.0) | (v > 0.0) | (w > 0.0)
    det = u + v + w
    t_scaled = (u * azp + v * bzp + w * czp) * sz
    t = t_scaled / torch.where(det != 0.0, det, 1.0)
    valid = ~(any_neg & any_pos) & (det != 0.0) & (t > eps)
    return valid, t


def leaf_test(algo: str):
    if algo == "mt":
        return mt_components
    if algo == "watertight":
        return watertight_components
    raise ValueError(f"unknown intersector {algo!r}")


def _comps(v, ray_axis: bool):
    """(..., 3) split into broadcastable component tuples: rays get a
    trailing singleton triangle axis, triangles a leading singleton ray
    axis."""
    if ray_axis:
        return tuple(v[..., :, None, k] for k in range(3))
    return tuple(v[..., None, :, k] for k in range(3))


def mt_grid_components(o, d, tri_a, tri_b, tri_c, eps: float = 1e-4, algo: str = "mt"):
    """Dense (rays x triangles) intersection grid: o, d (..., N, 3) against
    tri_* (..., TB, 3) gives (valid, t) of shape (..., N, TB), by the
    intersector ``algo`` ("mt" or "watertight")."""
    return leaf_test(algo)(_comps(o, True), _comps(d, True), _comps(tri_a, False),
                           _comps(tri_b, False), _comps(tri_c, False), eps)


def _closest_hit_block(o, d, tri_a, tri_b, tri_c, base_idx, algo: str = "mt"):
    """Dense (N, TB) test of rays against one triangle block; returns each
    ray's (best t, ``base_idx`` + the first index at that t), T_FAR where
    nothing is hit."""
    valid, t = mt_grid_components(o, d, tri_a, tri_b, tri_c, algo=algo)
    best_t, best = torch.min(torch.where(valid, t, T_FAR), dim=1)
    return best_t, base_idx + best.to(torch.int32)


def raycast_brute(o, d, tri_a, tri_b, tri_c, ray_chunk: int = 0, tri_block: int = 1024,
                  algo: str = "mt", max_pairs: int = 1 << 24) -> RayHit:
    """Closest hit over all triangles by a dense (rays x triangle-block)
    sweep in chunks of ``ray_chunk`` rays (0: as many as keep one block at
    most ``max_pairs`` ray-triangle pairs). Equal t within a block goes to
    the lowest id; no result depends on the chunking."""
    leaf_test(algo)  # an unknown intersector raises, even with nothing to test
    n = o.shape[0]
    t_count = tri_a.shape[0]
    tri_block = max(min(tri_block, t_count), 1)
    if ray_chunk <= 0:
        ray_chunk = max_pairs // tri_block
    ray_chunk = max(min(n, ray_chunk), 1)
    best_t = torch.full((n,), T_FAR, dtype=torch.float32, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=o.device)
    with torch.no_grad():
        for r0 in range(0, n, ray_chunk):
            co, cd = o[r0:r0 + ray_chunk], d[r0:r0 + ray_chunk]
            bt = best_t[r0:r0 + ray_chunk]
            bi = best_i[r0:r0 + ray_chunk]
            for b0 in range(0, t_count, tri_block):
                sl = slice(b0, b0 + tri_block)
                t_blk, i_blk = _closest_hit_block(co, cd, tri_a[sl], tri_b[sl], tri_c[sl], b0,
                                                  algo)
                take = t_blk < bt
                bt = torch.where(take, t_blk, bt)
                bi = torch.where(take, i_blk, bi)
            best_t[r0:r0 + ray_chunk] = bt
            best_i[r0:r0 + ray_chunk] = bi
    hit = best_t < T_FAR
    return RayHit(t=best_t, tri=torch.where(hit, best_i, 0), hit=hit)


def pack_sweep(tri_a, tri_b, tri_c):
    """(T, 10) f32 rows of the triangles in id order, as the sweep kernel
    stages them: the corners a, b, c and the id's i32 bits (the traversal
    kernels' 40-byte slot row, ``pallas_traverse._pack_slots``). Pack once
    and pass to :func:`raycast_sweep` as ``slots``."""
    ids = torch.arange(tri_a.shape[0], dtype=torch.int32, device=tri_a.device)
    return torch.cat([tri_a.detach(), tri_b.detach(), tri_c.detach(),
                      ids[:, None].view(torch.float32)], dim=1).contiguous()


def kernel_path() -> str:
    """Path of the built sweep kernel library (builds it if needed), with
    the traversal kernels' command: the leaf tests are theirs."""
    from .accel import pallas_traverse as pt

    return build_shared(pt._nvcc_cmd(pt.STACK_CAP), [KERNEL_SRC], "sweep",
                        deps=[pt.COMMON_HDR])


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/sweep.cu`` (once per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.terra_sweep.restype = ctypes.c_int
    lib.terra_sweep.argtypes = [p, p, p, p, i64, i64, ctypes.c_int, p, p, p, p]
    return lib


def _sweep_cuda(o, d, t_max, slots, algo: str) -> RayHit:
    """One launch of the sweep kernel on the current stream. Checks dtypes,
    shapes and devices and allocates the outputs; it reads nothing back, so
    a CUDA graph can capture it."""
    n = o.shape[0]
    want = {"o": (o, (n, 3)), "d": (d, (n, 3)), "slots": (slots, (slots.shape[0], 10))}
    if t_max is not None:
        want["t_max"] = (t_max, (n,))
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"the sweep kernel takes a float32 {name} of shape {shape}; got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"the sweep kernel takes every tensor on the rays' device "
                             f"{o.device}; {name} is on {x.device}")
    if not slots.is_contiguous():
        raise ValueError("the sweep kernel takes contiguous slots (pack_sweep)")
    if not o.is_cuda:
        raise ValueError(f"the sweep kernel takes CUDA tensors; got rays on {o.device}")
    o, d = o.detach().contiguous(), d.detach().contiguous()
    if t_max is not None:
        t_max = t_max.detach().contiguous()
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    hit = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n:
        rc = load_kernel().terra_sweep(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr() if t_max is not None else None,
            slots.data_ptr(), n, slots.shape[0], _ALGOS[algo], best_t.data_ptr(),
            tri.data_ptr(), hit.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sweep launch failed: cudaError {rc}")
        kernel_launches["sweep"] += 1
    return RayHit(t=best_t, tri=tri, hit=hit)


def raycast_sweep(o, d, tri_a, tri_b, tri_c, t_max=None, algo: str = "mt",
                  slots=None) -> RayHit:
    """Closest hit of each ray (o, d: (N, 3)) over every triangle, the lowest
    id winning at equal t. With ``t_max`` (N,) it is the ranged occlusion
    query: ``hit`` means t < t_max and ``tri`` is 0 where it does not, ``t``
    still the closest hit's. CPU rays take the plain grid
    :func:`raycast_brute`; rays on another device launch the sweep kernel
    (``csrc/sweep.cu``; it replaces no Pallas kernel, the reference's sweep
    being jnp) on ``slots`` (:func:`pack_sweep` of the corners, packed here
    when not given), or raise: nothing falls back to the grid. Both give the
    same words; neither carries a gradient."""
    leaf_test(algo)  # an unknown intersector raises, on every device
    if o.device.type != "cpu":
        if slots is None:
            slots = pack_sweep(tri_a, tri_b, tri_c)
        return _sweep_cuda(o, d, t_max, slots, algo)
    h = raycast_brute(o, d, tri_a, tri_b, tri_c, algo=algo)
    if t_max is None:
        return h
    occ = h.t < t_max
    return RayHit(t=h.t, tri=torch.where(occ, h.tri, 0), hit=occ)
