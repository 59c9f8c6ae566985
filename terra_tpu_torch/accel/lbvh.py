"""Host-side BVH builds, the trees the traversal kernels walk, and refit.

Port of ``terra_tpu/accel/lbvh.py``: the flat SoA tree in the unified id
space (internal nodes ``0..C-2``, leaf ``k`` at ``C-1+k``), built by the
native binned-SAH builder (``builder="sah"``, the default) or the native
Morton LBVH (``builder="lbvh"``), its depth, the preorder threads of the
stackless walk, the BVH4 overlay that the wide traversal walks
(:func:`_collapse4`, identical to the reference's for the same binary
tree), and :func:`refit`, which recomputes the boxes for moved vertices on
a fixed topology. The NumPy LBVH (:func:`_build_numpy`) is the reference's
fallback builder; the port reaches it only by name, to hold the native
builder to it. The JAX package grows leaves until its node table fits the
TPU's scalar memory; that budget means nothing on a GPU, so the port takes
a fixed ``DEFAULT_LEAF_SIZE``.

The refit follows the positions' device. CPU positions take
:func:`_refit_host`, the reference's NumPy refit. CUDA positions launch
the hand-written kernel ``csrc/bvh_refit.cu`` (built at the first CUDA
refit, two launches a refit, counted as ``"bvh_refit"`` in
``profile.kernel_launches``; it replaces no Pallas kernel, as the
reference refits on the host), which writes the same values into the
tree's boxes on the card and reads nothing back. A CUDA call the kernel
does not take raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .._build import build_shared, nvcc
from ..ops.rng import NVCC_FLAGS
from ..profile import kernel_launches, profiler

__all__ = ["LBVH", "build", "refit", "refit_", "DEFAULT_LEAF_SIZE", "load_kernel",
           "kernel_path"]

# Leaves hold [4, 8] triangles (the SAH builder pads a leaf of n >= L/2
# triangles to L by repetition). One thread tests a whole leaf, so small
# leaves trade fewer wasted triangle tests for more node visits; 8 keeps
# the 242k-triangle courtyard's tables at 10 MiB of triangle slots and
# 2 MiB of nodes, both well inside the H100's 50 MB L2.
DEFAULT_LEAF_SIZE = 8
_BUILDERS = {"sah": native.sah_build, "lbvh": native.lbvh_build}
KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                          "bvh_refit.cu")


@dataclass
class LBVH:
    """Flat SoA tree.

    node_min/max : (ni + C, 3) f32 boxes, internal rows then leaf rows
    node_left/right : (ni,) i32 child ids in the unified id space
    leaf_tri : (C, leaf_size) i32 triangle ids per leaf, padded by repetition
    tri_order : (T,) i32 the builder's triangle permutation
    dfs_next : (ni + C,) i32 preorder successor when descending into a node
    dfs_skip : (ni + C,) i32 preorder successor past the node's subtree (-1 at the end)
    wide_child : (W, 4) i32 BVH4 overlay: wide node w's children, each a
                 wide id < W, or W + leaf_id, or -1 for an empty slot
    wide_src : (W, 4) i32 the binary node bounding each wide child (-1 empty);
               child boxes are gathered from node_min/max at pack time, so
               :func:`refit` keeps the overlay valid
    leaf_size, num_leaves, depth : static (depth counts root..leaf levels)
    num_wide, wide_depth : static W and the overlay's root..leaf level count
    """

    node_min: torch.Tensor
    node_max: torch.Tensor
    node_left: torch.Tensor
    node_right: torch.Tensor
    leaf_tri: torch.Tensor
    tri_order: torch.Tensor
    dfs_next: torch.Tensor
    dfs_skip: torch.Tensor
    wide_child: torch.Tensor
    wide_src: torch.Tensor
    leaf_size: int
    num_leaves: int
    depth: int
    num_wide: int
    wide_depth: int

    @property
    def num_internal(self) -> int:
        return self.node_left.shape[0]


def _host(geometry):
    return (geometry.positions.detach().cpu().numpy(),
            geometry.tri_vidx.detach().cpu().numpy())


def _lbvh(arrays: dict, leaf_size: int, device) -> LBVH:
    """The tree of a builder's arrays, with its overlay and depth, on ``device``."""
    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    left, right = arrays["left"], arrays["right"]
    wc, ws, nw, wd = _collapse4(left, right, arrays["box_min"], arrays["box_max"])
    return LBVH(
        node_min=dev(arrays["box_min"]), node_max=dev(arrays["box_max"]),
        node_left=dev(left), node_right=dev(right),
        leaf_tri=dev(arrays["leaf_tri"]), tri_order=dev(arrays["tri_order"]),
        dfs_next=dev(arrays["dfs_next"]), dfs_skip=dev(arrays["dfs_skip"]),
        wide_child=dev(wc), wide_src=dev(ws),
        leaf_size=leaf_size, num_leaves=int(arrays["num_leaves"]),
        depth=_tree_depth(left, right), num_wide=nw, wide_depth=wd,
    )


def build(geometry, leaf_size: int | None = None, builder: str = "sah") -> LBVH:
    """Native build from a Geometry; tensors land on the geometry's device.

    ``builder``: "sah" — binned SAH, 16 bins x 3 axes (leaves hold
    [leaf_size/2, leaf_size] triangles, padded by repetition); "lbvh" —
    Morton cluster LBVH (a faster build, for rebuilds of moving geometry)."""
    if builder not in _BUILDERS:
        raise ValueError(f"unknown BVH builder {builder!r}; expected one of {sorted(_BUILDERS)}")
    leaf_size = DEFAULT_LEAF_SIZE if leaf_size is None else int(leaf_size)
    pos, vidx = _host(geometry)
    return _lbvh(_BUILDERS[builder](pos, vidx, leaf_size), leaf_size, geometry.positions.device)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton codes. x in [0,1)^3."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def expand(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) | expand(q[:, 2])


def _karras_tree(codes: np.ndarray):
    """Vectorised Karras (2012) binary radix tree over sorted unique codes.

    codes: (C,) uint64, strictly increasing. Returns (left, right) child
    arrays of the C-1 internal nodes; a child >= C-1 is leaf child - (C-1).
    """
    c = len(codes)
    if c == 1:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    codes = codes.astype(np.uint64)

    def delta(i, j):
        """Common-prefix length of codes[i] and codes[j]; -1 out of range."""
        ok = (j >= 0) & (j < c)
        x = codes[i[ok]] ^ codes[j[ok]]
        lz = 63 - np.floor(np.log2(x.astype(np.float64) + 0.5)).astype(np.int64)
        lz = np.where(x == 0, 64, lz)
        res = np.full(i.shape, -1, np.int64)
        res[ok] = lz
        return res

    i = np.arange(c - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)

    # upper bound of the range length, then its exact other end
    delta_min = delta(i, i - d)
    lmax = np.full(c - 1, 2, np.int64)
    grow = np.ones(c - 1, bool)
    while grow.any():
        grow = delta(i, i + lmax * d) > delta_min
        lmax = np.where(grow, lmax * 2, lmax)
    l = np.zeros(c - 1, np.int64)
    t = lmax // 2
    while (t >= 1).any():
        ok = delta(i, i + (l + t) * d) > delta_min
        l = np.where((t >= 1) & ok, l + t, l)
        t = t // 2
    j = i + l * d

    # split search: t runs over ceil(l / 2^k)
    delta_node = delta(i, j)
    s = np.zeros(c - 1, np.int64)
    max_l = int(l.max()) if len(l) else 0
    divs = []
    dv = 2
    while True:
        divs.append(dv)
        if dv >= max(max_l, 2):
            break
        dv *= 2
    for dv in divs:
        t = (l + dv - 1) // dv
        ok = delta(i, i + (s + t) * d) > delta_node
        s = np.where(ok, s + t, s)
    gamma = i + s * d + np.minimum(d, 0)

    left = np.where(np.minimum(i, j) == gamma, gamma + (c - 1), gamma).astype(np.int32)
    right = np.where(np.maximum(i, j) == gamma + 1, gamma + 1 + (c - 1), gamma + 1).astype(np.int32)
    return left, right


def _build_numpy(geometry, leaf_size: int = DEFAULT_LEAF_SIZE) -> LBVH:
    """The reference's NumPy LBVH: triangles sorted by the Morton code of
    their centroid, runs of ``leaf_size`` made leaves (padded with each
    leaf's last triangle), a Karras tree over leaf codes made unique by the
    leaf index, boxes by :func:`_refit_host`. Reached only by name."""
    pos, vidx = _host(geometry)
    a, b, c3 = pos[vidx[:, 0]], pos[vidx[:, 1]], pos[vidx[:, 2]]
    t = len(vidx)
    centroid = (a + b + c3) / 3.0
    lo = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = _morton3((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    num_leaves = (t + leaf_size - 1) // leaf_size
    leaf_tri = np.zeros((num_leaves, leaf_size), np.int32)
    for k in range(leaf_size):
        leaf_tri[:, k] = order[np.minimum(np.arange(num_leaves) * leaf_size + k, t - 1)]
    leaf_code = codes[order[np.minimum(np.arange(num_leaves) * leaf_size, t - 1)]]
    leaf_code = (leaf_code.astype(np.uint64) << np.uint64(32)) | np.arange(
        num_leaves, dtype=np.uint64)
    left, right = _karras_tree(leaf_code)
    box_min, box_max = _refit_host(pos, vidx, leaf_tri, left, right)
    dfs_next, dfs_skip = _thread_tree(left, right, num_leaves)
    arrays = dict(box_min=box_min, box_max=box_max, left=left, right=right, leaf_tri=leaf_tri,
                  tri_order=order, dfs_next=dfs_next, dfs_skip=dfs_skip, num_leaves=num_leaves)
    return _lbvh(arrays, leaf_size, geometry.positions.device)


def _tree_depth(left, right) -> int:
    """Max root->leaf node count of the binary tree (host, at build)."""
    left = np.asarray(left)
    right = np.asarray(right)
    ni = len(left)
    if ni == 0:
        return 1
    mx = 1
    stack = [(0, 1)]
    while stack:
        n, dep = stack.pop()
        mx = max(mx, dep)
        for c in (int(left[n]), int(right[n])):
            if c < ni:
                stack.append((c, dep + 1))
    return mx + 1


def _collapse4(left, right, node_min, node_max):
    """Greedy binary -> 4-wide collapse (host, at build), as the reference
    does it: each wide node starts from a binary node's two children and
    expands its largest-surface-area internal slot until four slots are
    filled. The area is computed in float32 from the same arrays as the
    reference, and ``max`` keeps the first of equal areas in slot order, so
    ties resolve the same way. Returns (wide_child, wide_src, num_wide,
    wide_depth); wide ids are given in the order the nodes are found."""
    left = np.asarray(left)
    right = np.asarray(right)
    ni = len(left)
    if ni == 0:
        return np.zeros((0, 4), np.int32), np.full((0, 4), -1, np.int32), 0, 1
    ext = np.maximum(np.asarray(node_max) - np.asarray(node_min), 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2]

    children: list = [None]  # children[w] = slot list of binary ids
    wide_of = {0: 0}
    wdepth = {0: 1}
    max_depth = 1
    work = [0]
    while work:
        b = work.pop()
        slots = [int(left[b]), int(right[b])]
        while len(slots) < 4:
            internals = [s for s in slots if s < ni]
            if not internals:
                break
            s = max(internals, key=lambda x: area[x])
            slots.remove(s)
            slots.extend([int(left[s]), int(right[s])])
        children[wide_of[b]] = slots
        for s in slots:
            if s < ni:
                wide_of[s] = len(children)
                wdepth[s] = wdepth[b] + 1
                max_depth = max(max_depth, wdepth[s])
                children.append(None)
                work.append(s)

    n_wide = len(children)
    wide_child = np.full((n_wide, 4), -1, np.int32)
    wide_src = np.full((n_wide, 4), -1, np.int32)
    for w, slots in enumerate(children):
        for j, s in enumerate(slots):
            wide_src[w, j] = s
            wide_child[w, j] = wide_of[s] if s < ni else n_wide + (s - ni)
    return wide_child, wide_src, n_wide, max_depth + 1  # + the leaf level


def _thread_tree(left, right, num_leaves):
    """Preorder threads of the stackless walk, per node of the unified id
    space: ``dfs_next`` — the successor when descending into the node (its
    left child for an internal node, ``dfs_skip`` for a leaf); ``dfs_skip``
    — the node after its whole subtree (-1 at the end)."""
    ni = len(left)
    total = ni + num_leaves
    dfs_next = np.full(total, -1, np.int64)
    dfs_skip = np.full(total, -1, np.int64)
    if ni == 0:
        return dfs_next.astype(np.int32), dfs_skip.astype(np.int32)
    stack = [(0, -1)]  # (node, continuation)
    while stack:
        node, cont = stack.pop()
        dfs_skip[node] = cont
        if node < ni:
            lc, rc = int(left[node]), int(right[node])
            dfs_next[node] = lc
            stack.append((rc, cont))
            stack.append((lc, rc))
        else:
            dfs_next[node] = cont
    return dfs_next.astype(np.int32), dfs_skip.astype(np.int32)


def _leaf_bounds(pos, vidx, leaf_tri):
    """(C, 3) min and max corners of each leaf's triangles."""
    tri = leaf_tri.reshape(-1)
    corners = np.stack([pos[vidx[tri, 0]], pos[vidx[tri, 1]], pos[vidx[tri, 2]]], axis=1)
    corners = corners.reshape(leaf_tri.shape[0], -1, 3)
    return corners.min(axis=1), corners.max(axis=1)


def _refit_host(pos, vidx, leaf_tri, left, right):
    """Bottom-up boxes, level by level to a fix point; returns unified
    (ni + C, 3) boxes, internal rows then leaf rows."""
    ni = len(left)
    leaf_min, leaf_max = _leaf_bounds(pos, vidx, leaf_tri)
    c = leaf_min.shape[0]
    box_min = np.full((ni + c, 3), np.inf, np.float32)
    box_max = np.full((ni + c, 3), -np.inf, np.float32)
    box_min[ni:] = leaf_min
    box_max[ni:] = leaf_max
    known = np.zeros(ni + c, bool)
    known[ni:] = True
    for _ in range(ni + 1):
        if known.all():
            break
        ready = known[left] & known[right] & ~known[:ni]
        box_min[:ni][ready] = np.minimum(box_min[left[ready]], box_min[right[ready]])
        box_max[:ni][ready] = np.maximum(box_max[left[ready]], box_max[right[ready]])
        known[:ni] |= ready
    if not known.all():
        raise RuntimeError("BVH refit did not converge (the tree has a cycle)")
    return box_min, box_max


def kernel_path() -> str:
    """Path of the built refit kernel library (builds it if needed)."""
    return build_shared([nvcc(), *NVCC_FLAGS], [KERNEL_SRC], "bvh_refit")


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/bvh_refit.cu`` (once per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.terra_bvh_refit.restype = ctypes.c_int
    lib.terra_bvh_refit.argtypes = [p, p, p, ctypes.c_int, p, p, i64, p, p, p, p, p]
    return lib


def _refit_cuda(bvh: LBVH, positions, tri_vidx) -> None:
    """The refit as the kernel's two launches on the current stream, into
    ``bvh.node_min`` / ``node_max``. Checks dtypes, contiguity, shapes and
    devices, then allocates the parents and arrival counters with
    ``torch.empty``; it reads nothing back, so a CUDA graph can capture it.
    The tree is not checked for a cycle or for ids out of range (that would
    read it back): it must be a builder's tree, as the plain twin's is."""
    ni = bvh.node_left.shape[0]
    c = ni + 1
    want = {"positions": (positions, torch.float32, (positions.shape[0], 3)),
            "tri_vidx": (tri_vidx, torch.int32, (tri_vidx.shape[0], 3)),
            "leaf_tri": (bvh.leaf_tri, torch.int32, (c, bvh.leaf_tri.shape[-1])),
            "node_left": (bvh.node_left, torch.int32, (ni,)),
            "node_right": (bvh.node_right, torch.int32, (ni,)),
            "node_min": (bvh.node_min, torch.float32, (ni + c, 3)),
            "node_max": (bvh.node_max, torch.float32, (ni + c, 3))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"the refit kernel takes a contiguous {dtype} {name} of shape "
                             f"{shape} (a tree of {ni} internal nodes and {c} leaves); got "
                             f"{'a contiguous' if t.is_contiguous() else 'a non-contiguous'} "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != positions.device:
            raise ValueError(f"the refit kernel takes every tensor on the positions' device "
                             f"{positions.device}; {name} is on {t.device}")
    if not positions.is_cuda:
        raise ValueError(f"the refit kernel takes CUDA tensors; got positions on "
                         f"{positions.device}")
    dev = positions.device
    parent = torch.empty((ni + c,), dtype=torch.int32, device=dev)
    arrivals = torch.empty((max(ni, 1),), dtype=torch.int32, device=dev)
    lib = load_kernel()
    rc = lib.terra_bvh_refit(
        positions.data_ptr(), tri_vidx.data_ptr(), bvh.leaf_tri.data_ptr(),
        bvh.leaf_tri.shape[1], bvh.node_left.data_ptr(), bvh.node_right.data_ptr(), ni,
        parent.data_ptr(), arrivals.data_ptr(), bvh.node_min.data_ptr(),
        bvh.node_max.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh_refit launch failed: cudaError {rc}")
    kernel_launches["bvh_refit"] += 2


def refit_(bvh: LBVH, geometry) -> LBVH:
    """:func:`refit` in place: the recomputed boxes are written into
    ``bvh.node_min`` and ``node_max``, so tables packed from them inside a
    captured graph see the moved triangles on its next replay. Returns
    ``bvh``. CPU positions take :func:`_refit_host` (the positions and the
    topology to NumPy, the boxes copied back); CUDA positions launch the
    kernel on the current stream, ordered before whatever is enqueued after
    it there (the next step's replays), with no host read and no
    synchronisation. The hot span ``terra.bvh.refit`` (``profile``) holds
    either."""
    with profiler.hot("terra.bvh.refit"):
        if geometry.positions.device.type == "cpu":
            pos, vidx = _host(geometry)
            node_min, node_max = _refit_host(
                pos, vidx, bvh.leaf_tri.cpu().numpy(), bvh.node_left.cpu().numpy(),
                bvh.node_right.cpu().numpy())
            bvh.node_min.copy_(torch.as_tensor(node_min))
            bvh.node_max.copy_(torch.as_tensor(node_max))
        else:
            _refit_cuda(bvh, geometry.positions.detach(), geometry.tri_vidx)
    return bvh


def refit(bvh: LBVH, geometry) -> LBVH:
    """The tree with its boxes recomputed for ``geometry``'s (moved)
    vertices on the same topology (:func:`refit_` into copies of the
    boxes: on the card for CUDA positions, in NumPy for CPU ones); the
    BVH4 overlay gathers its child boxes from these at pack time, so it
    stays valid."""
    return refit_(dataclasses.replace(bvh, node_min=bvh.node_min.clone(),
                                      node_max=bvh.node_max.clone()), geometry)
