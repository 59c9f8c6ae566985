"""Host-side binary SAH BVH, the tree the traversal kernel walks.

Port of the parts of ``terra_tpu/accel/lbvh.py`` that the render path
reads: the flat SoA tree in the unified id space (internal nodes
``0..C-2``, leaf ``k`` at ``C-1+k``), built by the shared native binned-SAH
builder, its depth, and the BVH4 overlay that the wide traversal walks
(:func:`_collapse4`, identical to the reference's for the same binary
tree). The JAX package grows leaves until its node table
fits the TPU's scalar memory; that budget means nothing on a GPU, so the
port takes a fixed ``DEFAULT_LEAF_SIZE``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native

__all__ = ["LBVH", "build", "DEFAULT_LEAF_SIZE"]

# Leaves hold [4, 8] triangles (the SAH builder pads a leaf of n >= L/2
# triangles to L by repetition). One thread tests a whole leaf, so small
# leaves trade fewer wasted triangle tests for more node visits; 8 keeps
# the 242k-triangle courtyard's tables at 10 MiB of triangle slots and
# 2 MiB of nodes, both well inside the H100's 50 MB L2.
DEFAULT_LEAF_SIZE = 8


@dataclass
class LBVH:
    """Flat SoA tree.

    node_min/max : (ni + C, 3) f32 boxes, internal rows then leaf rows
    node_left/right : (ni,) i32 child ids in the unified id space
    leaf_tri : (C, leaf_size) i32 triangle ids per leaf, padded by repetition
    tri_order : (T,) i32 the builder's triangle permutation
    wide_child : (W, 4) i32 BVH4 overlay: wide node w's children, each a
                 wide id < W, or W + leaf_id, or -1 for an empty slot
    wide_src : (W, 4) i32 the binary node bounding each wide child (-1 empty);
               child boxes are gathered from node_min/max at pack time
    leaf_size, num_leaves, depth : static (depth counts root..leaf levels)
    num_wide, wide_depth : static W and the overlay's root..leaf level count
    """

    node_min: torch.Tensor
    node_max: torch.Tensor
    node_left: torch.Tensor
    node_right: torch.Tensor
    leaf_tri: torch.Tensor
    tri_order: torch.Tensor
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


def build(geometry, leaf_size: int | None = None, builder: str = "sah") -> LBVH:
    """Native binned-SAH build from a Geometry; tensors land on the
    geometry's device. Only ``builder="sah"`` is ported."""
    if builder != "sah":
        raise NotImplementedError(
            f"BVH builder {builder!r}: only 'sah' is ported (ROADMAP queue A, accel/lbvh.py)")
    leaf_size = DEFAULT_LEAF_SIZE if leaf_size is None else int(leaf_size)
    pos = geometry.positions.detach().cpu().numpy()
    vidx = geometry.tri_vidx.detach().cpu().numpy()
    nat = native.sah_build(pos, vidx, leaf_size)
    device = geometry.positions.device

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    wc, ws, nw, wd = _collapse4(nat["left"], nat["right"], nat["box_min"], nat["box_max"])
    return LBVH(
        node_min=dev(nat["box_min"]), node_max=dev(nat["box_max"]),
        node_left=dev(nat["left"]), node_right=dev(nat["right"]),
        leaf_tri=dev(nat["leaf_tri"]), tri_order=dev(nat["tri_order"]),
        wide_child=dev(wc), wide_src=dev(ws),
        leaf_size=leaf_size, num_leaves=nat["num_leaves"],
        depth=_tree_depth(nat["left"], nat["right"]), num_wide=nw, wide_depth=wd,
    )


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
