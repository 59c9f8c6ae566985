"""Host-side binary SAH BVH, the tree the traversal kernel walks.

Port of the parts of ``terra_tpu/accel/lbvh.py`` that the render path
reads: the flat SoA tree in the unified id space (internal nodes
``0..C-2``, leaf ``k`` at ``C-1+k``), built by the shared native binned-SAH
builder, and its depth. The JAX package grows leaves until its node table
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
    leaf_size, num_leaves, depth : static (depth counts root..leaf levels)
    """

    node_min: torch.Tensor
    node_max: torch.Tensor
    node_left: torch.Tensor
    node_right: torch.Tensor
    leaf_tri: torch.Tensor
    tri_order: torch.Tensor
    leaf_size: int
    num_leaves: int
    depth: int

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

    return LBVH(
        node_min=dev(nat["box_min"]), node_max=dev(nat["box_max"]),
        node_left=dev(nat["left"]), node_right=dev(nat["right"]),
        leaf_tri=dev(nat["leaf_tri"]), tri_order=dev(nat["tri_order"]),
        leaf_size=leaf_size, num_leaves=nat["num_leaves"],
        depth=_tree_depth(nat["left"], nat["right"]),
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
