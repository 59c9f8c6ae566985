"""Bytes and operations a kernel launch needs, counted from its shapes, and
the least time the card could take for them.

The BVH4 traversal (``csrc/bvh4_traverse.cu``): each ray's origin and
direction (and its range, with ``t_max``) read once, its hit (t, triangle)
written once, and the tables read once a launch: the wide nodes' boxes
(24 f32, or 12 i32 words of bf16 pairs) and links (4 i32) and the leaf
slots (leaf_size rows of 10 f32 a leaf). Operations: what any walk of a
ray must do, the root's four slab tests (6 subtractions and 6
multiplications each); the walk's further work depends on the data and is
not counted, so the share is an upper bound on the kernel's efficiency
only through the bytes, which bound it on these shapes.
"""
from __future__ import annotations

import re

_NAME = re.compile(r"bvh4_traverse_kernel<\s*(\d+)\s*,\s*(true|false)\s*,\s*(true|false)\s*,"
                   r"\s*(\d+)")


def bvh4_instance(name: str):
    """(has_tmax, any_hit, bf16 boxes) of a BVH4 kernel event's name, or
    None for another kernel."""
    m = _NAME.search(name)
    if m is None:
        return None
    return m.group(2) == "true", m.group(3) == "true", m.group(4) != "0"


def bvh4_launch(rays: int, has_tmax: bool, num_wide: int, leaf_rows: int, bf16: bool) -> dict:
    node_bytes = num_wide * ((12 if bf16 else 24) * 4 + 4 * 4)
    ray_bytes = rays * (6 * 4 + (4 if has_tmax else 0))
    hit_bytes = rays * (4 + 4)
    return {"bytes": node_bytes + leaf_rows * 10 * 4 + ray_bytes + hit_bytes,
            "flops": rays * 4 * 12}


def least_seconds(work: dict, peaks: dict) -> float:
    return max(work["bytes"] / peaks["hbm_bytes_per_s"], work["flops"] / peaks["f32_flops_per_s"])
