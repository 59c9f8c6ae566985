"""Host-side SAH BVH build through the native C++ source of ``terra_tpu``.

The builder source ``terra_tpu/native/terra_native.cpp`` is shared with the
JAX package and read by path (importing ``terra_tpu`` would import JAX). It
is compiled with g++ at first use into this package's ``_build`` directory
with the flags the JAX package uses, so both packages build the same trees.
A missing compiler or a failed build raises; there is no NumPy fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .._build import build_shared

__all__ = ["load", "sah_build"]

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "terra_tpu", "native", "terra_native.cpp")
CXX_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]

_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once per source/flag hash) and load the native library."""
    lib = ctypes.CDLL(build_shared(CXX_CMD, [SRC], "terra_native"))
    lib.terra_sah_build.restype = ctypes.c_int
    lib.terra_sah_build.argtypes = [
        _PF, ctypes.c_int64, _P32, ctypes.c_int64, ctypes.c_int,
        _P32, _P32, _P32, _PF, _PF, _P32, _P32, _P32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def sah_build(positions: np.ndarray, tri_vidx: np.ndarray, leaf_size: int) -> dict:
    """Binned-SAH build (16 bins x 3 axes; leaves hold [leaf_size/2,
    leaf_size] triangles, padded by repeating the last one).

    Returns numpy arrays: leaf_tri (C, L), left/right (C-1,), box_min/max
    (2C-1, 3) in the unified id space (internal nodes, then leaves),
    tri_order (T,), and num_leaves C.
    """
    lib = load()
    positions = np.ascontiguousarray(positions, np.float32)
    tri_vidx = np.ascontiguousarray(tri_vidx, np.int32)
    t = len(tri_vidx)
    c_max = max(2 * ((t + leaf_size - 1) // leaf_size), 1)
    nn_max = 2 * c_max - 1
    leaf_tri = np.zeros((c_max, leaf_size), np.int32)
    left = np.zeros((c_max - 1 or 1,), np.int32)
    right = np.zeros((c_max - 1 or 1,), np.int32)
    box_min = np.zeros((nn_max, 3), np.float32)
    box_max = np.zeros((nn_max, 3), np.float32)
    dfs_next = np.zeros((nn_max,), np.int32)
    dfs_skip = np.zeros((nn_max,), np.int32)
    tri_order = np.zeros((t,), np.int32)
    num_leaves = ctypes.c_int64()
    rc = lib.terra_sah_build(
        _ptr(positions, ctypes.c_float), len(positions),
        _ptr(tri_vidx, ctypes.c_int32), t, leaf_size,
        _ptr(leaf_tri, ctypes.c_int32),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(box_min, ctypes.c_float), _ptr(box_max, ctypes.c_float),
        _ptr(dfs_next, ctypes.c_int32), _ptr(dfs_skip, ctypes.c_int32),
        _ptr(tri_order, ctypes.c_int32), ctypes.byref(num_leaves),
    )
    if rc != 0:
        raise RuntimeError(f"terra_sah_build failed (rc={rc}, tris={t}, leaf_size={leaf_size})")
    c = int(num_leaves.value)
    ni = c - 1
    return dict(
        leaf_tri=leaf_tri[:c], left=left[:ni], right=right[:ni],
        box_min=box_min[:ni + c], box_max=box_max[:ni + c],
        tri_order=tri_order, num_leaves=c,
    )
