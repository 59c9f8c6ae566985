"""Host-side BVH builds and the OBJ number parse through native C++ (ctypes).

``terra_native.cpp`` beside this file is a copy of the JAX package's
builder source with the same code (its comments differ in one path), so
both packages build the same trees from the same positions (the SAH and
LBVH twins in ``tests/test_torch_scene.py`` and ``tests/test_torch_lbvh.py``
hold the arrays equal; the OBJ twins in ``tests/test_torch_io_config.py``
hold the parsed records equal). It is compiled with g++ at first use into this
package's ``_build`` directory, with the flags the JAX package uses. A
missing compiler or a failed build raises; there is no NumPy fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .._build import build_shared

__all__ = ["load", "sah_build", "lbvh_build", "obj_parse"]

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "terra_native.cpp")
CXX_CMD = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]

_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)
_P64 = ctypes.POINTER(ctypes.c_int64)
_BUILD_ARGS = [_PF, ctypes.c_int64, _P32, ctypes.c_int64, ctypes.c_int,
               _P32, _P32, _P32, _PF, _PF, _P32, _P32, _P32]


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once per source/flag hash) and load the native library."""
    lib = ctypes.CDLL(build_shared(CXX_CMD, [SRC], "terra_native"))
    lib.terra_sah_build.restype = ctypes.c_int
    lib.terra_sah_build.argtypes = _BUILD_ARGS + [ctypes.POINTER(ctypes.c_int64)]
    lib.terra_lbvh_build.restype = ctypes.c_int
    lib.terra_lbvh_build.argtypes = _BUILD_ARGS
    lib.terra_obj_count.restype = ctypes.c_int
    lib.terra_obj_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, _P64, _P64, _P64, _P64]
    lib.terra_obj_parse.restype = ctypes.c_int
    lib.terra_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, _PF, _PF, _PF, _P32, _P32]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _buffers(t: int, c: int, leaf_size: int) -> dict:
    """Output arrays for a tree of at most ``c`` leaves over ``t`` triangles."""
    nn = 2 * c - 1
    return dict(leaf_tri=np.zeros((c, leaf_size), np.int32),
                left=np.zeros((max(c - 1, 1),), np.int32),
                right=np.zeros((max(c - 1, 1),), np.int32),
                box_min=np.zeros((nn, 3), np.float32), box_max=np.zeros((nn, 3), np.float32),
                dfs_next=np.zeros((nn,), np.int32), dfs_skip=np.zeros((nn,), np.int32),
                tri_order=np.zeros((t,), np.int32))


def _call(fn, positions, tri_vidx, leaf_size: int, out: dict, *extra) -> int:
    positions = np.ascontiguousarray(positions, np.float32)
    tri_vidx = np.ascontiguousarray(tri_vidx, np.int32)
    i32, f32 = ctypes.c_int32, ctypes.c_float
    return fn(
        _ptr(positions, f32), len(positions), _ptr(tri_vidx, i32), len(tri_vidx), leaf_size,
        _ptr(out["leaf_tri"], i32), _ptr(out["left"], i32), _ptr(out["right"], i32),
        _ptr(out["box_min"], f32), _ptr(out["box_max"], f32),
        _ptr(out["dfs_next"], i32), _ptr(out["dfs_skip"], i32),
        _ptr(out["tri_order"], i32), *extra)


def _trim(out: dict, c: int) -> dict:
    """The arrays of a tree of ``c`` leaves: internal nodes ``c - 1``, then
    the unified id space of ``2c - 1`` nodes."""
    ni, nn = c - 1, 2 * c - 1
    return dict(leaf_tri=out["leaf_tri"][:c], left=out["left"][:ni], right=out["right"][:ni],
                box_min=out["box_min"][:nn], box_max=out["box_max"][:nn],
                dfs_next=out["dfs_next"][:nn], dfs_skip=out["dfs_skip"][:nn],
                tri_order=out["tri_order"], num_leaves=c)


def sah_build(positions: np.ndarray, tri_vidx: np.ndarray, leaf_size: int) -> dict:
    """Binned-SAH build (16 bins x 3 axes; leaves hold [leaf_size/2,
    leaf_size] triangles, padded by repeating the last one).

    Returns numpy arrays: leaf_tri (C, L), left/right (C-1,), box_min/max
    (2C-1, 3) and dfs_next/dfs_skip (2C-1,) in the unified id space
    (internal nodes, then leaves), tri_order (T,), and num_leaves C.
    """
    t = len(tri_vidx)
    out = _buffers(t, max(2 * ((t + leaf_size - 1) // leaf_size), 1), leaf_size)
    num_leaves = ctypes.c_int64()
    rc = _call(load().terra_sah_build, positions, tri_vidx, leaf_size, out,
               ctypes.byref(num_leaves))
    if rc != 0:
        raise RuntimeError(f"terra_sah_build failed (rc={rc}, tris={t}, leaf_size={leaf_size})")
    return _trim(out, int(num_leaves.value))


def lbvh_build(positions: np.ndarray, tri_vidx: np.ndarray, leaf_size: int) -> dict:
    """Morton-cluster LBVH: triangles sorted by the Morton code of their
    centroid, runs of ``leaf_size`` made leaves (the last padded by
    repetition), a Karras radix tree over the leaves. Returns the arrays of
    :func:`sah_build`; C is ceil(T / leaf_size)."""
    t = len(tri_vidx)
    c = (t + leaf_size - 1) // leaf_size
    out = _buffers(t, max(c, 1), leaf_size)
    rc = _call(load().terra_lbvh_build, positions, tri_vidx, leaf_size, out)
    if rc != 0:
        raise RuntimeError(f"terra_lbvh_build failed (rc={rc}, tris={t}, leaf_size={leaf_size})")
    return _trim(out, c)


def obj_parse(text) -> tuple:
    """Numeric records of an OBJ file's text (``str`` or ``bytes``):
    (verts (V, 3) f32, norms (N, 3) f32, uvs (U, 2) f32, face_idx (F, 3, 3)
    i32 with (v, vt, vn) per corner and -1 where absent, face_line (F,) i32
    source line of each triangle). Polygons are fan-triangulated; negative
    indices are resolved against the records read so far."""
    if isinstance(text, str):
        text = text.encode("utf-8", errors="replace")
    lib = load()
    n = ctypes.c_int64(len(text))
    nv, nn, nt, nf = (ctypes.c_int64() for _ in range(4))
    rc = lib.terra_obj_count(text, n, ctypes.byref(nv), ctypes.byref(nn), ctypes.byref(nt),
                             ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError(f"terra_obj_count failed (rc={rc}, bytes={len(text)})")
    verts = np.zeros((nv.value, 3), np.float32)
    norms = np.zeros((nn.value, 3), np.float32)
    uvs = np.zeros((nt.value, 2), np.float32)
    face_idx = np.zeros((nf.value, 3, 3), np.int32)
    face_line = np.zeros((nf.value,), np.int32)
    rc = lib.terra_obj_parse(text, n, _ptr(verts, ctypes.c_float), _ptr(norms, ctypes.c_float),
                             _ptr(uvs, ctypes.c_float), _ptr(face_idx, ctypes.c_int32),
                             _ptr(face_line, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError(f"terra_obj_parse failed (rc={rc}, bytes={len(text)})")
    return verts, norms, uvs, face_idx, face_line
