"""Frozen scene generators, one module per generator named in a
configuration file (``"generator"``). Each ``generate(params)`` returns
NumPy arrays: the triangle soup with flat shading normals, per-triangle
material and object ids, the material table and the texture atlas
(``tex_data`` None when the scene has none)."""
from __future__ import annotations

import numpy as np


def flat_geometry(tris: np.ndarray, uvs: np.ndarray, mat_id, obj_id) -> dict:
    """Arrays of a (T, 3, 3) corner soup: shared-nothing vertices, flat
    per-corner normals, per-triangle ids."""
    t = tris.shape[0]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return dict(positions=tris.reshape(t * 3, 3).astype(np.float32),
                tri_vidx=np.arange(t * 3, dtype=np.int32).reshape(t, 3),
                normals=np.repeat(n[:, None, :], 3, axis=1).astype(np.float32),
                uvs=np.ascontiguousarray(uvs, np.float32),
                mat_id=np.asarray(mat_id, np.int32), obj_id=np.asarray(obj_id, np.int32))
