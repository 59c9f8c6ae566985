"""The Cornell box, frozen: the Cornell Program of Computer Graphics'
measured box (556 x 548.8 x 559.2, left-handed, Y-up, the camera down +Z)
with its two blocks, as terra_tpu bench.py config 2 builds it: white walls
of the configuration's BSDF, red and green side walls, one area light.
Generated with NumPy; returns plain arrays.
"""
from __future__ import annotations

import numpy as np

from benchmark.scenes import flat_geometry

BSDF = {"diffuse": 0, "ggx": 2}


def _quad(v0, v1, v2, v3):
    return [(v0, v1, v2), (v0, v2, v3)]


def generate(p: dict) -> dict:
    W, H, D = 556.0, 548.8, 559.2
    tris, mids, oids = [], [], []

    def add(quad, mid, oid):
        for tri in quad:
            tris.append(tri)
            mids.append(mid)
            oids.append(oid)

    add(_quad((W, 0, 0), (0, 0, 0), (0, 0, D), (W, 0, D)), 0, 0)  # floor
    add(_quad((W, H, 0), (W, H, D), (0, H, D), (0, H, 0)), 0, 1)  # ceiling
    add(_quad((W, 0, D), (0, 0, D), (0, H, D), (W, H, D)), 0, 2)  # back
    add(_quad((0, 0, D), (0, 0, 0), (0, H, 0), (0, H, D)), 2, 3)  # right, green
    add(_quad((W, 0, 0), (W, 0, D), (W, H, D), (W, H, 0)), 1, 4)  # left, red
    lx0, lx1, lz0, lz1 = 213.0, 343.0, 227.0, 332.0
    ly = H - 0.5
    add(_quad((lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), (lx0, ly, lz0)), 3, 5)

    def box(corners_bottom, height, mid, oid):
        b = [np.asarray(c, np.float32) for c in corners_bottom]
        t = [c + np.asarray([0, height, 0], np.float32) for c in b]
        add(_quad(t[0], t[1], t[2], t[3]), mid, oid)
        for i in range(4):
            j = (i + 1) % 4
            add(_quad(b[i], b[j], t[j], t[i]), mid, oid)

    box([(130, 0, 65), (82, 0, 225), (240, 0, 272), (290, 0, 114)], 165.0, 0, 6)
    box([(423, 0, 247), (265, 0, 296), (314, 0, 456), (472, 0, 406)], 330.0, 0, 7)

    t = np.asarray(tris, np.float32)
    uvs = np.tile(np.asarray([[0, 0], [1, 0], [1, 1]], np.float32)[None], (len(t), 1, 1))
    out = flat_geometry(t, uvs, np.asarray(mids, np.int32), np.asarray(oids, np.int32))

    m = 4
    attrs = np.zeros((m, 8, 3), np.float32)
    attrs[0, 0] = (0.73, 0.73, 0.73)
    attrs[1, 0] = (0.61, 0.06, 0.06)
    attrs[2, 0] = (0.12, 0.47, 0.1)
    attrs[3, 0] = (0.78, 0.78, 0.78)
    bsdf_type = np.zeros(m, np.int32)
    bsdf_type[0] = BSDF[p["wall_bsdf"]]
    if p["wall_bsdf"] == "ggx":
        attrs[0, 1] = (0.25, 0.0, 0.0)   # roughness
        attrs[0, 2] = (0.3, 0.0, 0.0)    # metalness
    emissive = np.zeros((m, 3), np.float32)
    emissive[3] = float(p["light_emission"])
    out.update(bsdf_type=bsdf_type, attrs=attrs, emissive=emissive,
               ior=np.full((m,), 1.5, np.float32), attr_tex=np.full((m, 8), -1, np.int32),
               emissive_tex=np.full((m,), -1, np.int32), tex_data=None)
    return out
