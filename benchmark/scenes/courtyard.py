"""The procedural courtyard, frozen: terra_tpu bench.py config 3b's scene
(displaced terrain, a colonnade of fluted GGX columns, a surrounding wall,
two area lights, a checker and a marble texture), generated with NumPy
from the configuration's parameters and its own seed.

Returns plain arrays; the harness hands the same arrays to the program
(through its public scene API) and to the plain reference.
"""
from __future__ import annotations

import numpy as np

from benchmark.scenes import flat_geometry

DIFFUSE, GGX = 0, 2


def generate(p: dict) -> dict:
    grid, columns = int(p["grid"]), int(p["columns"])
    segs, levels = int(p["column_segments"]), int(p["column_levels"])
    rng = np.random.default_rng(int(p["seed"]))
    blocks = []

    def emit_quads(p00, p10, p11, p01, uv00, uv10, uv11, uv01, mid, oid):
        t1 = np.stack([p00, p10, p11], axis=-2)
        t2 = np.stack([p00, p11, p01], axis=-2)
        tris = np.stack([t1, t2], axis=-3).reshape(-1, 3, 3)
        u1 = np.stack([uv00, uv10, uv11], axis=-2)
        u2 = np.stack([uv00, uv11, uv01], axis=-2)
        uvs = np.stack([u1, u2], axis=-3).reshape(-1, 3, 2)
        n = tris.shape[0]
        oid_a = np.broadcast_to(np.asarray(oid), p00.shape[:-1])
        oid_a = np.stack([oid_a, oid_a], axis=-1).reshape(-1)
        blocks.append((tris.astype(np.float32), uvs.astype(np.float32),
                       np.full(n, mid, np.int32), oid_a.astype(np.int32)))

    size = 40.0
    xs = np.linspace(0, size, grid + 1)
    zs = np.linspace(0, size, grid + 1)
    hx = np.sin(xs[:, None] * 0.7) * 0.25 + np.cos(zs[None, :] * 0.9) * 0.25
    hx += rng.normal(0, 0.02, hx.shape)
    I, J = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")

    def tp(ii, jj):
        return np.stack([xs[ii], hx[ii, jj], zs[jj]], axis=-1)

    def tuv(ii, jj):
        return np.stack([ii / 8 % 1, jj / 8 % 1], axis=-1)

    emit_quads(tp(I, J), tp(I + 1, J), tp(I + 1, J + 1), tp(I, J + 1),
               tuv(I, J), tuv(I + 1, J), tuv(I + 1, J + 1), tuv(I, J + 1), 0, 0)

    height = 8.0
    k = np.arange(columns)[:, None, None]
    lv = np.arange(levels)[None, :, None]
    s = np.arange(segs)[None, None, :]
    ang = 2 * np.pi * k / columns
    cx = size / 2 + np.cos(ang) * size * 0.35
    cz = size / 2 + np.sin(ang) * size * 0.35
    radius = 0.8 + 0.1 * np.sin(5 * ang)

    def cy(lvv):
        return np.broadcast_to(lvv * height / levels, (columns, levels, segs)).astype(np.float64)

    def cr(lvv):
        return radius * (1.0 + 0.08 * np.sin(lvv * 1.3))

    def cpt(lvv, ss):
        a = 2 * np.pi * ss / segs
        flute = 1 + 0.06 * np.sin(a * 9)
        r = cr(lvv)
        return np.stack(np.broadcast_arrays(
            cx + np.cos(a) * r * flute, cy(lvv), cz + np.sin(a) * r * flute), axis=-1)

    def cuv(lvv, ss):
        return np.stack(np.broadcast_arrays(
            ss / segs + 0.0 * (cx + cr(lvv)), lvv / levels + 0.0 * cx), axis=-1)

    emit_quads(cpt(lv, s), cpt(lv, s + 1), cpt(lv + 1, s + 1), cpt(lv + 1, s),
               cuv(lv, s), cuv(lv, s + 1), cuv(lv + 1, s + 1), cuv(lv + 1, s),
               1, 1 + np.broadcast_to(k, (columns, levels, segs)))

    oid = 1 + columns
    wall_h = 12.0
    for (a, b) in [((0, 0), (size, 0)), ((size, 0), (size, size)),
                   ((size, size), (0, size)), ((0, size), (0, 0))]:
        steps = 40
        t0 = np.arange(steps) / steps
        t1 = (np.arange(steps) + 1) / steps

        def wp(t, y):
            return np.stack([a[0] + (b[0] - a[0]) * t, np.full_like(t, y),
                             a[1] + (b[1] - a[1]) * t], axis=-1)

        uvd = np.stack([np.zeros(steps), np.zeros(steps)], axis=-1)
        uvb = np.stack([np.ones(steps), np.zeros(steps)], axis=-1)
        uvc = np.stack([np.ones(steps), np.ones(steps)], axis=-1)
        emit_quads(wp(t0, 0.0), wp(t1, 0.0), wp(t1, wall_h), wp(t0, wall_h),
                   uvd, uvb, uvc, uvd, 2, oid)
        oid += 1

    for lx, lz in [(size * 0.3, size * 0.3), (size * 0.7, size * 0.7)]:
        sl = 2.0
        y = 14.0
        c00 = np.asarray([[lx - sl, y, lz - sl]])
        c10 = np.asarray([[lx + sl, y, lz - sl]])
        c11 = np.asarray([[lx + sl, y, lz + sl]])
        c01 = np.asarray([[lx - sl, y, lz + sl]])
        uv = np.asarray([[0.0, 0.0]])
        emit_quads(c00, c10, c11, c01, uv, uv, uv, uv, 3, oid)
        oid += 1

    tris = np.concatenate([b[0] for b in blocks])
    out = flat_geometry(tris, np.concatenate([b[1] for b in blocks]),
                        np.concatenate([b[2] for b in blocks]),
                        np.concatenate([b[3] for b in blocks]))

    m = 4
    attrs = np.zeros((m, 8, 3), np.float32)
    attrs[0, 0] = (0.55, 0.5, 0.45)    # terrain, diffuse albedo
    attrs[1, 0] = (0.7, 0.65, 0.6)     # columns, GGX albedo
    attrs[1, 1] = (0.4, 0, 0)          # roughness
    attrs[1, 2] = (0.1, 0, 0)          # metalness
    attrs[2, 0] = (0.35, 0.35, 0.4)    # walls
    attrs[3, 0] = (0.8, 0.8, 0.8)      # lights
    emissive = np.zeros((m, 3), np.float32)
    emissive[3] = (40.0, 38.0, 34.0)
    attr_tex = np.full((m, 8), -1, np.int32)
    res = int(p["tex_res"])
    yy, xx = np.mgrid[0:res, 0:res] / res
    checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)[..., None]
    tex0 = (0.35 + 0.5 * checker * np.ones((1, 1, 3))).astype(np.float32)
    marble = (0.5 + 0.5 * np.sin(xx * 20 + 4 * np.sin(yy * 7)))[..., None]
    tex1 = (np.asarray([0.75, 0.7, 0.62]) * (0.6 + 0.4 * marble)).astype(np.float32)
    attr_tex[0, 0] = 0
    attr_tex[1, 0] = 1
    out.update(
        bsdf_type=np.asarray([DIFFUSE, GGX, DIFFUSE, DIFFUSE], np.int32), attrs=attrs,
        emissive=emissive, ior=np.full((m,), 1.5, np.float32), attr_tex=attr_tex,
        emissive_tex=np.full((m,), -1, np.int32),
        tex_data=np.stack([tex0, tex1]).astype(np.float32),
        tex_size=np.asarray([[res, res], [res, res]], np.int32),
        tex_filter=np.asarray([1, 1], np.int32), tex_address=np.asarray([0, 0], np.int32))
    return out
