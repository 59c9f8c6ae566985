"""Programmatic scenes (port of ``terra_tpu/scenes.py``): the Cornell box,
the procedural courtyard and random triangle soups, built with NumPy from
the same seeds as the JAX package and committed on the caller's device."""
from __future__ import annotations

import numpy as np
import torch

from .scene import ATTR, Accelerator, BSDFType, Camera, Geometry, MaterialTable, Scene, \
    TextureAtlas, commit

__all__ = ["cornell_box", "cornell_camera", "courtyard", "courtyard_camera", "random_triangles",
           "make_geometry"]


def _quad(v0, v1, v2, v3):
    return [(v0, v1, v2), (v0, v2, v3)]


def _t(x, device):
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _geometry(tris: np.ndarray, uvs: np.ndarray, mat_ids, obj_ids, device) -> Geometry:
    """Geometry of a (T, 3, 3) corner array with flat shading normals."""
    t = tris.shape[0]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return Geometry(
        positions=_t(tris.reshape(t * 3, 3).astype(np.float32), device),
        tri_vidx=_t(np.arange(t * 3, dtype=np.int32).reshape(t, 3), device),
        normals=_t(np.repeat(n[:, None, :], 3, axis=1).astype(np.float32), device),
        uvs=_t(uvs.astype(np.float32), device),
        mat_id=_t(np.asarray(mat_ids, np.int32), device),
        obj_id=_t(np.asarray(obj_ids, np.int32), device),
    )


def make_geometry(tri_list, mat_ids, obj_ids=None, device="cuda") -> Geometry:
    """Geometry from a list of (a, b, c) corner triples; flat normals, uvs
    (0,0) (1,0) (1,1) per triangle."""
    tris = np.asarray(tri_list, np.float32)
    t = tris.shape[0]
    uvs = np.tile(np.asarray([[0, 0], [1, 0], [1, 1]], np.float32)[None], (t, 1, 1))
    if obj_ids is None:
        obj_ids = np.zeros(t, np.int32)
    return _geometry(tris, uvs, mat_ids, obj_ids, device)


def _materials(bsdf_types, attrs, emissive, iors, device, attr_tex=None) -> MaterialTable:
    m = len(bsdf_types)
    if attr_tex is None:
        attr_tex = np.full((m, 8), -1, np.int32)
    return MaterialTable(
        bsdf_type=_t(np.asarray(bsdf_types, np.int32), device),
        attrs=_t(attrs, device),
        attr_tex=_t(attr_tex, device),
        emissive=_t(emissive, device),
        emissive_tex=_t(np.full((m,), -1, np.int32), device),
        ior=_t(np.asarray(iors, np.float32), device),
    )


def cornell_box(accelerator: Accelerator = Accelerator.BRUTE, light_emission: float = 15.0,
                with_blocks: bool = True, wall_bsdf: BSDFType = BSDFType.DIFFUSE,
                block_bsdf: BSDFType = BSDFType.DIFFUSE, block_ior: float = 1.5,
                env_value=(0.0, 0.0, 0.0), device="cuda") -> Scene:
    """Classic Cornell box (left-handed, Y-up, camera down +Z). Materials:
    0 white, 1 red, 2 green, 3 light; ``wall_bsdf`` switches the white
    walls, ``block_bsdf`` the short block (material 4)."""
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
    add(_quad((0, 0, D), (0, 0, 0), (0, H, 0), (0, H, D)), 2, 3)  # right green
    add(_quad((W, 0, 0), (W, 0, D), (W, H, D), (W, H, 0)), 1, 4)  # left red
    lx0, lx1, lz0, lz1 = 213.0, 343.0, 227.0, 332.0
    ly = H - 0.5
    add(_quad((lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), (lx0, ly, lz0)), 3, 5)

    if with_blocks:
        def box(corners_bottom, height, mid, oid):
            b = [np.asarray(c, np.float32) for c in corners_bottom]
            t = [c + np.asarray([0, height, 0], np.float32) for c in b]
            add(_quad(t[0], t[1], t[2], t[3]), mid, oid)
            for i in range(4):
                j = (i + 1) % 4
                add(_quad(b[i], b[j], t[j], t[i]), mid, oid)

        short_mid = 4 if block_bsdf != BSDFType.DIFFUSE else 0
        box([(130, 0, 65), (82, 0, 225), (240, 0, 272), (290, 0, 114)], 165.0, short_mid, 6)
        box([(423, 0, 247), (265, 0, 296), (314, 0, 456), (472, 0, 406)], 330.0, 0, 7)

    geom = make_geometry(tris, mids, oids, device)
    m = 5 if (with_blocks and block_bsdf != BSDFType.DIFFUSE) else 4
    attrs = np.zeros((m, 8, 3), np.float32)
    attrs[0, ATTR.DIFFUSE_ALBEDO] = (0.73, 0.73, 0.73)
    attrs[1, ATTR.DIFFUSE_ALBEDO] = (0.61, 0.06, 0.06)
    attrs[2, ATTR.DIFFUSE_ALBEDO] = (0.12, 0.47, 0.1)
    attrs[3, ATTR.DIFFUSE_ALBEDO] = (0.78, 0.78, 0.78)
    bsdf_types = np.zeros(m, np.int32)
    if wall_bsdf == BSDFType.PHONG:
        bsdf_types[0] = BSDFType.PHONG
        attrs[0, ATTR.PHONG_SPECULAR_COLOR] = (0.4, 0.4, 0.4)
        attrs[0, ATTR.PHONG_SPECULAR_INTENSITY] = (32.0, 0.0, 0.0)
    elif wall_bsdf == BSDFType.GGX:
        bsdf_types[0] = BSDFType.GGX
        attrs[0, ATTR.GGX_ROUGHNESS] = (0.25, 0.0, 0.0)
        attrs[0, ATTR.GGX_METALNESS] = (0.3, 0.0, 0.0)
    if m == 5:
        bsdf_types[4] = block_bsdf
        if block_bsdf == BSDFType.GLASS:
            attrs[4, ATTR.GLASS_COLOR] = (1.0, 1.0, 1.0)
        elif block_bsdf == BSDFType.MIRROR:
            attrs[4, ATTR.MIRROR_COLOR] = (0.95, 0.95, 0.95)
        else:
            attrs[4, ATTR.DIFFUSE_ALBEDO] = (0.73, 0.73, 0.73)
    emissive = np.zeros((m, 3), np.float32)
    emissive[3] = (light_emission, light_emission, light_emission)
    iors = np.full((m,), 1.5, np.float32)
    if m == 5:
        iors[4] = block_ior
    materials = _materials(bsdf_types, attrs, emissive, iors, device)
    return commit(geom, materials, accelerator=accelerator, env_value=env_value)


def cornell_camera(device="cuda") -> Camera:
    return Camera.make(position=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0),
                       up=(0.0, 1.0, 0.0), fov_deg=39.3, device=device)


def courtyard(grid: int = 300, columns: int = 40, column_segments: int = 48,
              column_levels: int = 16, accelerator: Accelerator = Accelerator.BVH,
              textured: bool = True, tex_res: int = 128, device="cuda") -> Scene:
    """Procedural courtyard (~242k triangles at defaults): displaced
    terrain, a colonnade of fluted GGX columns, a surrounding wall and two
    area lights, with a checker and a marble texture."""
    rng = np.random.default_rng(7)
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
    segs, levels = column_segments, column_levels
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

    tris_a = np.concatenate([b[0] for b in blocks])
    uvs_a = np.concatenate([b[1] for b in blocks])
    mids_a = np.concatenate([b[2] for b in blocks])
    oids_a = np.concatenate([b[3] for b in blocks])
    geom = _geometry(tris_a, uvs_a, mids_a, oids_a, device)

    m = 4
    attrs = np.zeros((m, 8, 3), np.float32)
    attrs[0, ATTR.DIFFUSE_ALBEDO] = (0.55, 0.5, 0.45)   # terrain
    attrs[1, ATTR.GGX_ALBEDO] = (0.7, 0.65, 0.6)         # columns
    attrs[1, ATTR.GGX_ROUGHNESS] = (0.4, 0, 0)
    attrs[1, ATTR.GGX_METALNESS] = (0.1, 0, 0)
    attrs[2, ATTR.DIFFUSE_ALBEDO] = (0.35, 0.35, 0.4)    # walls
    attrs[3, ATTR.DIFFUSE_ALBEDO] = (0.8, 0.8, 0.8)      # light
    emissive = np.zeros((m, 3), np.float32)
    emissive[3] = (40.0, 38.0, 34.0)
    attr_tex = np.full((m, 8), -1, np.int32)
    atlas = None
    if textured:
        res = tex_res
        yy, xx = np.mgrid[0:res, 0:res] / res
        checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)[..., None]
        tex0 = (0.35 + 0.5 * checker * np.ones((1, 1, 3))).astype(np.float32)
        marble = (0.5 + 0.5 * np.sin(xx * 20 + 4 * np.sin(yy * 7)))[..., None]
        tex1 = (np.asarray([0.75, 0.7, 0.62]) * (0.6 + 0.4 * marble)).astype(np.float32)
        atlas = TextureAtlas(
            data=_t(np.stack([tex0, tex1]).astype(np.float32), device),
            size=_t(np.asarray([[res, res], [res, res]], np.int32), device),
            filter=_t(np.asarray([1, 1], np.int32), device),
            address=_t(np.asarray([0, 0], np.int32), device),
        )
        attr_tex[0, ATTR.DIFFUSE_ALBEDO] = 0
        attr_tex[1, ATTR.GGX_ALBEDO] = 1
    materials = _materials([0, 2, 0, 0], attrs, emissive, np.full((m,), 1.5, np.float32),
                           device, attr_tex)
    return commit(geom, materials, textures=atlas, accelerator=accelerator)


def courtyard_camera(device="cuda") -> Camera:
    return Camera.make(position=(20.0, 4.0, 3.0), direction=(0.0, 0.08, 1.0),
                       up=(0.0, 1.0, 0.0), fov_deg=60.0, device=device)


def random_triangles(n: int, seed: int = 0, scale: float = 1.0,
                     accelerator: Accelerator = Accelerator.BRUTE, device="cuda") -> Scene:
    """Random triangle soup for intersection and BVH tests."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-scale, scale, (n, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-0.1 * scale, 0.1 * scale, (n, 3, 3)).astype(np.float32)
    geom = make_geometry(list(centers + offsets), np.zeros(n, np.int32), np.zeros(n, np.int32),
                         device)
    materials = _materials([0], np.full((1, 8, 3), 0.5, np.float32), np.zeros((1, 3), np.float32),
                           [1.5], device)
    return commit(geom, materials, accelerator=accelerator)
