"""Shading-surface construction, wavefront-wide (port of ``terra_tpu/surface.py``).

The raycast returns only triangle ids. Everything continuous (hit
distance, position, barycentrics, normal, uv, material attributes) is
recomputed here from the vertex data, differentiably, so gradients reach
the positions, attributes, emission and textures. All per-triangle,
per-material and per-light data is packed into row tables built once per
trace, and each lane fetches one row by :func:`fetch_rows`, the
reference's rule: a table of at most ``ONEHOT_MAX_ROWS`` rows by a
one-hot product in full f32 (``ops/onehot.py``; its backward a product,
not an index accumulate), a larger one by an index gather.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import textures
from .ops import math3, onehot
from .scene import MAX_ATTRS, Scene

__all__ = ["Surface", "ShadeTables", "build_shade_tables", "fetch_rows", "surface_init",
           "ONEHOT_MAX_ROWS"]

# the most rows a table fetched by one-hot product has; larger ones are gathered
ONEHOT_MAX_ROWS = onehot.MAX_ROWS


@dataclass
class ShadeTables:
    """tri (T, 26): va vb vc n0 n1 n2 uv0 uv1 uv2 mat_id obj_id;
    mat (M, 29): bsdf_type ior emissive(3) attrs(24);
    light (Lcap, 30): a b c n0 n1 n2 uv0 uv1 uv2 area emissive(3) tri_idx
    emissive_tex."""

    tri: torch.Tensor
    mat: torch.Tensor
    light: torch.Tensor


def build_shade_tables(scene: Scene) -> ShadeTables:
    geom = scene.geometry
    if geom.tri_vidx.shape[0] >= (1 << 24):
        raise ValueError(f"{geom.tri_vidx.shape[0]} triangles exceed f32-exact table ids (2^24)")
    va, vb, vc = geom.corners()
    n = geom.normals
    uv = geom.uvs
    f = torch.float32
    tri = torch.cat([va, vb, vc, n[:, 0], n[:, 1], n[:, 2], uv[:, 0], uv[:, 1], uv[:, 2],
                     geom.mat_id.to(f)[:, None], geom.obj_id.to(f)[:, None]], dim=1)
    mats = scene.materials
    m = mats.num_materials
    mat = torch.cat([mats.bsdf_type.to(f)[:, None], mats.ior[:, None], mats.emissive,
                     mats.attrs.reshape(m, MAX_ATTRS * 3)], dim=1)
    lt = scene.lights
    lti = lt.tri_idx.long()
    la, lb, lc = va[lti], vb[lti], vc[lti]
    ln = n[lti]
    luv = uv[lti]
    area = 0.5 * math3.length(math3.cross(lb - la, lc - la))
    etid = mats.emissive_tex[lt.mat_id.long()].to(f)
    # lt.emissive is the commit-time NumPy copy, outside the gradient as in
    # the reference; emission gradients arrive through the surface's
    # material rows only. Corners and area are differentiable.
    light = torch.cat([la, lb, lc, ln[:, 0], ln[:, 1], ln[:, 2], luv[:, 0], luv[:, 1], luv[:, 2],
                       area[:, None], lt.emissive, lt.tri_idx.to(f)[:, None], etid[:, None]], dim=1)
    return ShadeTables(tri=tri, mat=mat, light=light)


def fetch_rows(table, idx):
    """One row per lane. At most ``ONEHOT_MAX_ROWS`` rows: the one-hot
    product (an id out of range gives a zero row, -0.0 comes back +0.0);
    more: an index gather (ids must be in range)."""
    return onehot.pick(table, idx)


@dataclass
class Surface:
    """Batched shading surface: frame, material and hit data per lane."""

    point: torch.Tensor      # (N, 3)
    normal: torch.Tensor     # (N, 3)
    tangent: torch.Tensor    # (N, 3)
    bitangent: torch.Tensor  # (N, 3)
    uv: torch.Tensor         # (N, 2)
    attrs: torch.Tensor      # (N, 8, 3)
    emissive: torch.Tensor   # (N, 3)
    mat_id: torch.Tensor     # (N,) i32
    bsdf_type: torch.Tensor  # (N,) i32
    ior: torch.Tensor        # (N,)
    t: torch.Tensor          # (N,)
    obj_id: torch.Tensor     # (N,) i32
    tri_area: torch.Tensor   # (N,)


def _eval_attribute(scene: Scene, const_val, tex_id, uv):
    """Texture id >= 0 overrides the constant."""
    if scene.textures.num_textures == 0:
        return const_val
    tex_val = textures.sample(scene.textures, torch.clamp(tex_id, min=0), uv)
    return torch.where((tex_id >= 0)[..., None], tex_val, const_val)


def surface_init(scene: Scene, tables: ShadeTables, o, d, tri_idx) -> Surface:
    """Surface for lanes with (possibly invalid) triangle ids. ``o``/``d``
    are the ray that produced the hit (origin already offset). The hit
    distance is a ray/plane intersection with the chosen triangle, the
    barycentrics the reference's 2x2 normal-equation solve."""
    row = fetch_rows(tables.tri, tri_idx)
    va, vb, vc = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    mat_id = torch.round(row[:, 24]).to(torch.int32)
    obj_id = torch.round(row[:, 25]).to(torch.int32)

    e0 = vb - va
    e1 = vc - va
    ng = math3.cross(e0, e1)
    denom = math3.dot(d, ng)
    safe = torch.abs(denom) > 1e-12
    t = math3.dot(va - o, ng) / torch.where(safe, denom, 1.0)
    t = torch.where(safe, t, 0.0)
    point = o + t[..., None] * d

    p = point - va
    d00 = math3.dot(e0, e0)
    d11 = math3.dot(e1, e1)
    d01 = math3.dot(e0, e1)
    dp0 = math3.dot(p, e0)
    dp1 = math3.dot(p, e1)
    div = d00 * d11 - d01 * d01
    inv_div = torch.reciprocal(torch.where(torch.abs(div) > 1e-20, div, 1.0))
    wb = (d11 * dp0 - d01 * dp1) * inv_div
    wc = (d00 * dp1 - d01 * dp0) * inv_div
    wa = 1.0 - wb - wc

    normal = math3.normalize(wa[..., None] * n0 + wb[..., None] * n1 + wc[..., None] * n2)
    uv = wa[..., None] * uv0 + wb[..., None] * uv1 + wc[..., None] * uv2

    mrow = fetch_rows(tables.mat, mat_id)
    bsdf_type = torch.round(mrow[:, 0]).to(torch.int32)
    ior = mrow[:, 1]
    emissive = mrow[:, 2:5]
    attrs = mrow[:, 5:].reshape(-1, MAX_ATTRS, 3)

    mats = scene.materials
    mid = mat_id.long()
    if scene.textures.num_textures > 0 and mats.tex_slots:
        attrs = torch.stack([
            _eval_attribute(scene, attrs[:, s, :], mats.attr_tex[mid, s], uv)
            if s in mats.tex_slots else attrs[:, s, :]
            for s in range(MAX_ATTRS)], dim=-2)
    if scene.textures.num_textures > 0 and mats.emissive_textured:
        emissive = _eval_attribute(scene, emissive, mats.emissive_tex[mid], uv)

    tangent, bitangent = math3.build_basis(normal)
    return Surface(point=point, normal=normal, tangent=tangent, bitangent=bitangent, uv=uv,
                   attrs=attrs, emissive=emissive, mat_id=mat_id, bsdf_type=bsdf_type, ior=ior,
                   t=t, obj_id=obj_id, tri_area=0.5 * math3.length(ng))
