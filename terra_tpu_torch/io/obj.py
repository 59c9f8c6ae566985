"""OBJ/MTL importer -> SoA scene tensors (port of ``terra_tpu/io/obj.py``).

  * v/vn/vt + triangulated faces (fan triangulation for polygons),
  * per-object grouping by ``o``/``g``/``usemtl`` (each becomes an obj_id),
  * MTL: Kd/map_Kd, Ks, Ns, Ke/map_Ke, Pr (roughness), Pm (metalness), Ni,
    Tf, illum — both Apollo's string names ("diffuse"/"specular"/"mirror"/
    "pbr", Apollo.h:877-896) and numeric illum codes,
  * right->left handedness flip: z negated + winding flipped
    (Scene.cpp:90-93),
  * material binding (Scene.cpp:182-230): specular -> PHONG, pbr -> GGX,
    mirror -> MIRROR, transparent illum codes -> GLASS, else DIFFUSE; ior
    defaults to 1.5 (Scene.cpp:188),
  * missing normals are recomputed as area-weighted vertex normals.

The numeric records go through the native parser (``native.obj_parse``);
the directives (mtllib/usemtl/o/g) are associated by source line number in
Python. All arithmetic is the reference's NumPy, in its order, and tensors
are made only at the end, so both packages load a file to the same bits.
``_parse_python`` is the parser's plain twin, for the tests only.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..scene import ATTR, MAX_ATTRS, BSDFType, Geometry, MaterialTable, TextureAtlas
from . import image as image_io

__all__ = ["load_obj"]


@dataclass
class _MTL:
    name: str
    kd: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ks: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ns: float = 32.0
    ke: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pr: Optional[float] = None
    pm: Optional[float] = None
    ni: float = 1.5  # optical density / ior (Scene.cpp:188 default)
    tf: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # transmission filter
    illum: Optional[str] = None
    map_kd: Optional[str] = None
    map_ke: Optional[str] = None

    def bsdf(self) -> BSDFType:
        """Apollo classification (Apollo.h:77-84, 877-896) + PBR keys.
        MTL illum 4/6/7/9 are the transparency/refraction classes, mapped
        to the dielectric GLASS preset (TerraPresets.c:397-465)."""
        if self.illum in ("glass", "4", "6", "7", "9"):
            return BSDFType.GLASS
        if self.illum in ("specular",) or (self.illum in ("2", "3") and any(k > 0 for k in self.ks)):
            return BSDFType.PHONG
        if self.illum == "mirror" or self.illum == "5":
            return BSDFType.MIRROR
        if self.illum in ("pbr", "disney") or self.pr is not None or self.pm is not None:
            return BSDFType.GGX
        return BSDFType.DIFFUSE


def _parse_mtl(path: str) -> Dict[str, _MTL]:
    mats: Dict[str, _MTL] = {}
    cur: Optional[_MTL] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            key = parts[0]
            if key == "newmtl":
                cur = _MTL(name=parts[1] if len(parts) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.kd = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 4:
                cur.ks = tuple(float(x) for x in parts[1:4])
            elif key == "Ns" and len(parts) >= 2:
                cur.ns = float(parts[1])
            elif key == "Ke" and len(parts) >= 4:
                cur.ke = tuple(float(x) for x in parts[1:4])
            elif key == "Pr" and len(parts) >= 2:
                cur.pr = float(parts[1])
            elif key == "Pm" and len(parts) >= 2:
                cur.pm = float(parts[1])
            elif key == "Ni" and len(parts) >= 2:
                cur.ni = float(parts[1])
            elif key == "Tf" and len(parts) >= 4:
                cur.tf = tuple(float(x) for x in parts[1:4])
            elif key == "illum" and len(parts) >= 2:
                cur.illum = parts[1].lower()
            elif key == "map_Kd" and len(parts) >= 2:
                cur.map_kd = parts[-1]
            elif key == "map_Ke" and len(parts) >= 2:
                cur.map_ke = parts[-1]
    return mats


def _parse_index(tok: str, nv: int, nt: int, nn: int):
    """Parse OBJ 'v/vt/vn' token with negative-index support."""
    comps = tok.split("/")

    def fix(idx_str, count):
        if not idx_str:
            return -1
        i = int(idx_str)
        return i - 1 if i > 0 else count + i

    vi = fix(comps[0], nv)
    ti = fix(comps[1], nt) if len(comps) > 1 else -1
    ni = fix(comps[2], nn) if len(comps) > 2 else -1
    return vi, ti, ni


def _scan_directives(raw: str, base: str):
    """One pass over the non-numeric directives (mtllib/usemtl/o/g): returns
    (mtls, state_lines, state_mat, state_obj) where state_* record the
    (material, object) in effect from each source line onward, for the
    native parser's face_line output."""
    mtls: Dict[str, _MTL] = {}
    state_lines: List[int] = [-1]
    state_mat: List[str] = [""]
    state_obj: List[int] = [0]
    cur_mat = ""
    obj_counter = 0
    for lineno, line in enumerate(raw.split("\n")):
        parts = line.split("#", 1)[0].split()
        if not parts:
            continue
        key = parts[0]
        if key == "mtllib" and len(parts) > 1:
            mtls.update(_parse_mtl(os.path.join(base, " ".join(parts[1:]))))
        elif key == "usemtl" and len(parts) > 1:
            cur_mat = parts[1]
            obj_counter += 1
            state_lines.append(lineno)
            state_mat.append(cur_mat)
            state_obj.append(obj_counter)
        elif key in ("o", "g"):
            obj_counter += 1
            state_lines.append(lineno)
            state_mat.append(cur_mat)
            state_obj.append(obj_counter)
    return mtls, np.asarray(state_lines, np.int64), state_mat, np.asarray(state_obj, np.int32)


def _parse_python(raw: str):
    """Pure-Python numeric parse, the twin of ``native.obj_parse``: returns
    (pos, nrm, uvs, face_idx (F,3,3) i32 with -1 absent, face_line (F,) i32)."""
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    face_rows: List[Tuple] = []
    face_lines: List[int] = []
    for lineno, line in enumerate(raw.split("\n")):
        parts = line.split("#", 1)[0].split()
        if not parts:
            continue
        key = parts[0]
        if key == "v":
            positions.append(tuple(float(x) for x in parts[1:4]))
        elif key == "vn":
            normals.append(tuple(float(x) for x in parts[1:4]))
        elif key == "vt":
            texcoords.append(tuple(float(x) for x in parts[1:3]))
        elif key == "f" and len(parts) >= 4:
            idx = [
                _parse_index(t, len(positions), len(texcoords), len(normals))
                for t in parts[1:]
            ]
            for i in range(1, len(idx) - 1):  # fan triangulation
                face_rows.append((idx[0], idx[i], idx[i + 1]))
                face_lines.append(lineno)
    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    nrm = np.asarray(normals, np.float32).reshape(-1, 3) if normals else np.zeros((0, 3), np.float32)
    uvs = np.asarray(texcoords, np.float32).reshape(-1, 2) if texcoords else np.zeros((0, 2), np.float32)
    face_idx = np.asarray(face_rows, np.int32).reshape(-1, 3, 3)
    return pos, nrm, uvs, face_idx, np.asarray(face_lines, np.int32)


def load_obj(path: str, flip_handedness: bool = True, load_textures: bool = True,
             device="cuda"):
    """Import an OBJ file. Returns (Geometry, MaterialTable, TextureAtlas)
    with their tensors on ``device``, ready for ``scene.commit``."""
    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        raw = f.read()

    mtls, state_lines, state_mat, state_obj = _scan_directives(raw, base)
    pos, nrm, uvs, face_idx, face_line = native.obj_parse(raw)

    if flip_handedness:
        pos = pos * np.asarray([1, 1, -1], np.float32)
        nrm = nrm * np.asarray([1, 1, -1], np.float32) if len(nrm) else nrm

    t = len(face_idx)
    # Per-face (material, object) state: last directive at a line <= face's.
    fs = np.searchsorted(state_lines, face_line.astype(np.int64), side="right") - 1

    # Material name -> table row (only names actually used by faces).
    used_states = np.unique(fs) if t else np.zeros((0,), np.int64)
    mat_names = sorted({state_mat[int(i)] for i in used_states}) or [""]
    mat_row = {n: i for i, n in enumerate(mat_names)}
    state_row = np.asarray([mat_row.get(n, 0) for n in state_mat], np.int32)

    order = (0, 2, 1) if flip_handedness else (0, 1, 2)  # flip winding
    face_idx = face_idx[:, order, :]
    tri_vidx = face_idx[:, :, 0].astype(np.int32)
    tri_ti = face_idx[:, :, 1]
    tri_ni = face_idx[:, :, 2].astype(np.int64)
    tri_uv = np.zeros((t, 3, 2), np.float32)
    if len(uvs) and t:
        has_uv = tri_ti >= 0
        tri_uv = np.where(
            has_uv[..., None], uvs[np.clip(tri_ti, 0, len(uvs) - 1)], 0.0
        ).astype(np.float32)
    mat_id = state_row[fs] if t else np.zeros((0,), np.int32)
    obj_id = state_obj[fs] if t else np.zeros((0,), np.int32)

    # Shading normals: from file where present, else area-weighted vertex
    # normals recomputed from geometry.
    a = pos[tri_vidx[:, 0]]
    b = pos[tri_vidx[:, 1]]
    c = pos[tri_vidx[:, 2]]
    face_n = np.cross(b - a, c - a)  # area-weighted
    vert_n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(vert_n, tri_vidx[:, k], face_n)
    norm = np.linalg.norm(vert_n, axis=-1, keepdims=True)
    vert_n = vert_n / np.maximum(norm, 1e-12)

    tri_normals = np.zeros((t, 3, 3), np.float32)
    for k in range(3):
        has = tri_ni[:, k] >= 0
        tri_normals[:, k] = np.where(
            has[:, None] & (len(nrm) > 0),
            nrm[np.clip(tri_ni[:, k], 0, max(len(nrm) - 1, 0))] if len(nrm) else 0.0,
            vert_n[tri_vidx[:, k]],
        )

    # Build material table + texture atlas
    num_mats = len(mat_names)
    attrs = np.zeros((num_mats, MAX_ATTRS, 3), np.float32)
    attr_tex = np.full((num_mats, MAX_ATTRS), -1, np.int32)
    emissive = np.zeros((num_mats, 3), np.float32)
    emissive_tex = np.full((num_mats,), -1, np.int32)
    bsdf_type = np.zeros((num_mats,), np.int32)
    ior = np.full((num_mats,), 1.5, np.float32)  # Scene.cpp:188

    tex_paths: List[str] = []

    def tex_slot(p: Optional[str]) -> int:
        if not load_textures or not p:
            return -1
        full = os.path.join(base, p)
        if not os.path.exists(full):
            return -1
        if full not in tex_paths:
            tex_paths.append(full)
        return tex_paths.index(full)

    for name, row in mat_row.items():
        m = mtls.get(name, _MTL(name=name))
        ty = m.bsdf()
        bsdf_type[row] = int(ty)
        emissive[row] = m.ke
        emissive_tex[row] = tex_slot(m.map_ke)
        if ty == BSDFType.PHONG:
            attrs[row, ATTR.PHONG_ALBEDO] = m.kd
            attrs[row, ATTR.PHONG_SPECULAR_COLOR] = m.ks
            attrs[row, ATTR.PHONG_SPECULAR_INTENSITY] = (m.ns, 0, 0)
            attr_tex[row, ATTR.PHONG_ALBEDO] = tex_slot(m.map_kd)
        elif ty == BSDFType.GGX:
            attrs[row, ATTR.GGX_ALBEDO] = m.kd
            attrs[row, ATTR.GGX_ROUGHNESS] = (m.pr if m.pr is not None else 0.5, 0, 0)
            attrs[row, ATTR.GGX_METALNESS] = (m.pm if m.pm is not None else 0.0, 0, 0)
            attr_tex[row, ATTR.GGX_ALBEDO] = tex_slot(m.map_kd)
        elif ty == BSDFType.MIRROR:
            attrs[row, ATTR.MIRROR_COLOR] = m.ks if any(m.ks) else m.kd
        elif ty == BSDFType.GLASS:
            attrs[row, ATTR.GLASS_COLOR] = m.tf  # transmission filter tint
            ior[row] = m.ni
        else:
            attrs[row, ATTR.DIFFUSE_ALBEDO] = m.kd
            attr_tex[row, ATTR.DIFFUSE_ALBEDO] = tex_slot(m.map_kd)

    atlas = _build_atlas(tex_paths, device)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    geom = Geometry(positions=dev(pos), tri_vidx=dev(tri_vidx), normals=dev(tri_normals),
                    uvs=dev(tri_uv), mat_id=dev(mat_id), obj_id=dev(obj_id))
    mats = MaterialTable(bsdf_type=dev(bsdf_type), attrs=dev(attrs), attr_tex=dev(attr_tex),
                         emissive=dev(emissive), emissive_tex=dev(emissive_tex), ior=dev(ior))
    return geom, mats, atlas


def _build_atlas(paths: List[str], device) -> TextureAtlas:
    if not paths:
        return TextureAtlas.empty(device)
    imgs = [image_io.load_image(p, srgb=True) for p in paths]
    max_h = max(im.shape[0] for im in imgs)
    max_w = max(im.shape[1] for im in imgs)
    data = np.zeros((len(imgs), max_h, max_w, 3), np.float32)
    size = np.zeros((len(imgs), 2), np.int32)
    for i, im in enumerate(imgs):
        data[i, : im.shape[0], : im.shape[1]] = im
        size[i] = (im.shape[0], im.shape[1])
    n = len(imgs)
    return TextureAtlas(
        data=torch.as_tensor(data, device=device),
        size=torch.as_tensor(size, device=device),
        filter=torch.ones((n,), dtype=torch.int32, device=device),  # bilinear default
        address=torch.zeros((n,), dtype=torch.int32, device=device),  # wrap default
    )
