"""Scene representation: flat struct-of-arrays tensors on one device.

PyTorch port of ``terra_tpu/scene.py``: the same enums, dataclasses and
fields, with tensors in place of JAX arrays. ``commit`` builds the light
table and, for ``Accelerator.BVH``, the SAH tree on the host, then places
every table on the device the caller names.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .ops import math3
from .ops.row_accumulate import gather
from .profile import profiler

__all__ = [
    "BSDFType", "Integrator", "LightPick", "Tonemap", "SamplingMethod",
    "Accelerator", "Intersector", "Geometry", "MaterialTable", "TextureAtlas",
    "LightTable", "Camera", "RenderOptions", "Scene", "MAX_ATTRS", "ATTR",
    "build_light_table", "commit",
]

MAX_ATTRS = 8


class BSDFType(enum.IntEnum):
    DIFFUSE = 0
    PHONG = 1
    GGX = 2
    MIRROR = 3
    DISNEY = 4
    GLASS = 5


class ATTR:
    """Material attribute slot layout (as ``terra_tpu.scene.ATTR``)."""

    DIFFUSE_ALBEDO = 0
    PHONG_ALBEDO = 0
    PHONG_SPECULAR_COLOR = 1
    PHONG_SPECULAR_INTENSITY = 2
    GGX_ALBEDO = 0
    GGX_ROUGHNESS = 1
    GGX_METALNESS = 2
    GGX_SPECULAR = 3
    MIRROR_COLOR = 0
    GLASS_COLOR = 0
    DISNEY_BASE_COLOR = 0
    DISNEY_SPECULAR = 1
    DISNEY_SHEEN = 2
    DISNEY_CLEARCOAT = 3
    DISNEY_METAL_ROUGH = 4
    DISNEY_ANISO_SUBSURF = 5


class Integrator(enum.IntEnum):
    SIMPLE = 0
    DIRECT = 1
    DIRECT_MIS = 2
    DEBUG_MONO = 3
    DEBUG_DEPTH = 4
    DEBUG_NORMALS = 5
    DEBUG_MIS_WEIGHTS = 6


class Tonemap(enum.IntEnum):
    NONE = 0
    LINEAR = 1
    REINHARD = 2
    FILMIC = 3
    UNCHARTED2 = 4


class SamplingMethod(enum.IntEnum):
    RANDOM = 0
    STRATIFIED = 1
    HALTON = 2


class Accelerator(enum.IntEnum):
    BRUTE = 0
    BVH = 1


class LightPick(enum.IntEnum):
    UNIFORM = 0
    AREA = 1


class Intersector(enum.IntEnum):
    MT = 0
    WATERTIGHT = 1


@dataclass
class Geometry:
    """Flattened triangle soup.

    positions (V, 3) f32; tri_vidx (T, 3) i32; normals (T, 3, 3) f32
    per-corner shading normals; uvs (T, 3, 2) f32; mat_id (T,) i32;
    obj_id (T,) i32 source object (MIS same-light test).
    """

    positions: torch.Tensor
    tri_vidx: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    mat_id: torch.Tensor
    obj_id: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.tri_vidx.shape[0]

    def corners(self):
        """World-space triangle corners, (T, 3) each: views of one
        ``row_accumulate.gather`` of the positions by ``tri_vidx``."""
        return gather(self.positions, self.tri_vidx.long()).unbind(1)

    def areas(self):
        a, b, c = self.corners()
        return 0.5 * math3.length(math3.cross(b - a, c - a))


@dataclass
class MaterialTable:
    """Material rows. ``types_present``, ``tex_slots`` and
    ``emissive_textured`` are static: ``commit`` sets them from the scene,
    and the wavefront evaluates only those lobes and texture slots."""

    bsdf_type: torch.Tensor   # (M,) i32
    attrs: torch.Tensor       # (M, 8, 3) f32
    attr_tex: torch.Tensor    # (M, 8) i32, -1 = constant
    emissive: torch.Tensor    # (M, 3) f32
    emissive_tex: torch.Tensor  # (M,) i32, -1 = constant
    ior: torch.Tensor         # (M,) f32
    types_present: tuple = (0, 1, 2, 3, 4, 5)
    tex_slots: tuple = tuple(range(MAX_ATTRS))
    emissive_textured: bool = True

    @property
    def num_materials(self) -> int:
        return self.bsdf_type.shape[0]


@dataclass
class TextureAtlas:
    """All textures padded into one (NT, H, W, 3) f32 tensor; size (NT, 2)
    i32 (height, width); filter (NT,) 0 point / 1 bilinear; address (NT,)
    0 wrap / 1 mirror / 2 clamp."""

    data: torch.Tensor
    size: torch.Tensor
    filter: torch.Tensor
    address: torch.Tensor

    @staticmethod
    def empty(device) -> "TextureAtlas":
        return TextureAtlas(
            data=torch.zeros((0, 1, 1, 3), dtype=torch.float32, device=device),
            size=torch.zeros((0, 2), dtype=torch.int32, device=device),
            filter=torch.zeros((0,), dtype=torch.int32, device=device),
            address=torch.zeros((0,), dtype=torch.int32, device=device),
        )

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


@dataclass
class LightTable:
    """Flattened emissive-triangle table padded to a capacity ``Lcap``;
    ``num`` is the live count (a python int here: the host needs it)."""

    tri_idx: torch.Tensor   # (Lcap,) i32
    area: torch.Tensor      # (Lcap,) f32
    cdf: torch.Tensor       # (Lcap,) f32 area CDF over live entries
    emissive: torch.Tensor  # (Lcap, 3) f32
    mat_id: torch.Tensor    # (Lcap,) i32
    num: int


@dataclass
class Camera:
    """Pinhole camera; fov in degrees."""

    position: torch.Tensor
    direction: torch.Tensor
    up: torch.Tensor
    fov_deg: torch.Tensor

    @staticmethod
    def make(position, direction, up=(0.0, 1.0, 0.0), fov_deg=45.0, device="cuda") -> "Camera":
        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        return Camera(position=f32(position), direction=f32(direction), up=f32(up),
                      fov_deg=f32(fov_deg))


_ENUM_FIELDS = {
    "integrator": Integrator, "sampling_method": SamplingMethod,
    "accelerator": Accelerator, "tonemap": Tonemap, "intersector": Intersector,
    "light_pick": LightPick,
}


@dataclass(frozen=True)
class RenderOptions:
    """Render configuration, with the fields and defaults of
    ``terra_tpu.scene.RenderOptions``. Enum fields also accept plain ints."""

    width: int = 256
    height: int = 256
    samples_per_pixel: int = 64
    bounces: int = 4
    integrator: Integrator = Integrator.SIMPLE
    sampling_method: SamplingMethod = SamplingMethod.RANDOM
    accelerator: Accelerator = Accelerator.BVH
    tonemap: Tonemap = Tonemap.NONE
    subpixel_jitter: float = 0.0
    strata: int = 4
    manual_exposure: float = 1.0
    gamma: float = 2.2
    samples_per_launch: int = 0
    samples_per_lane: int = 1
    env_on_miss: bool = False
    rr_start_bounce: int = 0
    intersector: Intersector = Intersector.MT
    env_nee: bool = False
    light_pick: LightPick = LightPick.UNIFORM
    debug_checks: bool = False

    def __post_init__(self):
        for name, cls in _ENUM_FIELDS.items():
            object.__setattr__(self, name, cls(int(getattr(self, name))))

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


@dataclass
class Scene:
    """Committed scene: geometry, material/light tables, env, accel."""

    geometry: Geometry
    materials: MaterialTable
    textures: TextureAtlas
    lights: LightTable
    env_value: torch.Tensor  # (3,) f32
    env_tex: int             # latlong env texture id, -1 = constant
    bvh: Any                 # Optional[accel.lbvh.LBVH]

    @property
    def device(self) -> torch.device:
        return self.geometry.positions.device


def _np(t):
    return t.detach().cpu().numpy()


def build_light_table(geometry: Geometry, materials: MaterialTable,
                      capacity: Optional[int] = None) -> LightTable:
    """Scan triangles whose material has nonzero constant emissive (host
    NumPy, as the reference) into the flattened light table. Its tensors
    carry no gradient, as in the reference: an emission gradient reaches
    ``materials.emissive`` through the shaded surface only."""
    device = geometry.positions.device
    mat_id = _np(geometry.mat_id)
    tri_emissive = _np(materials.emissive)[mat_id]
    idx = np.nonzero(np.any(tri_emissive != 0.0, axis=-1))[0].astype(np.int32)
    pos = _np(geometry.positions)
    vidx = _np(geometry.tri_vidx)
    a, b, c = pos[vidx[idx, 0]], pos[vidx[idx, 1]], pos[vidx[idx, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1).astype(np.float32)

    n = len(idx)
    cap = capacity if capacity is not None else max(n, 1)
    if cap < n:
        raise ValueError(f"light table capacity {cap} < {n} emissive triangles")
    tri_idx = np.zeros((cap,), np.int32)
    areas = np.zeros((cap,), np.float32)
    cdf = np.ones((cap,), np.float32)
    emis = np.zeros((cap, 3), np.float32)
    mats = np.zeros((cap,), np.int32)
    tri_idx[:n] = idx
    areas[:n] = area
    emis[:n] = tri_emissive[idx]
    mats[:n] = mat_id[idx]
    if n > 0:
        c_ = np.cumsum(area)
        cdf[:n] = (c_ / c_[-1]).astype(np.float32)

    def dev(x):
        return torch.as_tensor(x, device=device)

    return LightTable(tri_idx=dev(tri_idx), area=dev(areas), cdf=dev(cdf),
                      emissive=dev(emis), mat_id=dev(mats), num=n)


def commit(geometry: Geometry, materials: MaterialTable,
           textures: Optional[TextureAtlas] = None, env_value=(0.0, 0.0, 0.0),
           env_tex: int = -1, accelerator: Accelerator = Accelerator.BRUTE,
           light_capacity: Optional[int] = None, leaf_size: Optional[int] = None,
           bvh_builder: str = "sah") -> Scene:
    """Build a committed :class:`Scene` on the geometry's device: light
    table, static material metadata and, for ``Accelerator.BVH``, the
    native tree of ``bvh_builder`` ("sah", binned SAH, or "lbvh", Morton;
    ``leaf_size`` defaults to ``lbvh.DEFAULT_LEAF_SIZE``). The whole
    build is the span ``terra.scene.commit`` (``profile``), the tree's
    ``terra.scene.bvh_build`` inside it."""
    with profiler.span("terra.scene.commit"):
        device = geometry.positions.device
        bvh = None
        if accelerator == Accelerator.BVH:
            from .accel import lbvh

            with profiler.span("terra.scene.bvh_build"):
                bvh = lbvh.build(geometry, leaf_size=leaf_size, builder=bvh_builder)
        used = np.unique(_np(materials.bsdf_type)[np.unique(_np(geometry.mat_id))])
        attr_tex_np = _np(materials.attr_tex)
        tex_slots = tuple(s for s in range(attr_tex_np.shape[1])
                          if np.any(attr_tex_np[:, s] >= 0))
        materials = dataclasses.replace(
            materials,
            types_present=tuple(int(t) for t in used),
            tex_slots=tex_slots,
            emissive_textured=bool(np.any(_np(materials.emissive_tex) >= 0)),
        )
        return Scene(
            geometry=geometry,
            materials=materials,
            textures=textures if textures is not None else TextureAtlas.empty(device),
            lights=build_light_table(geometry, materials, light_capacity),
            env_value=torch.as_tensor(np.asarray(env_value, np.float32), device=device),
            env_tex=int(env_tex),
            bvh=bvh,
        )
