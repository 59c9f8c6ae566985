"""Carry a committed scene and a camera across from the JAX package.

The port never imports JAX. The caller flattens the JAX ``Scene`` or
``Camera`` into nested dicts of NumPy arrays and plain values, one key per
dataclass field (``bvh`` may be None), and these functions build the
port's objects from them on ``device``, so that both packages render the
same committed scene with the same tree and BVH4 overlay. BVH fields the
port does not read (the stackless threads) are ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.lbvh import LBVH
from .scene import Camera, Geometry, LightTable, MaterialTable, Scene, TextureAtlas

__all__ = ["scene_from_numpy", "camera_from_numpy"]


def _t(x, device):
    return torch.tensor(np.asarray(x), device=device)


def _tensors(d: dict, keys, device) -> dict:
    return {k: _t(d[k], device) for k in keys}


def _fields(cls, d: dict, device):
    return cls(**_tensors(d, cls.__dataclass_fields__, device))


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    """Scene from the nested field dict of a committed JAX scene."""
    mats = d["materials"]
    materials = MaterialTable(
        **_tensors(mats, ("bsdf_type", "attrs", "attr_tex", "emissive", "emissive_tex", "ior"),
                   device),
        types_present=tuple(int(t) for t in mats["types_present"]),
        tex_slots=tuple(int(s) for s in mats["tex_slots"]),
        emissive_textured=bool(mats["emissive_textured"]))
    lt = d["lights"]
    lights = LightTable(**_tensors(lt, ("tri_idx", "area", "cdf", "emissive", "mat_id"), device),
                        num=int(lt["num"]))
    bvh = None
    if d.get("bvh") is not None:
        b = d["bvh"]
        bvh = LBVH(**_tensors(b, ("node_min", "node_max", "node_left", "node_right", "leaf_tri",
                                  "tri_order", "wide_child", "wide_src"), device),
                   leaf_size=int(b["leaf_size"]), num_leaves=int(b["num_leaves"]),
                   depth=int(b["depth"]), num_wide=int(b["num_wide"]),
                   wide_depth=int(b["wide_depth"]))
    return Scene(
        geometry=_fields(Geometry, d["geometry"], device),
        materials=materials,
        textures=_fields(TextureAtlas, d["textures"], device),
        lights=lights,
        env_value=_t(np.asarray(d["env_value"], np.float32), device),
        env_tex=int(d["env_tex"]),
        bvh=bvh,
    )


def camera_from_numpy(d: dict, device="cuda") -> Camera:
    """Camera from the field dict of a JAX camera."""
    return _fields(Camera, d, device)
