"""Carry a committed scene, a camera and a training run across from the JAX
package.

The port never imports JAX. The caller flattens the JAX ``Scene`` or
``Camera`` into nested dicts of NumPy arrays and plain values, one key per
dataclass field (``bvh`` may be None), and these functions build the
port's objects from them on ``device``, so that both packages render the
same committed scene with the same tree, threads and BVH4 overlay (the
reference's unused ``node_is_leaf`` is dropped). ``params_from_numpy`` and
``adam_state_from_numpy`` take ``optim.extract_params`` output and an optax
Adam state as NumPy, so that a JAX training run resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.lbvh import LBVH
from .checkpoint import tree_leaves, tree_map
from .scene import Camera, Geometry, LightTable, MaterialTable, Scene, TextureAtlas

__all__ = ["scene_from_numpy", "camera_from_numpy", "params_from_numpy", "adam_state_from_numpy"]


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
                                  "tri_order", "dfs_next", "dfs_skip", "wide_child", "wide_src"),
                                 device),
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


def params_from_numpy(params: dict, device="cuda") -> dict:
    """Parameter tree of ``terra_tpu.optim.extract_params`` (nested dicts
    of NumPy arrays, ``"camera"`` a dict of its own) as tensors on ``device``."""
    return tree_map(lambda x: _t(x, device), params)


def adam_state_from_numpy(state: dict, params: dict, lr: float):
    """A ``torch.optim.Adam`` with learning rate ``lr`` over the tensors of
    ``params`` (autograd leaves, as ``optim.make_train_step`` keeps them),
    holding optax's ``ScaleByAdamState`` given as ``{"count", "mu", "nu"}``
    (``mu``/``nu`` trees of ``params``' structure, NumPy). optax's moments
    are torch's ``exp_avg``/``exp_avg_sq`` and its count is torch's step;
    both apply the same bias-corrected update. On CUDA parameters the
    optimiser is ``capturable`` (its step counter on the parameters'
    device), so the captured training step of ``optim`` replays it."""
    leaves = tree_leaves(params)
    opt = torch.optim.Adam(leaves, lr=lr, capturable=any(p.is_cuda for p in leaves))
    step = float(np.asarray(state["count"]))
    for p, mu, nu in zip(leaves, tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        opt.state[p] = {"step": torch.tensor(step, dtype=torch.float32, device=p.device),
                        "exp_avg": _t(mu, p.device), "exp_avg_sq": _t(nu, p.device)}
    return opt
