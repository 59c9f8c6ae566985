"""Scene editing: object transforms with a cheap re-commit (port of
``terra_tpu/edit.py``).

An object move is a vertex-buffer update: the BVH is refit (the topology
is unchanged) instead of rebuilt, and the light table is rebuilt, since an
emissive object's areas may change.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .accel import lbvh
from .scene import Scene, build_light_table

__all__ = ["list_objects", "move_object", "transform_object"]


def list_objects(scene: Scene) -> List[Dict]:
    """Object inventory: id, triangle count and bounding box."""
    obj = scene.geometry.obj_id.cpu().numpy()
    vidx = scene.geometry.tri_vidx.cpu().numpy()
    pos = scene.geometry.positions.detach().cpu().numpy()
    out = []
    for oid in np.unique(obj):
        tris = np.nonzero(obj == oid)[0]
        p = pos[np.unique(vidx[tris].reshape(-1))]
        out.append(dict(object_id=int(oid), triangles=int(len(tris)),
                        bbox_min=p.min(axis=0).tolist(), bbox_max=p.max(axis=0).tolist()))
    return out


def _object_vertex_mask(scene: Scene, object_id: int) -> torch.Tensor:
    obj = scene.geometry.obj_id.cpu().numpy()
    vidx = scene.geometry.tri_vidx.cpu().numpy()
    mask = np.zeros(scene.geometry.positions.shape[0], bool)
    mask[np.unique(vidx[obj == object_id].reshape(-1))] = True
    return torch.as_tensor(mask, device=scene.device)


def transform_object(scene: Scene, object_id: int, fn) -> Scene:
    """Apply ``fn(positions) -> positions`` to the vertices of one object,
    refit the BVH and rebuild the light table."""
    mask = _object_vertex_mask(scene, object_id)
    pos = scene.geometry.positions
    geom = dataclasses.replace(scene.geometry,
                               positions=torch.where(mask[:, None], fn(pos), pos))
    bvh = lbvh.refit(scene.bvh, geom) if scene.bvh is not None else None
    lights = build_light_table(geom, scene.materials, capacity=scene.lights.tri_idx.shape[0])
    return dataclasses.replace(scene, geometry=geom, bvh=bvh, lights=lights)


def move_object(scene: Scene, object_id: int, delta) -> Scene:
    """Translate one object by ``delta`` (x, y, z)."""
    delta = torch.as_tensor(np.asarray(delta, np.float32), device=scene.device)
    return transform_object(scene, object_id, lambda p: p + delta)
