"""Plain PyTorch reference of an inverse-rendering step: the mean image of
``spp`` samples a pixel through :mod:`pathtrace`'s paths, the mean squared
error against the target, its gradient in the parameters by autograd, one
Adam step (Kingma and Ba, with PyTorch's defaults: betas 0.9 and 0.999,
eps 1e-8), and the projection to physical values (attributes into [0, 1],
or [0, 1e4] for slots that started above 1; textures non-negative). The
reference builds its own BVH from the moved positions for every step."""
from __future__ import annotations

import numpy as np
import torch

from . import pathtrace

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def loss_and_grads(arrays: dict, accelerator: str, params: dict, opts: dict, cam: dict, key,
                   offset: int, target, bands: int = 4, tf32: bool = False):
    """(loss, {name: gradient}) of the step that draws samples ``offset ..
    offset + spp - 1`` of every pixel under ``key``. Rows are rendered
    and differentiated in ``bands`` bands, the gradients summed."""
    dev = target.device
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    moved = dict(arrays, positions=leaves["positions"].detach().cpu().numpy()) \
        if "positions" in leaves else arrays
    width, height, spp = int(opts["width"]), int(opts["height"]), int(opts["spp"])
    count = float(width * height * 3)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    scene = pathtrace.Scene(moved, dev, accelerator, params=leaves, tf32=tf32)
    rows = -(-height // bands)
    for r0 in range(0, height, rows):
        r1 = min(r0 + rows, height)
        pix = torch.arange(r0 * width, r1 * width, device=dev)
        lane_px = pix.repeat_interleave(spp)
        lane_s = torch.arange(spp, device=dev).repeat(pix.shape[0]) + offset
        rad = pathtrace.trace(scene, opts, cam, key, lane_px, lane_s)
        img = rad.reshape(r1 - r0, width, spp, 3).sum(dim=2) / float(spp)
        part = torch.sum((img - target[r0:r1]) ** 2) / count
        if part.requires_grad:  # else no lane of the band reached the scene
            g = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
            for k, gk in zip(leaves, g):
                if gk is not None:
                    grads[k] += gk
        total += part.detach().double()
    return float(total), grads


class Adam:
    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        b1, b2 = BETAS
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p - self.lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        return out


def clip(params: dict, attr_cap) -> dict:
    out = dict(params)
    if "attrs" in out:
        out["attrs"] = torch.minimum(torch.clamp(out["attrs"], min=0.0), attr_cap)
    if "textures" in out:
        out["textures"] = torch.clamp(out["textures"], min=0.0)
    return out


def follow(arrays: dict, accelerator: str, params: dict, opts: dict, cam: dict, key, target,
           lr: float, steps: int, tf32: bool = False) -> dict:
    """``steps`` steps from ``params``: the loss of each, the first
    step's gradient, and the parameters after the last."""
    attr_cap = torch.where(params["attrs"] > 1.0, 1e4, 1.0) if "attrs" in params else None
    adam = Adam(params, lr)
    losses, first = [], None
    p = {k: v.detach().clone() for k, v in params.items()}
    spp = int(opts["spp"])
    for i in range(steps):
        loss, g = loss_and_grads(arrays, accelerator, p, opts, cam, key, i * spp, target,
                                 tf32=tf32)
        losses.append(loss)
        if first is None:
            first = g
        p = clip(adam.step(p, g), attr_cap)
    return {"losses": losses, "grad": first, "params": p}


def tree_boxes(positions, vidx, leaf_tri, node_left, node_right):
    """Bounds of each node of a binary tree (internal rows, then leaf rows;
    children in one id space) over the triangles its leaves hold."""
    pos = np.asarray(positions, np.float64)
    corners = pos[np.asarray(vidx)]
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    ni = len(node_left)
    leaf_tri = np.asarray(leaf_tri)
    bmin = np.empty((ni + len(leaf_tri), 3))
    bmax = np.empty_like(bmin)
    bmin[ni:] = lo[leaf_tri].min(axis=1)
    bmax[ni:] = hi[leaf_tri].max(axis=1)
    done = np.zeros(ni + len(leaf_tri), bool)
    done[ni:] = True
    left, right = np.asarray(node_left), np.asarray(node_right)
    while not done[:ni].all():
        ready = ~done[:ni] & done[left] & done[right]
        idx = np.nonzero(ready)[0]
        bmin[idx] = np.minimum(bmin[left[idx]], bmin[right[idx]])
        bmax[idx] = np.maximum(bmax[left[idx]], bmax[right[idx]])
        done[idx] = True
    return bmin, bmax
