"""Inverse rendering: pixel-loss gradients on scene parameters (port of
``terra_tpu/optim.py``).

Recover BSDF attributes and emission (and optionally vertex positions,
texture data or the camera pose) by gradient descent on a pixel loss (see
PARAM_FIELDS). The wavefront of :func:`render.trace` runs under autograd:
the random numbers are counter-based, so a backward pass replays the
forward's decisions exactly, and the discrete choices (the raycast's hit,
lobe picks, roulette) carry no gradient, as in the reference. On a BVH
scene every forward raycast is the CUDA traversal kernel, whose results
are stopped from the gradient like the reference's Pallas kernel; it has
no backward kernel.

``optax.adam(lr)`` becomes ``torch.optim.Adam`` with ``lr`` (the same
default betas (0.9, 0.999) and eps 1e-8): an ``optimizer`` argument here
is a callable that takes the list of parameter tensors and returns a
``torch.optim.Optimizer``, such as ``functools.partial(torch.optim.Adam,
lr=3e-2)``. It updates the parameter tensors in place.

Known limitation, as in the reference: vertex-position gradients flow
through the interior terms only (the differentiable hit re-evaluation and
the shading that depends on it); a silhouette or shadow edge moving across
a pixel contributes no gradient.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from .checkpoint import tree_leaves, tree_map
from .ops import rng as rng_mod
from .render import render_rows
from .scene import Camera, RenderOptions, Scene

__all__ = ["PARAM_FIELDS", "inject_params", "extract_params", "inject_camera",
           "render_mean_image", "make_loss_fn", "TrainState", "make_train_step",
           "make_train_step_sharded", "make_grad_fn_sharded", "recover"]

# Parameter groups that can be optimised: attrs/emissive/positions/textures
# are fields of the Scene; "camera" is the Camera's position/direction/fov.
PARAM_FIELDS = ("attrs", "emissive", "positions", "textures", "camera")


def extract_params(scene: Scene, fields=("attrs", "emissive"),
                   cam: Optional[Camera] = None) -> Dict[str, Any]:
    """The requested continuous tensors of a scene (and camera)."""
    out: Dict[str, Any] = {}
    for f in fields:
        if f == "attrs":
            out["attrs"] = scene.materials.attrs
        elif f == "emissive":
            out["emissive"] = scene.materials.emissive
        elif f == "positions":
            out["positions"] = scene.geometry.positions
        elif f == "textures":
            if scene.textures is None or scene.textures.num_textures == 0:
                raise ValueError("scene has no texture atlas to optimize")
            out["textures"] = scene.textures.data
        elif f == "camera":
            if cam is None:
                raise ValueError("pass cam= to extract camera parameters")
            out["camera"] = {"position": cam.position, "direction": cam.direction,
                             "fov_deg": cam.fov_deg}
        else:
            raise KeyError(f)
    return out


def inject_params(scene: Scene, params: Dict[str, Any]) -> Scene:
    """The scene with parameter tensors replaced (the "camera" group is not
    part of the scene; see :func:`inject_camera`)."""
    mats, geom, tex = scene.materials, scene.geometry, scene.textures
    if "attrs" in params:
        mats = dataclasses.replace(mats, attrs=params["attrs"])
    if "emissive" in params:
        mats = dataclasses.replace(mats, emissive=params["emissive"])
    if "positions" in params:
        geom = dataclasses.replace(geom, positions=params["positions"])
    if "textures" in params:
        tex = dataclasses.replace(tex, data=params["textures"])
    return dataclasses.replace(scene, materials=mats, geometry=geom, textures=tex)


def inject_camera(cam: Camera, params: Dict[str, Any]) -> Camera:
    """The camera with the "camera" group applied (itself when the group is
    absent; a partial group overrides only its keys). Ray generation
    normalises the direction, so an unnormalised one stays valid."""
    c = params.get("camera")
    if c is None:
        return cam
    return dataclasses.replace(cam, position=c.get("position", cam.position),
                               direction=c.get("direction", cam.direction),
                               fov_deg=c.get("fov_deg", cam.fov_deg))


def render_mean_image(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset,
                      spp: int, row0=0, rows: int = 0):
    """Differentiable mean image (rows, W, 3) over ``spp`` samples per
    pixel from ``sample_offset``. The fixed-depth wavefront carries the
    gradient; persistent lanes (``samples_per_lane > 1``) refuse it."""
    rows = rows or opts.height
    acc = render_rows(scene, cam, opts, key, int(sample_offset), spp, int(row0), rows)
    return acc / float(spp)


def make_loss_fn(cam: Camera, opts: RenderOptions, target, spp: Optional[int] = None):
    """loss(params, scene, key, sample_offset) -> the scalar MSE between the
    rendered mean image and ``target`` (H, W, 3)."""
    spp = spp or opts.samples_per_pixel

    def loss_fn(params, scene, key, sample_offset):
        img = render_mean_image(inject_params(scene, params), inject_camera(cam, params), opts,
                                key, sample_offset, spp)
        return torch.mean((img - target) ** 2)

    return loss_fn


class TrainState(NamedTuple):
    """params: the parameter tree; opt_state: the ``torch.optim.Optimizer``
    over its tensors (None before the first step); step: steps taken."""

    params: Dict[str, Any]
    opt_state: Any
    step: int


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block (warning, not
    raising, where an op has none), restored after: a gradient step's
    index backwards then sum in a fixed order on the card, so two steps
    from the same state give the same bits."""
    prev, prev_warn = (torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _trainable(params):
    """Copies of the parameter tensors that are autograd leaves."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree) of ``loss_fn(params, *args)`` at ``params``
    (tensors that require grad), in deterministic mode."""
    leaves = tree_leaves(params)
    with deterministic():
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_step(cam: Camera, opts: RenderOptions, target, optimizer,
                    spp: Optional[int] = None):
    """step(state, scene, key) -> (state, loss): one Adam-style step on the
    loss of :func:`make_loss_fn`. Each step draws fresh sample indices
    (the offset advances by ``spp`` a step). A state whose ``opt_state``
    is None starts ``optimizer`` on trainable copies of its params; the
    optimiser then updates those tensors in place."""
    loss_fn = make_loss_fn(cam, opts, target, spp)
    spp_eff = spp or opts.samples_per_pixel

    def step(state: TrainState, scene: Scene, key):
        params, opt = state.params, state.opt_state
        if opt is None:
            params = _trainable(params)
            opt = optimizer(tree_leaves(params))
        loss, grads = value_and_grad(loss_fn, params, scene, key, state.step * spp_eff)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        opt.step()
        return TrainState(params, opt, state.step + 1), loss

    return step


def make_train_step_sharded(*args, **kwargs):
    """The sharded step waits for the port's ``torch.distributed`` layer
    (ROADMAP queue A11)."""
    raise NotImplementedError("make_train_step_sharded needs torch.distributed "
                              "(ROADMAP queue A11); use make_train_step")


def make_grad_fn_sharded(*args, **kwargs):
    """The sharded gradient waits for ROADMAP queue A11, as
    :func:`make_train_step_sharded` does."""
    raise NotImplementedError("make_grad_fn_sharded needs torch.distributed "
                              "(ROADMAP queue A11)")


def recover(scene_init: Scene, cam: Camera, opts: RenderOptions, target,
            fields=("attrs", "emissive"), steps: int = 100, learning_rate: float = 5e-2,
            seed: int = 0, mesh=None, log_every: int = 0, clip_to_physical: bool = True):
    """Run the inverse-rendering loop with Adam; returns (scene_recovered,
    losses), or (scene_recovered, cam_recovered, losses) when "camera" is
    among the fields.

    ``clip_to_physical`` projects the parameters after each step: attribute
    values to [0, attr_cap], where attr_cap keeps slots that started above
    1 (exponents) free up to 1e4, emission and texture data to >= 0. With
    "positions" on a BVH scene the tree is refit on the host after every
    step. ``mesh`` (the sharded loop) waits for ROADMAP queue A11."""
    if mesh is not None:
        raise NotImplementedError("recover(mesh=...) needs torch.distributed "
                                  "(ROADMAP queue A11)")
    optimizer = functools.partial(torch.optim.Adam, lr=learning_rate)
    params = _trainable(extract_params(scene_init, fields, cam=cam))
    attr_cap = None
    if clip_to_physical and "attrs" in params:
        attrs = params["attrs"].detach()
        attr_cap = torch.where(attrs > 1.0, 1e4, 1.0).to(attrs.dtype)
    state = TrainState(params, optimizer(tree_leaves(params)), 0)
    key = rng_mod.key_from_seed(seed)
    step_fn = make_train_step(cam, opts, target, optimizer)
    refit_bvh = "positions" in fields and scene_init.bvh is not None
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, scene_init, key)
        if clip_to_physical:
            with torch.no_grad():
                p = state.params
                if "attrs" in p:
                    p["attrs"].copy_(torch.minimum(torch.clamp(p["attrs"], min=0.0), attr_cap))
                for k in ("emissive", "textures"):
                    if k in p:
                        p[k].clamp_(min=0.0)
        if refit_bvh:
            # moved vertices move the triangle bounds: refit the boxes on
            # the host (fixed topology, so no rebuild)
            from .accel import lbvh

            geom = dataclasses.replace(scene_init.geometry,
                                       positions=state.params["positions"].detach())
            scene_init = dataclasses.replace(scene_init, bvh=lbvh.refit(scene_init.bvh, geom))
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.6f}")
    final = tree_map(lambda t: t.detach(), state.params)
    if "camera" in fields:
        return inject_params(scene_init, final), inject_camera(cam, final), losses
    return inject_params(scene_init, final), losses
