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

The sharded steps (:func:`make_grad_fn_sharded`,
:func:`make_train_step_sharded`, ``recover(mesh=...)``) split pixel rows
and samples over the ranks of a ``parallel.mesh.Mesh`` on
``torch.distributed`` and all-reduce the gradient of every chunk.

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

from .checkpoint import tree_leaves, tree_map, tree_unflatten
from .ops import rng as rng_mod
from .parallel.mesh import Mesh, shard_sizes
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
    return _optimizer_step(lambda params, *args: value_and_grad(loss_fn, params, *args),
                           optimizer, spp or opts.samples_per_pixel)


def _optimizer_step(grads_fn, optimizer, spp: int):
    """step(state, scene, key) -> (state, loss): ``grads_fn(params, scene,
    key, sample_offset)`` gives (loss, gradients in leaf order), the
    optimiser steps on them; the offset advances by ``spp`` a step."""
    def step(state: TrainState, scene: Scene, key):
        params, opt = state.params, state.opt_state
        if opt is None:
            params = _trainable(params)
            opt = optimizer(tree_leaves(params))
        loss, grads = grads_fn(params, scene, key, state.step * spp)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g
        opt.step()
        return TrainState(params, opt, state.step + 1), loss

    return step


def make_grad_fn_sharded(cam: Camera, opts: RenderOptions, target, mesh,
                         spp: Optional[int] = None, grad_chunks: int = 1):
    """grads_fn(params, scene, key, sample_offset) -> (loss, gradient tree):
    the loss of :func:`make_loss_fn` and its gradient, with rows and
    samples sharded over ``mesh`` (a ``parallel.mesh.Mesh``). Every rank
    returns the same loss and the same gradient bits.

    Each rank renders its row band and sample slice in ``grad_chunks``
    chunks, each forward recorded by autograd. The chunk sums are added and
    all-reduced over the sample group *detached*, which gives the band's
    image; the loss is all-reduced over the row group. The cotangent of the
    band's accumulator, ``2 (img - tgt) / (denom * spp)``, is shared by
    every sample shard (the transpose of a sum is a broadcast), so each
    chunk's backward ``torch.autograd.grad(acc_i, params, cot)`` gives that
    chunk's part of the whole-step gradient, which is all-reduced over every
    rank right after that backward. No collective sits inside the autograd
    graph: the reference's earlier form, a ``psum`` inside the loss,
    transposed to another ``psum`` and scaled the gradients by the number
    of sample shards (``terra_tpu/optim.py:178-186``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (distributed.initialize, then "
                        f"make_mesh), not {type(mesh).__name__}")
    spp_eff = spp or opts.samples_per_pixel
    rows_per, spp_per = shard_sizes(mesh, opts.height, spp_eff)
    if spp_per % grad_chunks:
        raise ValueError(f"{spp_per} samples per shard do not split into {grad_chunks} chunks")
    sub = spp_per // grad_chunks
    denom = float(opts.width * opts.height * 3)
    row0 = mesh.row * rows_per
    tgt = torch.as_tensor(target)[row0:row0 + rows_per].to(mesh.device)

    def grads_fn(params, scene: Scene, key, sample_offset):
        leaves = tree_leaves(params)
        base = int(sample_offset) + mesh.sample * spp_per
        with deterministic():
            accs = [render_rows(inject_params(scene, params), inject_camera(cam, params), opts,
                                key, base + i * sub, sub, row0, rows_per)
                    for i in range(grad_chunks)]
            acc = accs[0].detach().clone()
            for a in accs[1:]:
                acc = acc + a.detach()
            img = mesh.all_reduce(acc, "samples") / float(spp_eff)
            loss = mesh.all_reduce((torch.sum((img - tgt) ** 2) / denom).reshape(1), "rows")[0]
            cot = 2.0 * (img - tgt) / (denom * float(spp_eff))
            grads = None
            for a in accs:
                g = torch.autograd.grad(a, leaves, cot, allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
                flat = mesh.all_reduce(torch.cat([x.reshape(-1) for x in g]))  # per-chunk reduce
                g = list(torch.split(flat, [x.numel() for x in g]))
                g = [x.reshape(p.shape) for p, x in zip(leaves, g)]
                grads = g if grads is None else [x + y for x, y in zip(grads, g)]
        return loss.detach(), tree_unflatten(params, grads)

    return grads_fn


def make_train_step_sharded(cam: Camera, opts: RenderOptions, target, optimizer, mesh,
                            spp: Optional[int] = None, grad_chunks: int = 1):
    """The sharded :func:`make_train_step`: the gradient of
    :func:`make_grad_fn_sharded` (``grad_chunks`` chunks, each all-reduced
    right after its backward), then every rank steps its own optimiser on
    the same gradient bits, so the parameters stay bit-identical across
    ranks."""
    return _optimizer_step(make_grad_fn_sharded(cam, opts, target, mesh, spp=spp,
                                                grad_chunks=grad_chunks),
                           optimizer, spp or opts.samples_per_pixel)


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
    step. With ``mesh`` (a ``parallel.mesh.Mesh``) every rank runs the
    loop on the sharded step of :func:`make_train_step_sharded`, with the
    same clipping and refit, so every rank ends with the same scene."""
    optimizer = functools.partial(torch.optim.Adam, lr=learning_rate)
    params = _trainable(extract_params(scene_init, fields, cam=cam))
    attr_cap = None
    if clip_to_physical and "attrs" in params:
        attrs = params["attrs"].detach()
        attr_cap = torch.where(attrs > 1.0, 1e4, 1.0).to(attrs.dtype)
    state = TrainState(params, optimizer(tree_leaves(params)), 0)
    key = rng_mod.key_from_seed(seed)
    if mesh is None:
        step_fn = make_train_step(cam, opts, target, optimizer)
    else:
        step_fn = make_train_step_sharded(cam, opts, target, optimizer, mesh)
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
