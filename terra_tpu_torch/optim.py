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

Training units: the JAX package runs each of :func:`make_train_step`,
:func:`make_train_step_sharded` and :func:`make_grad_fn_sharded` as one
jitted device program. Here each is a ``graphs.TrainUnit`` on a CUDA
scene: its stages (forward recorded by autograd, backward, the
optimiser's update) are captured once per (scene, camera, optimiser,
target, options) and replayed every step, with the key and the sample
offset in an input buffer and the parameters, the optimiser state and
the tree's boxes read where they lie. On CPU tensors the same stages run
eagerly. :func:`value_and_grad` of :func:`make_loss_fn` is the eager step,
every op dispatched from the host.

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

from . import graphs
from .checkpoint import tree_leaves, tree_map, tree_unflatten
from .ops import rng as rng_mod
from .parallel.mesh import Mesh, shard_sizes
from .profile import profiler
from .render import _GradBody, _set_inputs, render_rows
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
    acc = render_rows(scene, cam, opts, key, sample_offset, spp, row0, rows)
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
    from the same state give the same bits. The small tables' one-hot
    products (``ops/onehot.py``) are cuBLAS products, which repeat their
    bits with the ``CUBLAS_WORKSPACE_CONFIG`` that importing the package
    sets before the first cuBLAS call (else PyTorch warns here)."""
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


def _grads(outputs, leaves, cotangent=None) -> list:
    """``torch.autograd.grad`` of ``outputs`` in ``leaves``, zeros for a
    leaf the outputs do not reach."""
    grads = torch.autograd.grad(outputs, leaves, cotangent, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree) of ``loss_fn(params, *args)`` at ``params``
    (tensors that require grad), in deterministic mode, every op
    dispatched from the host: the eager counterpart of the captured
    training step of :func:`make_train_step`."""
    with deterministic():
        loss = loss_fn(params, *args)
        grads = _grads(loss, tree_leaves(params))
    return loss.detach(), grads


def _capturable(opt):
    """Let ``opt`` be captured: a group of CUDA parameters steps with
    device-side counters (``capturable``, where the optimiser has the
    option), and a step counter already kept moves to its parameter's
    device. Returns ``opt``."""
    for group in opt.param_groups:
        if "capturable" in group and any(p.is_cuda for p in group["params"]):
            group["capturable"] = True
        for p in group["params"]:
            step = opt.state.get(p, {}).get("step")
            if isinstance(step, torch.Tensor) and step.device != p.device:
                opt.state[p]["step"] = step.to(p.device)
    return opt


def _start(state: TrainState, optimizer):
    """(params, optimiser) of a step: a state whose ``opt_state`` is None
    starts ``optimizer`` on trainable copies of its params."""
    params, opt = state.params, state.opt_state
    if opt is None:
        params = _trainable(params)
        opt = optimizer(tree_leaves(params))
    return params, _capturable(opt)


class _Body:
    """What the training bodies share: the differentiable forward
    (``render._GradBody``) on the scene and camera with the parameters
    injected, the stages run in deterministic mode, and the save and
    restore around ``graphs.TrainUnit``'s warm-up, which steps the
    optimiser. On the CPU the body is the unit (``replay`` is ``run``)."""

    cot = None

    def __init__(self, label, scene, cam, opts, spp_chunk, row0, rows, params, opt, target):
        self.label = label
        self.forward = _GradBody(scene, opts, spp_chunk, row0, rows)
        self.inputs = self.forward.inputs
        self.scene, self.cam, self.params, self.opt, self.target = scene, cam, params, opt, target
        self.leaves = tree_leaves(params)

    @property
    def keep(self) -> tuple:
        return (self.inputs, self.forward.leaf_of, self.target, self.cot, self.leaves)

    def _render(self, chunk_offset: int = 0):
        return self.forward(inject_params(self.scene, self.params),
                            inject_camera(self.cam, self.params), chunk_offset)

    def run(self, stage: str):
        with deterministic():
            return self._run(stage)

    replay = run

    def save(self):
        with torch.no_grad():
            params = [p.detach().clone() for p in self.leaves]
            state = {} if self.opt is None else {
                p: {k: v.clone() for k, v in self.opt.state[p].items()
                    if isinstance(v, torch.Tensor)}
                for p in self.leaves if p in self.opt.state}
        return params, state

    def restore(self, saved) -> None:
        """The parameters and optimiser state as :meth:`save` found them;
        state the warm-up created (an optimiser's first step) goes back to
        zeros, its value before a first step."""
        params, state = saved
        with torch.no_grad():
            for p, x in zip(self.leaves, params):
                p.copy_(x)
            if self.opt is None:
                return
            for p in self.leaves:
                old = state.get(p, {})
                for k, v in self.opt.state.get(p, {}).items():
                    if not isinstance(v, torch.Tensor):
                        continue
                    if k in old:
                        v.copy_(old[k])
                    else:
                        v.zero_()


class _StepBody(_Body):
    """One single-device training step in three stages: ``forward`` (the
    mean image over ``spp`` samples and the MSE against ``target``, as
    :func:`make_loss_fn` computes it), ``backward`` (the gradient of that
    loss, set as every parameter's ``.grad``) and ``update`` (the
    optimiser's step). The same ops as :func:`value_and_grad` and a step
    of the optimiser, so the same bits."""

    stages = ("forward", "backward", "update")

    def __init__(self, scene, cam, opts, target, spp, params, opt):
        super().__init__(f"train_step({opts.width}x{opts.height}, {spp} spp, {opts.bounces} "
                         f"bounces, {sorted(params)})", scene, cam, opts, spp, 0, opts.height,
                         params, opt, target)
        self.spp = spp
        self._loss = None

    def _run(self, stage):
        if stage == "forward":
            self._loss = torch.mean((self._render() / float(self.spp) - self.target) ** 2)
            return self._loss.detach()
        if stage == "backward":
            grads = _grads(self._loss, self.leaves)
            self._loss = None  # the autograd graph goes with its last reference
            for p, g in zip(self.leaves, grads):
                p.grad = g
            return grads
        return self.opt.step()


def _unit(kind: str, scene: Scene, cam: Camera, opt, params, static, make_body):
    """The training unit of ``kind`` (see ``graphs.train_unit``): keyed on
    the scene and camera (weakly), the optimiser (weakly), its groups'
    settings and its state table (``load_state_dict`` replaces both), the
    parameters' identity and ``static`` (target, options, samples,
    chunks); the parameters, the optimiser state and the tree's boxes are
    read at each replay."""
    leaves = tree_leaves(params)
    owners = (scene, cam) if opt is None else (scene, cam, opt)
    watch = () if opt is None else (opt.param_groups, ("state", id(opt.state)))
    moving = () if scene.bvh is None else (scene.bvh.node_min, scene.bvh.node_max)
    key = (kind, static, tuple(sorted(params)), tuple((id(p), p.data_ptr()) for p in leaves))
    return graphs.train_unit(owners, key, make_body, moving=moving, watch=watch)


def _target_key(target) -> tuple:
    return (id(target), target.data_ptr(), tuple(target.shape))


def make_train_step(cam: Camera, opts: RenderOptions, target, optimizer,
                    spp: Optional[int] = None):
    """step(state, scene, key) -> (state, loss): one optimiser step on the
    loss of :func:`make_loss_fn`. Each step draws fresh sample indices
    (the offset advances by ``spp`` a step). A state whose ``opt_state``
    is None starts ``optimizer`` on trainable copies of its params; the
    optimiser then updates those tensors in place.

    On a CUDA scene the step is a training unit (``graphs.TrainUnit``)
    captured on the first call for (scene, camera, optimiser, options) and
    replayed on every later one: forward, backward and the optimiser's
    update, with the key and the sample offset copied into its input
    buffer. A capture that fails raises. On the CPU the same stages run
    eagerly. ``value_and_grad(make_loss_fn(...))`` is the eager step.

    The three replays and the loss's copy are the hot span
    ``terra.train.step`` (``profile``); the capture, on a first call,
    stays outside it."""
    spp = spp or opts.samples_per_pixel

    def step(state: TrainState, scene: Scene, key):
        params, opt = _start(state, optimizer)
        unit = _unit("step", scene, cam, opt, params, (opts, spp, _target_key(target)),
                     lambda: _StepBody(scene, cam, opts, target, spp, params, opt))
        with profiler.hot("terra.train.step"):
            _set_inputs(unit.inputs, key, state.step * spp)
            loss = unit.replay("forward")
            unit.replay("backward")
            unit.replay("update")
            loss = loss.clone()
        return TrainState(params, opt, state.step + 1), loss

    return step


class _ShardPlan(NamedTuple):
    """One rank's share of a sharded step: rows [row0, row0 + rows_per) of
    the target (``tgt``), ``spp_per`` samples from ``mesh.sample *
    spp_per`` in ``chunks`` chunks of ``sub``; ``spp`` and ``denom``
    normalise the whole image."""

    rows_per: int
    row0: int
    spp: int
    spp_per: int
    chunks: int
    sub: int
    denom: float
    tgt: torch.Tensor


def _plan_key(plan: _ShardPlan) -> tuple:
    return (*plan[:-1], _target_key(plan.tgt))


def _shard_plan(opts: RenderOptions, target, mesh, spp, grad_chunks: int) -> _ShardPlan:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (distributed.initialize, then "
                        f"make_mesh), not {type(mesh).__name__}")
    spp_eff = spp or opts.samples_per_pixel
    rows_per, spp_per = shard_sizes(mesh, opts.height, spp_eff)
    if spp_per % grad_chunks:
        raise ValueError(f"{spp_per} samples per shard do not split into {grad_chunks} chunks")
    row0 = mesh.row * rows_per
    tgt = torch.as_tensor(target)[row0:row0 + rows_per].to(mesh.device)
    return _ShardPlan(rows_per, row0, spp_eff, spp_per, grad_chunks, spp_per // grad_chunks,
                      float(opts.width * opts.height * 3), tgt)


class _ShardedBody(_Body):
    """One rank's sharded gradient in stages: ``forward{i}`` (chunk i's
    band sum, recorded by autograd; every chunk keeps its saved tensors
    until its backward, as ``jax.vjp`` keeps its residuals),
    ``backward{i}`` (chunk i's gradient against the shared cotangent
    buffer ``cot``, flattened for one all-reduce), ``sum`` (the reduced
    chunk gradients added in chunk order, split per parameter and, for a
    step, set as each ``.grad``) and, with an optimiser, ``update``. The
    caller runs the collectives between replays."""

    def __init__(self, scene, cam, opts, plan: _ShardPlan, params, opt=None):
        kind = "grads" if opt is None else "step"
        super().__init__(f"sharded_{kind}({opts.width}x{plan.rows_per} "
                         f"rows from {plan.row0}, {plan.sub} spp x {plan.chunks} chunks, "
                         f"{sorted(params)})", scene, cam, opts, plan.sub, plan.row0,
                         plan.rows_per, params, opt, plan.tgt)
        self.plan = plan
        self.cot = torch.zeros((plan.rows_per, opts.width, 3), dtype=torch.float32,
                               device=scene.device)
        n = plan.chunks
        self.stages = ([f"forward{i}" for i in range(n)] + [f"backward{i}" for i in range(n)]
                       + ["sum"] + (["update"] if opt is not None else []))
        self._accs, self._flat = [None] * n, [None] * n

    def _run(self, stage):
        if stage.startswith("forward"):
            i = int(stage[len("forward"):])
            self._accs[i] = self._render(i * self.plan.sub)
            return self._accs[i].detach()
        if stage.startswith("backward"):
            i = int(stage[len("backward"):])
            g = _grads(self._accs[i], self.leaves, self.cot)
            self._accs[i] = None
            self._flat[i] = torch.cat([x.reshape(-1) for x in g])
            return self._flat[i]
        if stage == "sum":
            total = self._flat[0].clone()
            for f in self._flat[1:]:
                total = total + f
            grads = [x.reshape(p.shape) for p, x in
                     zip(self.leaves, torch.split(total, [p.numel() for p in self.leaves]))]
            if self.opt is not None:
                for p, g in zip(self.leaves, grads):
                    p.grad = g
            return grads
        return self.opt.step()


def _sharded_grads(unit, plan: _ShardPlan, mesh, key, sample_offset):
    """(loss, gradients in leaf order) of one sharded step through
    ``unit``'s stages: the chunk forwards, their band sum all-reduced over
    the sample group *detached* (the band's image), the loss all-reduced
    over the row group, the accumulator's cotangent ``2 (img - tgt) /
    (denom * spp)`` into the shared buffer (every sample shard's: the
    transpose of a sum is a broadcast), then each chunk's backward with
    its gradient all-reduced over every rank right after it. No
    collective sits inside a graph or the autograd graph."""
    _set_inputs(unit.inputs, key, int(sample_offset) + mesh.sample * plan.spp_per)
    accs = [unit.replay(f"forward{i}") for i in range(plan.chunks)]
    acc = accs[0].clone()
    for a in accs[1:]:
        acc = acc + a
    img = mesh.all_reduce(acc, "samples") / float(plan.spp)
    loss = mesh.all_reduce((torch.sum((img - plan.tgt) ** 2) / plan.denom).reshape(1), "rows")[0]
    unit.cot.copy_(2.0 * (img - plan.tgt) / (plan.denom * float(plan.spp)))
    for i in range(plan.chunks):
        mesh.all_reduce(unit.replay(f"backward{i}"))  # per-chunk reduce
    return loss, unit.replay("sum")


def make_grad_fn_sharded(cam: Camera, opts: RenderOptions, target, mesh,
                         spp: Optional[int] = None, grad_chunks: int = 1):
    """grads_fn(params, scene, key, sample_offset) -> (loss, gradient tree):
    the loss of :func:`make_loss_fn` and its gradient, with rows and
    samples sharded over ``mesh`` (a ``parallel.mesh.Mesh``). Every rank
    returns the same loss and the same gradient bits.

    Each rank renders its row band and sample slice in ``grad_chunks``
    chunks and takes each chunk's backward against the band's shared
    cotangent, all-reducing that chunk's gradient right after it (see
    ``_sharded_grads``). No collective sits inside the autograd graph: the
    reference's earlier form, a ``psum`` inside the loss, transposed to
    another ``psum`` and scaled the gradients by the number of sample
    shards (``terra_tpu/optim.py:178-186``). On CUDA the chunk forwards
    and backwards are the graphs of one training unit, captured on the
    first call for (scene, camera, params) and replayed, with every
    all-reduce between replays."""
    plan = _shard_plan(opts, target, mesh, spp, grad_chunks)

    def grads_fn(params, scene: Scene, key, sample_offset):
        unit = _unit("grads_sharded", scene, cam, None, params, (opts, _plan_key(plan)),
                     lambda: _ShardedBody(scene, cam, opts, plan, params))
        loss, grads = _sharded_grads(unit, plan, mesh, key, sample_offset)
        return loss.detach(), tree_unflatten(params, [g.clone() for g in grads])

    return grads_fn


def make_train_step_sharded(cam: Camera, opts: RenderOptions, target, optimizer, mesh,
                            spp: Optional[int] = None, grad_chunks: int = 1):
    """The sharded :func:`make_train_step`: the gradient of
    :func:`make_grad_fn_sharded` (``grad_chunks`` chunks, each all-reduced
    right after its backward), then every rank steps its own optimiser on
    the same gradient bits, so the parameters stay bit-identical across
    ranks. On CUDA the optimiser's update is the last graph of the
    rank's training unit."""
    plan = _shard_plan(opts, target, mesh, spp, grad_chunks)

    def step(state: TrainState, scene: Scene, key):
        params, opt = _start(state, optimizer)
        unit = _unit("step_sharded", scene, cam, opt, params, (opts, _plan_key(plan)),
                     lambda: _ShardedBody(scene, cam, opts, plan, params, opt))
        loss, _ = _sharded_grads(unit, plan, mesh, key, state.step * plan.spp)
        unit.replay("update")
        return TrainState(params, opt, state.step + 1), loss.detach()

    return step


def recover(scene_init: Scene, cam: Camera, opts: RenderOptions, target,
            fields=("attrs", "emissive"), steps: int = 100, learning_rate: float = 5e-2,
            seed: int = 0, mesh=None, log_every: int = 0, clip_to_physical: bool = True):
    """Run the inverse-rendering loop with Adam; returns (scene_recovered,
    losses), or (scene_recovered, cam_recovered, losses) when "camera" is
    among the fields.

    ``clip_to_physical`` projects the parameters after each step: attribute
    values to [0, attr_cap], where attr_cap keeps slots that started above
    1 (exponents) free up to 1e4, emission and texture data to >= 0. With
    "positions" on a BVH scene the tree is refit after every step
    (``lbvh.refit_``: on the card for CUDA positions, on the current
    stream ahead of the next step's replays, with no host read; in NumPy
    for CPU ones), in place in the run's own copy of its boxes, so a
    captured step reads the moved triangles and the new boxes on its next
    replay and the run captures once. With ``mesh`` (a ``parallel.mesh.Mesh``) every rank
    runs the loop on the sharded step of :func:`make_train_step_sharded`,
    with the same clipping and refit, so every rank ends with the same
    scene."""
    optimizer = functools.partial(torch.optim.Adam, lr=learning_rate)
    params = _trainable(extract_params(scene_init, fields, cam=cam))
    attr_cap = None
    if clip_to_physical and "attrs" in params:
        attrs = params["attrs"].detach()
        attr_cap = torch.where(attrs > 1.0, 1e4, 1.0).to(attrs.dtype)
    state = TrainState(params, _capturable(optimizer(tree_leaves(params))), 0)
    key = rng_mod.key_from_seed(seed)
    if mesh is None:
        step_fn = make_train_step(cam, opts, target, optimizer)
    else:
        step_fn = make_train_step_sharded(cam, opts, target, optimizer, mesh)
    scene = scene_init
    refit_bvh = "positions" in fields and scene_init.bvh is not None
    if refit_bvh:
        # moved vertices move the triangle bounds: the boxes are refit
        # (fixed topology, so no rebuild) into this copy
        from .accel import lbvh

        bvh = scene_init.bvh
        scene = dataclasses.replace(scene_init, bvh=dataclasses.replace(
            bvh, node_min=bvh.node_min.clone(), node_max=bvh.node_max.clone()))
    losses = []
    for i in range(steps):
        state, loss = step_fn(state, scene, key)
        if clip_to_physical:
            with torch.no_grad():
                p = state.params
                if "attrs" in p:
                    p["attrs"].copy_(torch.minimum(torch.clamp(p["attrs"], min=0.0), attr_cap))
                for k in ("emissive", "textures"):
                    if k in p:
                        p[k].clamp_(min=0.0)
        if refit_bvh:
            lbvh.refit_(scene.bvh, dataclasses.replace(
                scene.geometry, positions=state.params["positions"].detach()))
        losses.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.6f}")
    final = tree_map(lambda t: t.detach(), state.params)
    if "camera" in fields:
        return inject_params(scene, final), inject_camera(cam, final), losses
    return inject_params(scene, final), losses
