"""Back-to-back inverse-rendering steps, as ``optim.recover``'s loop takes
them: the program's training step (``optim.make_train_step``: forward,
backward and Adam), the projection to physical values, the host refit of
the tree's boxes (``lbvh.refit_``) and the loss read to the host.

The start: the configuration's scene with the wall albedo and the
textures of the mix's ``start``, its positions moved by a uniform
perturbation drawn from the run's seed. The target: an image drawn from
the run's seed, handed to both sides (the step's work does not depend on
its values). Set-up builds the step and drives it through its first
``checked_steps`` steps, which capture its units; the window continues
the same run. The check follows those first steps with the plain
reference: each step's loss, the first gradient (from Adam's first moment
after one step), the parameters' change, and the refit boxes.

Parameters: width, height, spp, bounces, integrator, subpixel_jitter,
rr_start_bounce, lr, fields, start {wall_albedo, textures_scale},
position_jitter, checked_steps.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import time

import numpy as np

from benchmark.traffic import render_passes

M64 = (1 << 64) - 1


def start_arrays(ctx) -> dict:
    """The start's arrays and the target, both drawn from the run's seed."""
    p, a = ctx.params, ctx.arrays
    rng = np.random.default_rng(int(ctx.seed) & M64)
    attrs = a["attrs"].copy()
    attrs[0, 0] = p["start"]["wall_albedo"]
    jitter = float(p["position_jitter"])
    pos = a["positions"] + rng.uniform(-jitter, jitter, a["positions"].shape).astype(np.float32)
    start = dict(a, attrs=attrs, positions=pos.astype(np.float32),
                 tex_data=(a["tex_data"] * np.float32(p["start"]["textures_scale"])))
    target = rng.random((int(p["height"]), int(p["width"]), 3), dtype=np.float32)
    return start, target


def setup(ctx):
    import torch

    optim = importlib.import_module("terra_tpu_torch.optim")
    lbvh = importlib.import_module("terra_tpu_torch.accel.lbvh")
    rng_mod = importlib.import_module("terra_tpu_torch.ops.rng")
    p = ctx.params
    start, target_np = start_arrays(ctx)
    ctx.start, ctx.target = start, target_np
    saved = ctx.arrays
    ctx.arrays = start
    scene = render_passes._program_scene(ctx)
    ctx.arrays = saved
    cam = render_passes.camera(ctx)
    opts = render_passes.options(ctx)
    render_passes.table_facts(ctx, scene)
    target = torch.as_tensor(target_np, device=ctx.device)
    fields = tuple(p["fields"])
    params = optim.extract_params(scene, fields)
    attr_cap = torch.where(params["attrs"] > 1.0, 1e4, 1.0) if "attrs" in params else None
    step_fn = optim.make_train_step(cam, opts, target, functools.partial(
        torch.optim.Adam, lr=float(p["lr"])))
    bvh = scene.bvh
    scene = dataclasses.replace(scene, bvh=dataclasses.replace(
        bvh, node_min=bvh.node_min.clone(), node_max=bvh.node_max.clone()))
    st = dict(optim=optim, lbvh=lbvh, scene=scene, step_fn=step_fn, attr_cap=attr_cap,
              state=optim.TrainState(params, None, 0), key=rng_mod.key_from_seed(ctx.seed))
    ctx.key = st["key"]
    p0 = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
    losses = []
    for i in range(int(p["checked_steps"])):
        losses.append(_step(st))
        if i == 0:
            # the first gradient, from Adam's first moment after one step
            opt = st["state"].opt_state
            b1 = opt.param_groups[0]["betas"][0]
            grad = {k: (opt.state[leaf]["exp_avg"] / (1.0 - b1)).cpu().numpy()
                    for k, leaf in st["state"].params.items()}
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    b = st["scene"].bvh
    ctx.snap = dict(p0=p0, losses=losses, grad=grad,
                    params={k: v.detach().cpu().numpy().copy()
                            for k, v in st["state"].params.items()},
                    node_min=b.node_min.cpu().numpy().copy(), node_max=b.node_max.cpu().numpy().copy(),
                    leaf_tri=b.leaf_tri.cpu().numpy(), node_left=b.node_left.cpu().numpy(),
                    node_right=b.node_right.cpu().numpy())
    return st


def _step(st) -> float:
    """One step of ``recover``'s loop; returns the loss read to the host."""
    import torch

    state, loss = st["step_fn"](st["state"], st["scene"], st["key"])
    with torch.no_grad():
        prm = state.params
        if "attrs" in prm:
            prm["attrs"].copy_(torch.minimum(torch.clamp(prm["attrs"], min=0.0), st["attr_cap"]))
        for k in ("emissive", "textures"):
            if k in prm:
                prm[k].clamp_(min=0.0)
    scene = st["scene"]
    if "positions" in state.params:
        st["lbvh"].refit_(scene.bvh, dataclasses.replace(
            scene.geometry, positions=state.params["positions"].detach()))
    st["state"] = state
    return float(loss)


def window(ctx, st, seconds: float, slice_=None) -> dict:
    start = time.perf_counter()
    end = start
    losses = []
    while end - start < seconds or (slice_ is not None and slice_.pending):
        if slice_ is not None:
            slice_.before(len(losses))
        losses.append(_step(st))
        end = time.perf_counter()
        if slice_ is not None:
            slice_.after(len(losses) - 1)
    n = len(losses)
    ctx.counters["steps"] = n
    # a step whose loss comes back non-finite answered wrong
    ctx.bad_steps = int(np.sum(~np.isfinite(np.asarray(losses))))
    return {"metrics": {"step_ms": (end - start) / n * 1e3}, "attempted": n,
            "failed": ctx.bad_steps}


def release(ctx, st) -> None:
    st.clear()
    if ctx.device == "cuda":
        importlib.import_module("terra_tpu_torch.graphs").clear()


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def leaf_gap(got: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of that leaf's reference norm and the median leaf's."""
    norms = {k: _norm(ref[k]) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(_norm(got[k]) - norms[k]) / max(norms[k], med, 1e-30) for k in keep)


def reference_run(ctx, tf32: bool = False, rows: int | None = None) -> dict:
    import torch

    from benchmark.reference import train

    p = ctx.params
    params = {k: torch.as_tensor(v, device=ctx.device) for k, v in ctx.snap["p0"].items()}
    rows = rows or int(p["height"])
    target = torch.as_tensor(ctx.target[:rows], device=ctx.device)
    return train.follow(ctx.start, ctx.config["accelerator"], params,
                        render_passes.reference_opts(ctx) | {"spp": int(p["spp"]), "height": rows},
                        ctx.config["camera"], ctx.key, target, float(p["lr"]),
                        int(p["checked_steps"]), tf32=tf32)


def control_snapshot(ctx, run: dict) -> dict:
    """A reference run (the control) in the place of the program's first
    steps: its losses, first gradient, parameters, and the program's tree
    refit to its positions."""
    from benchmark.reference import train

    snap = dict(ctx.snap, losses=run["losses"],
                grad={k: v.detach().cpu().numpy() for k, v in run["grad"].items()},
                params={k: v.detach().cpu().numpy() for k, v in run["params"].items()})
    if "positions" in snap["params"]:
        snap["node_min"], snap["node_max"] = train.tree_boxes(
            snap["params"]["positions"], ctx.arrays["tri_vidx"], snap["leaf_tri"],
            snap["node_left"], snap["node_right"])
    return snap


def fault_readings(ctx, ref: dict) -> dict:
    """The numbers of each fault a training cell can have, planted in the
    reference put in the program's place: the parameters left as they were
    (a state unchanged), half of the rows left out (the mean over the
    rest), the loss altered by 1% where it is made."""
    faults = {"unchanged": dict(ctx.snap, params=ctx.snap["p0"])}
    half = reference_run(ctx, rows=int(ctx.params["height"]) // 2)
    faults["half"] = control_snapshot(ctx, half)
    altered = dict(ref, losses=[x * 1.01 for x in ref["losses"]])
    faults["altered"] = control_snapshot(ctx, altered)
    return {k: numbers(ctx, v, ref) for k, v in faults.items()}


def numbers(ctx, snap: dict, ref: dict) -> dict:
    """The compared numbers of a run's first steps (``snap``) against the
    reference's (``ref``)."""
    from benchmark.reference import train

    rg = {k: v.detach().cpu().numpy() for k, v in ref["grad"].items()}
    gnorm = {k: _norm(v) for k, v in rg.items()}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k in rg if gnorm[k] >= 1e-3 * med]
    p0 = snap["p0"]
    d_got = {k: snap["params"][k] - p0[k] for k in moving}
    d_ref = {k: ref["params"][k].detach().cpu().numpy() - p0[k] for k in moving}
    out = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(snap["losses"], ref["losses"])),
           "grad_gap": leaf_gap(snap["grad"], rg, list(rg)),
           "change_gap": leaf_gap(d_got, d_ref, moving)}
    if "positions" in snap["params"]:
        # the refit: the boxes as they stand after the last checked step
        # against the bounds of the program's own triangles then, on its tree
        bmin, bmax = train.tree_boxes(snap["params"]["positions"], ctx.arrays["tri_vidx"],
                                      snap["leaf_tri"], snap["node_left"], snap["node_right"])
        out["box_gap"] = max(float(np.max(np.abs(snap["node_min"] - bmin))),
                             float(np.max(np.abs(snap["node_max"] - bmax))))
    return out


def check(ctx) -> list:
    lim = ctx.cell["limits"]
    nums = numbers(ctx, ctx.snap, reference_run(ctx))
    nums["nonfinite_steps"] = float(ctx.bad_steps)
    return [(k, v, float(lim[k])) for k, v in nums.items()]
