"""Back-to-back inverse-rendering steps (``inverse_steps``: set-up, the
window's loop, the reference, the planted faults), whose window reports
``frame_s``: the window's seconds over the steps it took, a step being
the unit of the window's work (forward with autograd, backward, Adam, the
projection, the host refit and the loss read to the host).

The check compares the loss of the first step alone. From the second
step on the two sides render at parameters that differ in their last
bits (their gradients sum in other orders), and on this scene a few
lanes carry radiance up to ~5e6 (light samples a hair from a surface),
whose images those bits move: at the program's own parameters the
reference agrees lane for lane, but its own second and third losses
part from the program's by up to ~1e-4 and ~1 of the loss. The first
gradient, the parameters' change over the checked steps (by norm) and
the refit boxes are compared as ``inverse_steps`` compares them.

A run whose parameters, or a step's loss, turned non-finite raises after
the window instead of reporting: every lane then misses (the loss of
such a step is still finite), and its seconds a step measure another
workload.

Parameters: those of ``inverse_steps``.
"""
from __future__ import annotations

from benchmark.traffic import inverse_steps
from benchmark.traffic.inverse_steps import control_snapshot, reference_run, release, setup

__all__ = ["setup", "window", "release", "check", "reference_run", "numbers",
           "control_snapshot", "fault_readings"]


def window(ctx, st, seconds: float, slice_=None) -> dict:
    import torch

    out = inverse_steps.window(ctx, st, seconds, slice_)
    bad = sorted(k for k, v in st["state"].params.items() if not bool(torch.isfinite(v).all()))
    if ctx.bad_steps or bad:
        raise RuntimeError(f"after {out['attempted']} steps: {ctx.bad_steps} non-finite losses, "
                           f"non-finite parameters {bad}")
    return {"metrics": {"frame_s": out["metrics"]["step_ms"] * 1e-3},
            "attempted": out["attempted"], "failed": out["failed"]}


def numbers(ctx, snap: dict, ref: dict) -> dict:
    """``inverse_steps.numbers`` with ``loss_gap`` over the first step."""
    return inverse_steps.numbers(ctx, dict(snap, losses=snap["losses"][:1]), ref)


def fault_readings(ctx, ref: dict) -> dict:
    """``inverse_steps.fault_readings``' faults (a state unchanged, half of
    the rows left out, the loss altered by 1%), compared by :func:`numbers`."""
    half = reference_run(ctx, rows=int(ctx.params["height"]) // 2)
    faults = {"unchanged": dict(ctx.snap, params=ctx.snap["p0"]),
              "half": control_snapshot(ctx, half),
              "altered": control_snapshot(ctx, dict(ref, losses=[x * 1.01
                                                                 for x in ref["losses"]]))}
    return {k: numbers(ctx, v, ref) for k, v in faults.items()}


def check(ctx) -> list:
    lim = ctx.cell["limits"]
    nums = numbers(ctx, ctx.snap, reference_run(ctx))
    nums["nonfinite_steps"] = float(ctx.bad_steps)
    return [(k, v, float(lim[k])) for k, v in nums.items()]
