"""Where the courtyard training step's time goes on the card, by table.

    python -m terra_tpu_torch.scripts.backward_profile [--steps 4] [--out result.json]

The step is ``chip_smoke.py``'s phase 6c: the 242k courtyard at 384x384,
8 spp, 2 bounces, DIRECT, jitter 0.5, no roulette; Adam 3e-2 on attrs,
textures and positions from the wall albedo [0.3, 0.5, 0.6] and the
textures halved, against the scene's own render (key 7). It prints

- one eager backward (``optim.deterministic``) under ``torch.profiler``
  with ``record_shapes``: each index accumulate (``_index_put_impl_``,
  PyTorch's backward of a gather ``table[idx]``, and each
  ``row_accumulate`` call, its sort and kernel launches, named by its
  table shape and lanes) and each matrix
  product (``mm``) grouped by input shape, with its calls and device ms,
  and the backward's kernels by device time (a replayed graph records no
  op shapes, so the attribution is taken eagerly);
- ``--steps`` graphed steps (``optim.make_train_step``) after the one
  that captures, each followed by a refit in place (on the card) as
  ``recover`` does: ms a step (host clock ending in a synchronisation),
  each stage of the unit by CUDA events, the refit, the pool's bytes and
  the peak memory;

then one JSON line of all of it and the card's name and power limit.
It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import subprocess
import time
from unittest import mock

import numpy as np
import torch

FIELDS = ("attrs", "textures", "positions")
SHAPE_OPS = ("aten::_index_put_impl_", "aten::mm")
ACCUMULATE = "row_accumulate"  # the record_function around each row_accumulate call
LEVEL_KERNEL = "level_kernel"  # the row-accumulate kernel's name in the trace


@contextlib.contextmanager
def named_accumulates():
    """Each ``row_accumulate`` call inside a ``record_function`` named by
    its table shape and lanes (``row_accumulate [rows, cols] [lanes]``), so
    the profiler sums the PyTorch kernels it launches (the sort, the zeroed
    table) by shape. Yields the calls in order, (name, level launches), for
    :func:`by_shape` to give each call its kernel's launches."""
    from terra_tpu_torch.ops import row_accumulate as ra

    calls, real = [], ra.row_accumulate

    def named(grad, idx, rows):
        cols = grad[0].numel() if idx.numel() else 0
        name = f"{ACCUMULATE} {[rows, cols]} {[idx.numel()]}"
        calls.append((name, len(ra.level_sizes(idx.numel())) if idx.numel() and cols else 0))
        with torch.profiler.record_function(name):
            return real(grad, idx, rows)

    with mock.patch.object(ra, "row_accumulate", named):
        yield calls


def _level_ms(prof, calls) -> collections.Counter:
    """{call name: device ms} of the row-accumulate kernel's launches (a
    launch made through ctypes reaches the trace without the op that made
    it): the launches in start order, given to the calls in call order,
    one a level (the calls enqueue them in turn on one stream)."""
    kernels = iter(sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and LEVEL_KERNEL in e.name), key=lambda e: e.time_range.start))
    out = collections.Counter()
    for name, levels in calls:
        for e in itertools.islice(kernels, levels):
            out[name] += e.time_range.elapsed_us() / 1e3
    return out


def _device_ms(event, self_time=False) -> float:
    """An averaged profiler event's device time in ms (the attribute's name
    changed between PyTorch versions)."""
    names = ("self_device_time_total", "self_cuda_time_total") if self_time else \
        ("device_time_total", "cuda_time_total")
    return next(getattr(event, n) for n in names if hasattr(event, n)) / 1e3


def by_shape(prof, calls=()) -> list:
    """[(op, input shapes, calls, device ms)] of the profile's index
    accumulates (PyTorch's, and the row accumulates named by
    :func:`named_accumulates`, whose shapes are the table's and the lanes'
    and whose time is their PyTorch kernels' and their level launches')
    and matrix products, most device time first."""
    rows = [(e.key, [list(s) for s in e.input_shapes if s], e.count, _device_ms(e))
            for e in prof.key_averages(group_by_input_shape=True) if e.key in SHAPE_OPS]
    levels = _level_ms(prof, calls)
    for e in prof.key_averages():
        if e.key.startswith(ACCUMULATE + " ") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            table, lanes = e.key[len(ACCUMULATE) + 1:].split("] [")
            rows.append((ACCUMULATE, [json.loads(table + "]"), json.loads("[" + lanes)],
                         e.count, _device_ms(e) + levels[e.key]))
    return sorted(rows, key=lambda r: -r[3])


def top_kernels(prof, n: int = 12) -> list:
    """[(kernel, launches, device ms)] of the profile's kernels, most device
    time first."""
    rows = [(e.key, e.count, _device_ms(e, self_time=True)) for e in _kernels(prof)]
    return sorted(rows, key=lambda r: -r[2])[:n]


def _kernels(prof) -> list:
    """The profile's kernels, averaged by name (not the device-side ranges
    of :func:`named_accumulates`' annotations)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_ms(e, True) > 0
            and not e.key.startswith(ACCUMULATE + " ")]


def profile_backward(loss_fn, params, *args) -> dict:
    """Forward, then the backward of ``loss_fn(params, *args)`` in
    deterministic mode, once timed and once under the profiler. Returns
    forward and backward ms, the rows of :func:`by_shape` and
    :func:`top_kernels`, the backward's kernel launches and device ms."""
    from terra_tpu_torch import optim
    from terra_tpu_torch.checkpoint import tree_leaves

    leaves = tree_leaves(params)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with optim.deterministic():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params, *args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss = loss_fn(params, *args)
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof, \
                named_accumulates() as calls:
            torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
    kernels = [(e.count, _device_ms(e, True)) for e in _kernels(prof)]
    return {"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "by_shape": by_shape(prof, calls), "top_kernels": top_kernels(prof),
            "kernel_launches": sum(k[0] for k in kernels),
            "kernel_ms": sum(k[1] for k in kernels)}


def print_profile(res: dict, indent: str = "  ") -> None:
    print(f"{indent}the backward under the profiler: {res['kernel_launches']} kernels, "
          f"{res['kernel_ms']:.2f} ms of kernel time; index accumulates and products by input "
          f"shape (table or product shapes, calls, device ms):", flush=True)
    for op, shapes, calls, ms in res["by_shape"]:
        print(f"{indent}  {ms:9.2f} ms  x{calls:<4d} {op} {shapes}", flush=True)
    print(f"{indent}its kernels by device time:", flush=True)
    for name, count, ms in res["top_kernels"]:
        print(f"{indent}  {ms:9.2f} ms  x{count:<6d} {name[:110]}", flush=True)


def graphed_steps(scene, cam, opts, target, start, key, steps: int) -> dict:
    """``steps`` graphed steps after the capturing one, a refit in place
    after each (``chip_smoke._train_2``'s loop)."""
    from terra_tpu_torch import graphs, optim
    from terra_tpu_torch.accel import lbvh

    units, events, step_ms, refit_ms = [], [], [], []
    real_init, real_replay = graphs.TrainUnit.__init__, graphs.TrainUnit.replay

    def init(self, *a, **k):
        real_init(self, *a, **k)
        units.append(self)

    def replay(self, stage):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_replay(self, stage)
        b.record()
        events.append((stage, a, b))
        return out

    graphs.clear()
    step = optim.make_train_step(cam, opts, target, functools.partial(torch.optim.Adam, lr=3e-2))
    scene = dataclasses.replace(start, bvh=dataclasses.replace(
        start.bvh, node_min=start.bvh.node_min.clone(), node_max=start.bvh.node_max.clone()))
    state = optim.TrainState(optim.extract_params(scene, FIELDS), None, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(graphs.TrainUnit, "__init__", init), \
            mock.patch.object(graphs.TrainUnit, "replay", replay):
        for _ in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, scene, key)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lbvh.refit_(scene.bvh, dataclasses.replace(
                scene.geometry, positions=state.params["positions"].detach()))
            torch.cuda.synchronize()
            step_ms.append((t1 - t0) * 1e3)
            refit_ms.append((time.perf_counter() - t1) * 1e3)
    stages = {}
    for stage, a, b in events[3:]:  # the first step's replays follow its capture
        stages.setdefault(stage, []).append(a.elapsed_time(b))
    unit = units[0].describe()
    out = {"step_ms": step_ms[1:], "first_step_ms": step_ms[0], "refit_ms": refit_ms[1:],
           "stage_ms": {k: float(np.mean(v)) for k, v in stages.items()},
           "stage_ms_by_step": stages, "captures": len(units),
           "pool_bytes": unit["pool_bytes"], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "loss": float(loss)}
    graphs.clear()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4, help="graphed steps after the capturing one")
    p.add_argument("--out", default=None, help="also write the results as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_profile: needs a CUDA device")
    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    scene = ttt.scenes.courtyard(device=dev)
    cam = ttt.scenes.courtyard_camera(device=dev)
    opts = ttt.RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             rr_start_bounce=8)
    key = rng.key_from_seed(7)
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, opts, key, 0, 8)
    attrs = scene.materials.attrs.clone()
    attrs[0, 0] = torch.tensor([0.3, 0.5, 0.6], device=dev)
    start = optim.inject_params(scene, {"attrs": attrs, "textures": scene.textures.data * 0.5})
    loss_fn = optim.make_loss_fn(cam, opts, target)
    params = optim._trainable(optim.extract_params(start, FIELDS))
    optim.value_and_grad(loss_fn, params, start, key, 0)  # warm-up
    eager = profile_backward(loss_fn, params, start, key, 0)
    print(f"backward_profile: package {ttt.__file__}; the courtyard "
          f"({scene.geometry.num_triangles} tris) at 384x384x8spp, fields {FIELDS}; eager "
          f"forward {eager['forward_ms']:.1f} ms, backward {eager['backward_ms']:.1f} ms",
          flush=True)
    print_profile(eager)
    graphed = graphed_steps(scene, cam, opts, target, start, key, args.steps)
    print(f"  graphed steps (host clock, after the capturing one of "
          f"{graphed['first_step_ms']:.1f} ms): {[round(x, 1) for x in graphed['step_ms']]} ms; "
          f"inside the unit (CUDA events, mean) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in graphed["stage_ms"].items())
          + f"; refit {[round(x, 1) for x in graphed['refit_ms']]} ms; captures "
          f"{graphed['captures']}; pool {graphed['pool_bytes'] / 2**30:.3f} GiB; peak memory "
          f"{graphed['peak_gib']:.3f} GiB", flush=True)
    result = {"package": ttt.__file__, "eager": eager, "graphed": graphed, "card": smi}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(smi, flush=True)
    return result


if __name__ == "__main__":
    main()
