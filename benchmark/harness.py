"""The benchmark's driver: one cell, one run.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own, found by name:

  BENCHMARK.json                      cells (configuration, traffic mix, chips) and
                                      metrics (which cell reports what)
  benchmark/configs/<config>.json     scene generator and its parameters, camera, source
  benchmark/scenes/<generator>.py     the frozen scene generator
  benchmark/traffic/<mix>.json        the mix's generator and its parameters
  benchmark/traffic/<generator>.py    a traffic generator and its correctness check
  benchmark/workloads/<cell>.json     the cell's correctness limits and traced slice
  benchmark/metrics/<metric>.py       ``read(ctx)`` of one per-layer metric

A run: the scene arrays from the configuration, the traffic's set-up (the
program's scene, its warm-up), the measured window, the peak memory, the
program's state freed, the check against the plain reference, the result
line. With ``trace`` the window profiles a bounded slice of its items and
the per-layer readers take their numbers from it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, "_bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "terra_tpu")


def process_seconds() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end metric entries, per-layer metric entries) the cell reports."""
    def reports(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``terra_tpu_torch`` is not ``terra_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Context:
    """What the traffic module and the metric readers get: the cell, its
    configuration and scene arrays, the seed, the device, and what the run
    learns (``facts``: shapes and table sizes the readers count from;
    ``counters``: the program's counters)."""

    def __init__(self, cell: dict, config: dict, params: dict, arrays: dict, seed: int,
                 device: str):
        self.cell, self.config, self.arrays = cell, config, arrays
        self.seed, self.device = seed, device
        self.params = params
        self.facts, self.counters = {}, {}
        self.trace = None
        self.peaks = None


def prepare(workload: str, seed: int, root: str = ROOT, device: str = "cuda",
            overrides: dict | None = None):
    """(context, traffic module, BENCHMARK.json) of one run of ``workload``:
    its files read and its scene arrays generated, nothing run yet.
    ``overrides`` replaces traffic parameters (the tests' small sizes)."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    bdir = os.path.join(root, "benchmark")
    cell = read_json(os.path.join(bdir, "workloads", f"{workload}.json"))
    config = read_json(os.path.join(bdir, "configs", f"{entry['config']}.json"))
    mix = read_json(os.path.join(bdir, "traffic", f"{entry['traffic']}.json"))
    params = dict(mix["params"], **(overrides or {}))
    gen = load_module(os.path.join(bdir, "scenes", f"{config['generator']}.py"),
                      f"benchmark_scene_{config['generator']}")
    traffic = load_module(os.path.join(bdir, "traffic", f"{mix['generator']}.py"),
                          f"benchmark_traffic_{mix['generator']}")
    arrays = gen.generate(config["params"])
    if "triangles" in config and arrays["tri_vidx"].shape[0] != config["triangles"]:
        raise RuntimeError(f"{config['name']}: {arrays['tri_vidx'].shape[0]} triangles, the "
                           f"configuration pins {config['triangles']}")
    ctx = Context(cell, config, params, arrays, seed, device)
    return ctx, traffic, bench


def run(workload: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
        device: str = "cuda", overrides: dict | None = None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result object (the last line)."""
    import torch

    ctx, traffic, bench = prepare(workload, seed, root, device, overrides)
    cell, bdir = ctx.cell, os.path.join(root, "benchmark")
    e2e, per = cell_metrics(bench, workload)
    dev_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    from . import peaks

    ctx.peaks = peaks.for_device(dev_name)
    state = traffic.setup(ctx)
    slice_ = None
    if trace:
        from .trace import Slice

        slice_ = Slice(int(cell["trace_first"]), int(cell["trace_items"]),
                       os.path.join(root, "_bench_cache", "trace.json"))
    setup_s = process_seconds()
    out = traffic.window(ctx, state, seconds, slice_)
    if slice_ is not None:
        slice_.close()
        ctx.trace = slice_.view
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    traffic.release(ctx, state)
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = traffic.check(ctx)
    ctx.counters["check_s"] = time.perf_counter() - t0
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    metrics = {}
    if not trace:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in per:
            reader = load_module(os.path.join(bdir, "metrics", f"{m['name']}.py"),
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": dev_name, "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    for k, v in sorted(ctx.counters.items()):
        print(f"counter {k}: {v}", file=log)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=log)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result
