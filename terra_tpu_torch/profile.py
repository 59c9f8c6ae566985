"""Metrics registry, rays/s counters and device traces (port of
``terra_tpu/profile.py``).

``Stats`` and ``ray_count`` are the reference's, unchanged. ``Profiler``
keeps the reference's registry and report; its clock is a span
(:meth:`Profiler.span`, :meth:`Profiler.hot`), which adds its host-clock
seconds to the target of its name and, while a ``torch.profiler`` collects,
opens a ``record_function`` of that name, so the span lands in the trace
as a ``user_annotation`` on the kernels' clock. Hot spans, on the paths
that run every pass, record only while tracing is on (a profiler collects,
or inside :func:`tracing`); off, they cost a test and a shared object.
Device work is asynchronous to the host, so times on a CUDA device come
from CUDA events on the current stream, and ``device_trace`` records a
``torch.profiler`` trace (CPU and CUDA activities) where the reference
used ``jax.profiler``. ``device_ms`` times a CUDA call by events (behind a
sleep backlog where the call is shorter than its host cost) and ``card``
names the card and its power limit, to print beside any time. Where the reference jits each stage of
``stage_breakdown`` before timing it, the port captures it as a CUDA graph
(``graphs.staged_unit``) and times replays.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Stats", "Profiler", "ray_count", "profiler", "tracing", "device_trace",
           "stage_breakdown", "device_ms", "card"]

# the spans' clock (tests patch it to show that an off span reads none)
_clock = time.perf_counter
# open ``tracing()`` blocks
_tracing = 0


@dataclass
class Stats:
    """Welford running stats: n, mean, variance, min, max, sum."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    sum: float = 0.0

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        self.sum += x

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0

    def as_dict(self) -> dict:
        return dict(n=self.n, avg=self.mean, var=self.var, min=self.min, max=self.max, sum=self.sum)


class _Off:
    """What a hot span is while tracing is off: one shared object that
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A recording span; ``seconds`` holds its host-clock duration once it
    has closed."""

    __slots__ = ("owner", "target", "t0", "seconds", "_annotation")

    def __init__(self, owner: "Profiler", target: str):
        self.owner, self.target, self.seconds = owner, target, None

    def __enter__(self):
        self._annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.target)
            self._annotation.__enter__()
        self.owner._open.append(self.target)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.seconds = _clock() - self.t0
        owner = self.owner
        owner._open.pop()
        owner.stats(self.target).add(self.seconds)
        for outer in set(owner._open):
            key = (outer, self.target)
            owner._nested[key] = owner._nested.get(key, 0.0) + self.seconds
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


class Profiler:
    """Named targets, each a :class:`Stats`. Usage::

        with profiler.span("render"):
            film = render(...)

    A span reads the host clock: synchronise the device inside the block
    to time device work. Its target's ``n`` counts the spans."""

    def __init__(self):
        self.targets: Dict[str, Stats] = {}
        self._open: list = []  # targets of the spans open now, outermost first
        self._nested: Dict[tuple, float] = {}

    def stats(self, target: str) -> Stats:
        return self.targets.setdefault(target, Stats())

    def span(self, target: str) -> _Span:
        """A span that always records: for work done a few times a process
        (a scene's build, a capture, a compiler run)."""
        return _Span(self, target)

    def hot(self, target: str):
        """A span on a path that runs every pass: it records only while
        tracing is on (a ``torch.profiler`` collects, or inside
        :func:`tracing`); off, it is one shared object that does nothing
        and reads no clock."""
        if not (_tracing or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, target)

    def nested(self, outer: str, inner: str) -> float:
        """Seconds of ``inner`` spans that ran inside an open ``outer``
        span."""
        return self._nested.get((outer, inner), 0.0)

    def add_sample(self, target: str, value: float):
        self.stats(target).add(value)

    def report(self) -> str:
        lines = []
        for name in sorted(self.targets):
            s = self.targets[name]
            if "mrays" in name:  # throughput counters, not clocks
                lines.append(
                    f"{name:24s} n={s.n:6d} avg={s.mean:9.2f} Mrays/s "
                    f"min={s.min:9.2f} max={s.max:9.2f}"
                )
            else:
                lines.append(
                    f"{name:24s} n={s.n:6d} avg={s.mean * 1e3:9.3f}ms "
                    f"min={s.min * 1e3:9.3f}ms max={s.max * 1e3:9.3f}ms sum={s.sum:8.3f}s"
                )
        return "\n".join(lines)

    def clear(self):
        self.targets.clear()
        self._nested.clear()


profiler = Profiler()


@contextlib.contextmanager
def tracing():
    """Hot spans record inside the block, as they do while a
    ``torch.profiler`` collects. Yields the module's profiler."""
    global _tracing
    _tracing += 1
    try:
        yield profiler
    finally:
        _tracing -= 1


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when a device is present) into ``trace_dir/trace.json``
    for chrome://tracing or Perfetto. Yields the profile (``key_averages()``
    sums kernel time by name), or None when ``trace_dir`` is falsy."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def device_ms(fn, reps: int, warm_up: bool = True, backlog: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs on the current CUDA
    stream, by CUDA events, after one warm-up run (``warm_up=False``: the
    caller has just run it). With ``backlog`` the stream first gets a sleep
    kernel longer than the host takes to enqueue the runs
    (``torch.cuda._sleep``, ~10 ms), so a kernel shorter than its wrapper's
    host cost is timed back to back on the device, not at the host's
    launch rate."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _best_seconds(fn, device: torch.device, reps: int = 3) -> float:
    """Least seconds of ``fn()`` over ``reps`` runs after a warm-up: CUDA
    events on the current stream for a CUDA device, the host clock on the
    CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


class StageBody:
    """A one-stage ``graphs.staged_unit`` body (a stage of
    :func:`stage_breakdown`, the bench's timed traversal call): it runs
    ``fn()``, writes nothing outside its outputs, and keeps ``fn`` (whose
    closure holds the rays the graph reads)."""

    def __init__(self, name: str, fn, inputs):
        self.label, self.stages, self.inputs = f"stage {name}", (name,), inputs
        self.keep = (fn,)

    def run(self, stage: str):
        return self.keep[0]()

    replay = run

    def save(self):
        return None

    def restore(self, saved) -> None:
        pass


@torch.no_grad()
def stage_breakdown(scene, cam, opts, seed: int = 0, probe_lanes: int = 65536) -> dict:
    """Per-stage times on a probe wavefront of camera rays, each stage run
    on the same inputs:

      raycast — closest-hit traversal only
      surface — raycast + shading-surface init
      bounce  — one full bounce: raycast + surface + integrator (with its
                shadow rays) + BSDF continuation

    Results land in the module profiler under ``stage/*`` targets and are
    returned as {stage: seconds}. On a CUDA scene each stage is captured
    once as a CUDA graph (after an eager warm-up under the sync check; a
    stage that fails to capture raises) and timed as the least of three
    replays after one more, with CUDA events: the reference's least of
    three runs after a compile. On the CPU each stage runs eagerly, timed
    on the host clock."""
    from . import camera as camera_mod, graphs, intersect
    from .integrators import make_integrator
    from .ops import rng as rng_mod
    from .render import _context, _continue, _lane_ids, _pixel_jitter, _shade, _streams_for
    from .surface import surface_init

    dev = scene.device
    key = rng_mod.key_from_seed(seed)
    spp = max(probe_lanes // (opts.width * opts.height), 1)
    pixel_idx, px, py, sample_idx = _lane_ids(opts, spp, 0, 0, opts.height, dev)
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(cam, opts.width, opts.height, px, py,
                                    opts.subpixel_jitter, r1, r2)
    ctx_base = _context(scene, opts)
    raycast = ctx_base["raycast"]
    integrator = make_integrator(opts.integrator)
    streams = _streams_for(opts.integrator, opts.env_nee)
    ones = torch.ones_like(o)

    def stage_raycast():
        return raycast(o, d)

    def stage_surface():
        hit = raycast(o, d)
        return surface_init(scene, ctx_base["tables"], o + d * intersect.RAY_OFFSET_DIR, d,
                            hit.tri)

    def stage_bounce():
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample_idx, 0, streams)
        hit = raycast(o, d)
        emit_ok = torch.ones_like(hit.hit) if ctx_base["has_delta"] else None  # bounce 0
        surf, radiance, _ = _shade(scene, ctx_base, integrator, hit, o, d, hit.hit, ones, 0, u,
                                   emit_ok)
        return radiance, _continue(surf, u, -d, ones, ctx_base["present"])

    out = {}
    n = int(o.shape[0])
    for name, fn in (("raycast", stage_raycast), ("surface", stage_surface),
                     ("bounce", stage_bounce)):
        unit = graphs.staged_unit(StageBody(name, fn, o))
        best = _best_seconds(lambda: unit.replay(name), dev)
        out[name] = best
        profiler.add_sample(f"stage/{name}", best)
        profiler.add_sample(f"stage/{name}_mrays", n / best / 1e6)
    return out


def ray_count(opts, avg_path_length: Optional[float] = None) -> float:
    """Nominal rays traced per full render at ``opts``: lanes times
    (bounces + 1) path raycasts, plus 1 (NEE) or 2 (MIS) shadow rays per
    bounce iteration. Early termination makes the true number lower; pass
    ``avg_path_length`` for a measured occupancy."""
    lanes = opts.width * opts.height * opts.samples_per_pixel
    per_bounce = 1
    integ = int(opts.integrator)
    if integ == 1:  # DIRECT
        per_bounce += 1
    elif integ == 2 or integ == 6:  # DIRECT_MIS / DEBUG_MIS_WEIGHTS
        per_bounce += 2
    depth = avg_path_length if avg_path_length is not None else (opts.bounces + 1)
    return float(lanes) * per_bounce * depth
