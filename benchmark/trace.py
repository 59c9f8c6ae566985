"""The traced slice of a run: ``torch.profiler`` over a few items (passes
or steps) of the window, each inside a ``bench.item`` annotation, its
Chrome trace written to one fixed file in the checkout's cache directory,
read back and deleted. :class:`TraceView` is what the per-layer readers
see: device operations and host events inside the slice."""
from __future__ import annotations

import json
import os
from collections import defaultdict

ITEM = "bench.item"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
MAX_TRACE_BYTES = 400 << 20


class Slice:
    """Profiles the items ``first .. first + count - 1`` of a window; the
    window loop calls :meth:`before` and :meth:`after` around each item."""

    def __init__(self, first: int, count: int, path: str):
        self.first, self.count, self.path = first, count, path
        self.prof = None
        self.view = None
        self._ann = None

    @property
    def pending(self) -> bool:
        """Items of the slice are still to run: the window goes on for them."""
        return self.view is None

    def before(self, i: int) -> None:
        import torch

        if i == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        if self.prof is not None and self.view is None:
            self._ann = torch.profiler.record_function(ITEM)
            self._ann.__enter__()

    def after(self, i: int) -> None:
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self.prof is not None and i == self.first + self.count - 1:
            self.close()

    def close(self) -> None:
        """Stop profiling (if it runs) and read the trace."""
        if self.prof is None or self.view is not None:
            return
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            size = os.path.getsize(self.path)
            if size > MAX_TRACE_BYTES:
                raise RuntimeError(f"trace of {size} bytes exceeds {MAX_TRACE_BYTES}: trace "
                                   f"fewer items")
            with open(self.path) as f:
                self.view = TraceView(json.load(f))
        finally:
            os.remove(self.path)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceView:
    """Device operations and host events of the traced items. Times in
    microseconds on the trace's clock."""

    def __init__(self, trace: dict):
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        items = [e for e in events if e.get("name") == ITEM and e.get("cat") == "user_annotation"]
        self.items = len(items)
        if items:
            self.t0 = min(e["ts"] for e in items)
            self.t1 = max(e["ts"] + e["dur"] for e in items)
        else:
            self.t0 = self.t1 = 0.0
        inside = lambda e: e["ts"] < self.t1 and e["ts"] + e.get("dur", 0) > self.t0  # noqa: E731
        self.device = [(e["name"], e.get("cat"), float(e["ts"]), float(e.get("dur", 0)))
                       for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                     for e in events if e.get("cat") in HOST_CATS and inside(e)
                     and e.get("name") != ITEM]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self):
        return [d for d in self.device if d[1] == "kernel"]

    def busy_intervals(self):
        return _union([(max(ts, self.t0), min(ts + dur, self.t1)) for _, _, ts, dur in self.device
                       if dur > 0])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for name, _, _, dur in self.device:
            by[name[:160]] += dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """Idle time of the device by what the host was doing: each gap
        between device operations goes to the innermost host event that
        spans its midpoint."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(self.host, key=lambda h: h[1])
        by = defaultdict(float)
        k, open_ = 0, []
        for s, e in zip(edges[0::2], edges[1::2]):  # gaps in time order
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            while k < len(host) and host[k][1] <= mid:
                open_.append(host[k])
                k += 1
            open_ = [h for h in open_ if h[1] + h[2] >= mid]
            best = min(open_, key=lambda h: h[2], default=None)
            by[(best[0] if best else "host: outside any recorded event")[:160]] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
