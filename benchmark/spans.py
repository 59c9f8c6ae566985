"""The program's own spans, for the per-layer readers.

In the traced slice: the device's idle time attributed to the program's
``terra.*`` spans (``terra_tpu_torch.profile``'s hot spans, which the
profiler records as ``user_annotation`` events on the kernels' clock).
Each gap between device operations goes to the innermost ``terra.*``
span that spans its midpoint; a gap that no such span covers counts for
none. In the process: the sums of the set-up's spans, as
``terra_tpu_torch.profile`` holds them. Both give nothing (None) where
the program has no such spans.
"""
from __future__ import annotations

import sys
from collections import defaultdict

PREFIX = "terra."


def idle_ms_per_item(ctx, wanted) -> float | None:
    """Milliseconds a traced item of device idle inside the spans for which
    ``wanted(name)`` holds; None when the trace has no such span."""
    t = ctx.trace
    if t is None or t.items == 0:
        return None
    by = idle_by_span(t)
    names = [n for n in by if wanted(n)]
    if not names:
        return None
    return sum(by[n] for n in names) * 1e3 / t.items


def idle_by_span(view) -> dict:
    """{span name: idle seconds} over the traced slice, every ``terra.*``
    span in it named (with 0.0 where no gap falls inside it)."""
    spans = sorted((h for h in view.host if h[0].startswith(PREFIX)), key=lambda h: h[1])
    by = defaultdict(float, {name: 0.0 for name, _, _ in spans})
    if not spans:
        return by
    busy = view.busy_intervals()
    edges = [view.t0] + [x for iv in busy for x in iv] + [view.t1]
    k, open_ = 0, []
    for s, e in zip(edges[0::2], edges[1::2]):  # gaps in time order
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while k < len(spans) and spans[k][1] <= mid:
            open_.append(spans[k])
            k += 1
        open_ = [h for h in open_ if h[1] + h[2] >= mid]
        best = min(open_, key=lambda h: h[2], default=None)
        if best is not None:
            by[best[0]] += (e - s) * 1e-6
    return by


def setup_seconds(target: str, less: str | None = None) -> float | None:
    """The process's sum of ``target`` spans, less the ``less`` spans that
    ran inside them; None when the program recorded none."""
    profile = sys.modules.get("terra_tpu_torch.profile")
    if profile is None:
        return None
    stats = profile.profiler.targets.get(target)
    if stats is None or stats.n == 0:
        return None
    inner = profile.profiler.nested(target, less) if less else 0.0
    return stats.sum - inner
