"""The brute-force sweep kernel's share of its roofline over the traced
passes: the least time its launches need over their device time.

A launch of ``sweep_kernel<ALGO, HAS_TMAX>`` (``csrc/sweep.cu``) tests every
ray against every triangle, so its work follows from the shapes alone:
each ray's origin and direction (and its range, with ``t_max``) read once,
its hit (t, triangle, a one-byte flag) written once and the triangles' 40-byte
rows read once; 46 f32 operations a ray and triangle pair, Moller-Trumbore's
arithmetic with the two edges counted once a triangle (6 more a triangle).
The watertight test is priced at the same count. Priced at ``peaks.py``'s
rates: under ``-fmad=false`` every multiply and add is an instruction of its
own, so the f32 pipe reaches half of the FMA rate and the share ~50% at
most. The rays a launch come from ``facts["rays_per_launch"]``, the
triangles from the configuration's ``triangles``."""
from __future__ import annotations

import re

from benchmark import roofline

_NAME = re.compile(r"sweep_kernel<\s*(\d+)\s*,\s*(true|false)\s*>")
PAIR_FLOPS = 46
EDGE_FLOPS = 6
TRI_ROW_BYTES = 40


def sweep_instance(name: str):
    """(algo, has_tmax) of a sweep kernel event's name, or None for
    another kernel."""
    m = _NAME.search(name)
    if m is None:
        return None
    return int(m.group(1)), m.group(2) == "true"


def sweep_launch(rays: int, tris: int, has_tmax: bool) -> dict:
    """Bytes and f32 operations one launch needs."""
    ray_bytes = rays * (6 * 4 + (4 if has_tmax else 0))
    hit_bytes = rays * (4 + 4 + 1)
    return {"bytes": ray_bytes + hit_bytes + tris * TRI_ROW_BYTES,
            "flops": rays * tris * PAIR_FLOPS + tris * EDGE_FLOPS}


def read(ctx):
    t, f = ctx.trace, ctx.facts
    tris = (getattr(ctx, "config", None) or {}).get("triangles")
    if t is None or ctx.peaks is None or "rays_per_launch" not in f or not tris:
        return None
    least = busy = 0.0
    for name, _, _, dur in t.kernels():
        inst = sweep_instance(name)
        if inst is None:
            continue
        work = sweep_launch(f["rays_per_launch"], tris, inst[1])
        least += roofline.least_seconds(work, ctx.peaks)
        busy += dur * 1e-6
    if busy <= 0:
        return None
    return 100.0 * least / busy
