"""Compacted two-phase traversal against the classic kernel on the 3m
workload: the 1,013,964-triangle courtyard, 2^20 camera rays sorted by
dir3 keys. Port of ``scripts/compact_bench.py``.

    python -m terra_tpu_torch.scripts.compact_bench [--M 128 256] [--grid 690]
                                                    [--rays 1048576] [--check 1]

It walks the sorted rays with ``traverse_packed`` on the tables
``pack_tables_auto`` picks (the classic walk), then, for each frontier size
M, with ``compact.raycast_compact`` (rows of 128 lanes, tail buckets
(1, 8, 64); on the card its stages within ``compact.GRAPH_SWEEP`` are
CUDA graphs, captured by the first call), and holds the compact result to
the classic one: no hit-mask mismatch, t within rtol and atol 1e-4, and at
least 99% of hits on the same triangle. Times are the least of 3 runs
after a warm-up, on the host clock after ``torch.cuda.synchronize()`` (the
compact path reads its active count back to the host every tail round).
The A/B: the eager call (``raycast_compact_eager``, every stage op by op)
and ``raycast_compact`` in turns (E G G E E G), medians of 3, with each
one's BVH4 launches per call; their hits must be equal word for word.
Phase 1 is timed alone the same way, and on the card one compact call is
traced with ``torch.profiler`` to split its device time between the
traversal kernel and the rest. Per M the dict also holds the units'
captures, warm-up and capture seconds, the run's pool bytes, replays per
call, the lanes each tail round ran, and ``stages``: the head (phase 1 and
rounds 0-1) and each tail round of one call timed op by op at its exact
size, as a unit replayed at its (1, 8, 64) bucket, and as a unit at the
least power-of-two multiple of 128 lanes that holds its active rays, each
from the same carry (the per-stage times ``GRAPH_SWEEP`` is set from). It
runs on the CUDA device; ``--device cpu`` takes the plain walks and eager
units instead (at a small ``--grid``). The reference's ``--shape`` (the
TPU kernel's packet shape) has no counterpart. ``main`` returns the
measurements as a dict.
"""
from __future__ import annotations

import argparse
import time

import torch


def _seconds(fn, dev, reps: int = 3) -> float:
    """Least host-clock seconds of ``fn()`` over ``reps`` runs after a
    warm-up, each ending in a device synchronise."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _turns(fns: dict, dev) -> dict:
    """Host-clock seconds of each of two calls run in turns (E G G E E G,
    each ending in a device synchronise), as {name: [3 seconds]}."""
    out = {k: [] for k in fns}
    a, b = fns
    for k in (a, b, b, a, a, b):
        t0 = time.perf_counter()
        fns[k]()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[k].append(time.perf_counter() - t0)
    return out


def _launches4(fn) -> int:
    """BVH4 kernel launches one ``fn()`` makes (a replay adds what its
    capture recorded)."""
    from terra_tpu_torch.profile import kernel_launches

    before = kernel_launches["bvh4"]
    fn()
    return kernel_launches["bvh4"] - before


def _words(a, b) -> int:
    """Differing words between two hit records (t bits, tri, hit)."""
    return int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum()
               + (a.tri != b.tri).sum() + (a.hit != b.hit).sum())


def _stage_times(cc, graphs, tables, fr, o, d, buckets, dev) -> list:
    """The stages of one compact call, each timed (least host-clock seconds
    of 3 after one more, the active count read back as the walk reads it)
    from the carry the walk gives it: op by op at its exact size, and as
    units replayed at its bucket and at the least power-of-two multiple of
    128 lanes that holds it (one unit for the head). Each unit is captured
    for the measurement and dropped after it."""
    n, f = o.shape[0], int(fr.roots.shape[0])
    run = cc._Run(tables, fr, n, 128, "mt", 16384, buckets, dev)
    run.o[:n].copy_(o)
    run.d[:n].copy_(d)

    def seconds(saved, fn) -> float:
        best = float("inf")
        for i in range(4):
            run.restore(saved)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            int(run.count)
            if i:
                best = min(best, time.perf_counter() - t0)
        return best

    def unit(saved, name, stages, step) -> float:
        u = graphs.staged_unit(cc._Body(run, f"compact {name} (timed)", stages, step))
        sec = seconds(saved, lambda: [u.replay(s) for s in stages])
        del u
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return sec

    head = ("phase1", "round0", "round1")
    saved = run.save()
    rows = [dict(stage="head", active=n, lanes=n, entries=n * f,
                 exact_ms=seconds(saved, lambda: [run._head(s) for s in head]) * 1e3,
                 unit_ms=unit(saved, "head", head, run._head) * 1e3)]
    for s in head:
        run._head(s)
    count = int(run.count)
    while count:
        saved = run.save()
        lanes = cc._bucket(count, n, buckets, 128)
        fine = 128
        while fine < count:
            fine *= 2
        row = dict(stage="tail", active=count, lanes=lanes, entries=lanes * f,
                   exact_ms=seconds(saved, lambda: run._tail(count)) * 1e3,
                   unit_ms=unit(saved, f"tail/{lanes}", ("tail",),
                                lambda _s: run._tail(lanes)) * 1e3, fine_lanes=fine)
        row["fine_ms"] = row["unit_ms"] if fine >= lanes else unit(
            saved, f"tail/{fine}", ("tail",), lambda _s: run._tail(fine)) * 1e3
        rows.append(row)
        run.restore(saved)
        run._tail(count)
        count = int(run.count)
    return rows


def _device_split(fn):
    """Device microseconds of one ``fn()`` under ``torch.profiler``: the
    sum of all kernels' time, and that of the BVH4 traversal kernel. Only
    the device-side events count; the host ops that launched them carry
    the same time again."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    total = kernel = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += e.self_device_time_total
        if "bvh4_traverse" in e.key:
            kernel += e.self_device_time_total
    return total, kernel


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=690)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--M", type=int, nargs="*", default=[128, 256])
    ap.add_argument("--check", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import terra_tpu_torch as ttt
    from terra_tpu_torch import camera as camera_mod, graphs
    from terra_tpu_torch.accel import compact as cc
    from terra_tpu_torch.accel import pallas_traverse as pt
    from terra_tpu_torch.accel import traverse
    from terra_tpu_torch.intersect import T_FAR

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("compact_bench: no CUDA device (pass --device cpu for the plain walks)")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    scene = ttt.scenes.courtyard(grid=args.grid, columns=40, device=dev)
    bvh = scene.bvh
    print(f"scene {scene.geometry.num_triangles} tris leaf {bvh.leaf_size} wide {bvh.num_wide} "
          f"({time.perf_counter() - t0:.2f} s), device {where}", flush=True)

    side = 1024
    cam = ttt.scenes.courtyard_camera(device=dev)
    py, px = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev),
                            indexing="ij")
    px, py = px.reshape(-1).float(), py.reshape(-1).float()
    zeros = torch.zeros_like(px)
    o, d = camera_mod.generate_rays(cam, side, side, px, py, 0.0, zeros, zeros)
    order = traverse.sort_order(bvh, o, d, "dir3")
    o = o[order][: args.rays].contiguous()
    d = d[order][: args.rays].contiguous()
    n = o.shape[0]

    tables = pt.pack_tables_auto(bvh, *scene.geometry.corners())
    print(f"box_enc={pt.wide_mode(bvh)}, {n} dir3-sorted camera rays", flush=True)
    ref_t, ref_i = pt.traverse_packed(tables, o, d)
    classic_s = _seconds(lambda: pt.traverse_packed(tables, o, d), dev)
    print(f"classic: {n / classic_s / 1e6:.2f} Mrays/s ({classic_s * 1e3:.3f} ms)", flush=True)
    out = {"device": where, "tris": scene.geometry.num_triangles, "rays": n,
           "classic_s": classic_s, "M": {}}

    for m in args.M:
        t0 = time.perf_counter()
        fr = cc.build_frontier(bvh, max_leaves=m)
        frontier_s = time.perf_counter() - t0
        f = int(fr.roots.shape[0])
        n_leaf = int((fr.roots >= bvh.num_wide).sum())
        print(f"\nM={m}: F={f} ({n_leaf} single-leaf roots; frontier {frontier_s:.3f} s)",
              flush=True)
        stats = {}
        t0 = time.perf_counter()
        launches = _launches4(lambda: cc.raycast_compact(bvh, tables, fr, o, d, stats=stats))
        first_s = time.perf_counter() - t0
        again = {}
        hit = cc.raycast_compact(bvh, tables, fr, o, d, stats=again)
        units = [u.describe() for u in stats["units"].values()
                 if isinstance(u, graphs.StagedUnit)]
        graphed = lambda: cc.raycast_compact(bvh, tables, fr, o, d)  # noqa: E731
        eager = lambda: cc.raycast_compact_eager(bvh, tables, fr, o, d)  # noqa: E731
        eager_hit = eager()
        words = _words(hit, eager_hit)
        l_graphed, l_eager = _launches4(graphed), _launches4(eager)
        print(f"  rounds {stats['rounds']}, active rays per tail round {stats['active']}, "
              f"lanes run per tail round {stats['buckets']}; first call (captures "
              f"{stats['captures']}) {first_s:.3f} s with {launches} BVH4 launches; a later call "
              f"captures {again['captures']}, replays {again['replays']} units; BVH4 launches "
              f"per call graphed {l_graphed}, eager {l_eager}; hits vs eager: {words} words "
              f"differ", flush=True)
        for u in units:
            print(f"  unit {u['label']}: warm-up {u['warmup_s']:.3f} s, capture "
                  f"{u['capture_s']:.3f} s, pool growth {u['pool_bytes'] / 2**20:.1f} MiB, "
                  f"replays {u['replays']}", flush=True)
        if words or again["captures"] or l_graphed != l_eager:
            raise AssertionError(f"the compact call disagrees with the eager one at M={m}")
        compact_s = _seconds(graphed, dev)
        ab = _turns({"eager": eager, "graphed": graphed}, dev)
        med = {k: sorted(v)[1] for k, v in ab.items()}
        head = stats["units"].get("head")
        phase1_s = _seconds((lambda: head.replay("phase1")) if head is not None else
                            (lambda: cc.first_ranks(fr, o, d, 2)), dev)
        print(f"  compact: {n / compact_s / 1e6:.2f} Mrays/s ({compact_s * 1e3:.3f} ms), "
              f"{compact_s / classic_s:.1f}x the classic walk; phase 1 alone "
              f"{phase1_s * 1e3:.3f} ms ({phase1_s / compact_s:.1%}); in turns (E G G E E G) "
              f"median eager {med['eager'] * 1e3:.3f} ms, graphed {med['graphed'] * 1e3:.3f} ms",
              flush=True)
        stages = _stage_times(cc, graphs, tables, fr, o, d, (1, 8, 64), dev)
        for r in stages:
            fine = f", at {r['fine_lanes']} lanes {r['fine_ms']:.3f} ms" if "fine_ms" in r else ""
            print(f"  {r['stage']}: {r['active']} active, op by op {r['exact_ms']:.3f} ms; unit at "
                  f"{r['lanes']} lanes ({r['entries']} sweep entries) {r['unit_ms']:.3f} ms{fine}",
                  flush=True)
        row = {"F": f, "frontier_s": frontier_s, "rounds": stats["rounds"],
               "active": stats["active"], "buckets": stats["buckets"], "launches": launches,
               "compact_s": compact_s, "phase1_s": phase1_s, "first_call_s": first_s,
               "captures": stats["captures"], "captures_again": again["captures"],
               "replays_per_call": again["replays"], "launches_graphed": l_graphed,
               "launches_eager": l_eager, "eager_words": words, "turns_s": ab,
               "eager_median_s": med["eager"], "graphed_median_s": med["graphed"],
               "warmup_s": sum(u["warmup_s"] for u in units),
               "capture_s": sum(u["capture_s"] for u in units),
               "pool_bytes": sum(u["pool_bytes"] for u in units), "units": units,
               "stages": stages}
        if dev.type == "cuda":
            total_us, kernel_us = _device_split(
                lambda: cc.raycast_compact(bvh, tables, fr, o, d))
            print(f"  device time of one traced call: {total_us / 1e3:.3f} ms, of it the "
                  f"traversal kernel {kernel_us / 1e3:.3f} ms", flush=True)
            row.update(device_ms=total_us / 1e3, kernel_ms=kernel_us / 1e3)
        if args.check:
            h1 = ref_t < T_FAR
            mm = int((h1 != hit.hit).sum())
            both = h1 & hit.hit
            tm = int((~torch.isclose(ref_t[both], hit.t[both], rtol=1e-4, atol=1e-4)).sum())
            same = float((ref_i[both] == hit.tri[both]).float().mean()) if bool(both.any()) \
                else 1.0
            print(f"  check: hit mismatch {mm}, t mismatch {tm}, same-tri {same:.6f}", flush=True)
            row.update(hit_mismatch=mm, t_mismatch=tm, same_tri=same)
            if mm or tm or same < 0.99:
                raise AssertionError(f"compact path disagrees with the classic walk at M={m}")
        out["M"][m] = row
    return out


if __name__ == "__main__":
    main()
