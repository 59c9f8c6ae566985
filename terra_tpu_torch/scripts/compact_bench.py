"""Compacted two-phase traversal against the classic kernel on the 3m
workload: the 1,013,964-triangle courtyard, 2^20 camera rays sorted by
dir3 keys. Port of ``scripts/compact_bench.py``.

    python -m terra_tpu_torch.scripts.compact_bench [--M 128 256] [--grid 690]
                                                    [--rays 1048576] [--check 1]

It walks the sorted rays with ``traverse_packed`` on the tables
``pack_tables_auto`` picks (the classic walk), then, for each frontier size
M, with ``compact.raycast_compact`` (rows of 128 lanes), and holds the
compact result to the classic one: no hit-mask mismatch, t within rtol and
atol 1e-4, and at least 99% of hits on the same triangle. Times are the
least of 3 runs after a warm-up, on the host clock after
``torch.cuda.synchronize()`` (the compact path reads its active set back
to the host every tail round). Phase 1 (``first_ranks``) is timed alone
the same way, and on the card one compact call is traced with
``torch.profiler`` to split its device time between the traversal kernel
and the rest. It runs on the CUDA device; ``--device cpu`` takes the
plain walks instead (at a small ``--grid``). The reference's ``--shape``
(the TPU kernel's packet shape) has no counterpart. ``main`` returns the
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
    from terra_tpu_torch import camera as camera_mod
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
        before = pt.launches4
        hit = cc.raycast_compact(bvh, tables, fr, o, d, stats=stats)
        launches = pt.launches4 - before
        print(f"  rounds {stats['rounds']}, active rays per tail round {stats['active']}, "
              f"BVH4 launches per call {launches}", flush=True)
        compact_s = _seconds(lambda: cc.raycast_compact(bvh, tables, fr, o, d), dev)
        phase1_s = _seconds(lambda: cc.first_ranks(fr, o, d, 2), dev)
        print(f"  compact: {n / compact_s / 1e6:.2f} Mrays/s ({compact_s * 1e3:.3f} ms), "
              f"{compact_s / classic_s:.1f}x the classic walk; phase 1 alone "
              f"{phase1_s * 1e3:.3f} ms ({phase1_s / compact_s:.1%})", flush=True)
        row = {"F": f, "frontier_s": frontier_s, "rounds": stats["rounds"],
               "active": stats["active"], "launches": launches, "compact_s": compact_s,
               "phase1_s": phase1_s}
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
