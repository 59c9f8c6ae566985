"""Scaling-efficiency harness (the port of ``scripts/scaling_bench.py``).

Measures nominal rays/s of the sharded render (pixel rows over the ranks,
the Cornell box by brute force, SIMPLE) on 1, 2, 4, ... of the process
group's ranks and reports each against the one-rank rate, with the
reference's JSON line. One process per rank, as ``torchrun`` starts them:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m terra_tpu_torch.scripts.scaling_bench [--width 512 --spp 32]
    python -m terra_tpu_torch.scripts.scaling_bench --cpu-mesh 4 --device cpu

On a machine with one card there is one rank per card only at
``devices=1``: several ranks that share the card (``--backend gloo``)
time-slice it and measure no scaling, so a one-card run reports
``devices=1`` alone unless it is asked for more ranks. ``--cpu-mesh N``
starts N local gloo ranks on the CPU, which checks the harness; their
efficiency reflects the host's cores, not a link between devices.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--cpu-mesh", type=int, nargs="?", const=8, default=0,
                   help="start this many local gloo ranks on the CPU (default 8)")
    args = p.parse_args(argv)

    from terra_tpu_torch.parallel import distributed

    if args.cpu_mesh:
        distributed.spawn_cpu(_bench, args.cpu_mesh, args, "cpu")
        return
    distributed.initialize(backend=args.backend, device=args.device)
    _bench(args, args.device)


def _bench(args, device: str) -> None:
    """One rank's part: every layout size in turn (ranks outside a layout
    wait at its barriers)."""
    import torch
    import torch.distributed as dist

    import terra_tpu_torch as ttt
    from terra_tpu_torch.ops import rng as rng_mod
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import local_device, make_mesh, render_chunk_sharded

    dev = local_device(device)
    scene = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BRUTE, device=dev)
    cam = ttt.scenes.cornell_camera(device=dev)
    opts = ttt.RenderOptions(width=args.width, height=args.height, samples_per_pixel=args.spp,
                             bounces=args.bounces, integrator=ttt.Integrator.SIMPLE,
                             subpixel_jitter=0.5)
    key = rng_mod.key_from_seed(0)
    lanes = args.width * args.height * args.spp
    nominal_rays = lanes * 2.4  # the reference's average raycasts per lane

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    world = dist.get_world_size()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    results = {}
    coord = distributed.is_coordinator()
    for n in sizes:
        mesh = make_mesh((n, 1), device=device, ranks=n)

        def run(off):
            if mesh is not None:
                render_chunk_sharded(scene, cam, opts, key, off, args.spp, mesh)

        run(0)
        sync()
        t0 = time.perf_counter()
        for i in range(args.iters):
            run(i * args.spp)
        sync()
        dt = (time.perf_counter() - t0) / args.iters
        results[n] = nominal_rays / dt / 1e6
        eff = results[n] / (results[sizes[0]] * n / sizes[0])
        if coord:
            print(f"devices={n:3d}  {results[n]:9.1f} Mrays/s  efficiency={eff:5.2f}", flush=True)

    if coord:
        base = results[sizes[0]]
        print(json.dumps({
            "metric": "scaling_efficiency",
            "total_mrays_by_mesh_size": {str(k): round(v, 1) for k, v in results.items()},
            "efficiency_at_max": round(results[sizes[-1]] / (base * sizes[-1]), 3),
            "devices": sizes[-1],
        }), flush=True)


if __name__ == "__main__":
    main()
