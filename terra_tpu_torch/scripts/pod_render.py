"""Pod render (bench config 5): a 4k x 4k Cornell box at a high sample
count, pixel rows (and optionally samples) sharded over every rank, with
sample-chunked progressive accumulation and periodic checkpoints that a
new run resumes, in the same or another layout.

Launch one process per rank with ``torchrun``:

    python -m torch.distributed.run --standalone --nproc-per-node 1 \\
        -m terra_tpu_torch.scripts.pod_render --width 4096 --height 4096 --spp 1024 \\
        --chunk 8 --row-band 64 --checkpoint pod_render.npz -o pod_render.png

Each rank renders on ``cuda:(LOCAL_RANK % device_count)`` through NCCL;
several ranks on one card need ``--backend gloo``. ``--cpu-mesh N`` starts
N local gloo ranks on the CPU from this one command (a development run).
The port of ``scripts/pod_render.py``, with its arguments, defaults and
printed lines, and ``--device``, ``--backend`` and ``--cpu-mesh N``.

Each rank keeps the film of the rows it renders; a checkpoint and the
image gather the whole frame (``parallel.mesh.gather_rows``), which only
the coordinator (rank 0) writes, atomically. A resumed run reads the
whole-frame film and takes its own rows.
"""
from __future__ import annotations

import argparse
import os
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=4096)
    p.add_argument("--height", type=int, default=4096)
    p.add_argument("--spp", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=8, help="spp per launch")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--integrator", default="direct-mis")
    p.add_argument("--sample-ways", type=int, default=1)
    p.add_argument("--row-band", type=int, default=0,
                   help="rows per launch (0 = whole frame); bounds the live wavefront of "
                        "4k-class frames (about 1 KB of device memory a lane; keep "
                        "row-band x width x chunk / samples-per-lane at or below 2^21)")
    p.add_argument("--samples-per-lane", type=int, default=1,
                   help="persistent-lane quota (see RenderOptions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--checkpoint-every", type=int, default=4, help="chunks")
    p.add_argument("-o", "--output", default="pod_render.png")
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, gloo on cpu; "
                        "gloo for several ranks on one card)")
    p.add_argument("--cpu-mesh", type=int, nargs="?", const=8, default=0,
                   help="start this many local gloo ranks on the CPU (default 8)")
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.cpu_mesh:
        from terra_tpu_torch.parallel import distributed

        distributed.spawn_cpu(_render, args.cpu_mesh, args, "cpu")
        return
    from terra_tpu_torch.parallel import distributed

    distributed.initialize(backend=args.backend, device=args.device)
    _render(args, args.device)


def _render(args, device: str) -> None:
    """One rank's part of the render (the process group is joined)."""
    import torch
    import torch.distributed as dist

    import terra_tpu_torch as ttt
    from terra_tpu_torch.checkpoint import load_render_state, save_render_state
    from terra_tpu_torch.config import _INTEGRATOR
    from terra_tpu_torch.film import Film, develop
    from terra_tpu_torch.ops import rng as rng_mod
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import band_rows_of, gather_rows, render_band_sharded

    mesh = distributed.pod_mesh(args.sample_ways, device=device)
    coord = distributed.is_coordinator()
    if coord:
        print(f"mesh: {dict(mesh.shape)} over {dist.get_world_size()} devices", flush=True)

    dev = mesh.device
    scene = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BRUTE, device=dev)
    cam = ttt.scenes.cornell_camera(device=dev)
    opts = ttt.RenderOptions(width=args.width, height=args.height, samples_per_pixel=args.spp,
                             bounces=args.bounces, integrator=_INTEGRATOR[args.integrator],
                             subpixel_jitter=0.5, samples_per_lane=args.samples_per_lane)
    key = rng_mod.key_from_seed(args.seed)
    band = args.row_band or args.height
    rows = band_rows_of(mesh, args.height, band)
    rows_per = band // mesh.shape["rows"]

    acc = torch.zeros((rows.numel(), args.width, 3), dtype=torch.float32, device=dev)
    samples = torch.zeros((rows.numel(), args.width), dtype=torch.int32, device=dev)
    done = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        film, _, _ = load_render_state(args.checkpoint, device=dev)
        done = int(film.samples.max())
        acc, samples = film.acc[rows.to(dev)], film.samples[rows.to(dev)]
        del film
        if coord:
            print(f"resumed at {done} spp", flush=True)

    def frame() -> Film:
        return Film(acc=gather_rows(acc, rows, args.height, mesh),
                    samples=gather_rows(samples, rows, args.height, mesh))

    chunk_i = 0
    while done < args.spp:
        cur = min(args.chunk, args.spp - done)
        t0 = time.perf_counter()
        for i, b0 in enumerate(range(0, args.height, band)):
            part = render_band_sharded(scene, cam, opts, key, done, b0, cur, band, mesh)
            acc[i * rows_per:(i + 1) * rows_per] += part
        samples += cur
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        done += cur
        chunk_i += 1
        dt = time.perf_counter() - t0
        lanes = opts.width * opts.height * cur
        if coord:
            print(f"spp {done}/{args.spp}  chunk {dt:.2f}s  "
                  f"{lanes * (opts.bounces + 1) / dt / 1e6:.1f} Mlane-bounces/s", flush=True)
        if args.checkpoint and chunk_i % args.checkpoint_every == 0:
            full = frame()
            if coord:
                save_render_state(args.checkpoint, full, args.seed)

    full = frame()
    if coord:
        from terra_tpu_torch.io.image import save_image

        save_image(args.output, develop(full, ttt.Tonemap.LINEAR, 1.0, 2.2))
        print(f"wrote {args.output}", flush=True)


if __name__ == "__main__":
    main()
