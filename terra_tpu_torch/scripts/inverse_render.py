"""Inverse rendering demo (bench config 4): recover the Cornell box's wall
albedo and light emission from a rendered target by pixel-loss gradients.

    python -m terra_tpu_torch.scripts.inverse_render [--steps 600] [--device cuda]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m terra_tpu_torch.scripts.inverse_render --sharded --backend gloo
    python -m terra_tpu_torch.scripts.inverse_render --sharded --cpu-mesh 4 --device cpu

The port of ``scripts/inverse_render.py``, with its arguments and printed
lines, and a last line with every step's loss. ``--sharded`` runs
``optim.recover`` on the sharded step over every rank of the process
group (``parallel.mesh.make_mesh()``: pixel rows over the ranks), one
process per rank as ``torchrun`` starts them; several ranks on one card
need ``--backend gloo``. ``--cpu-mesh N`` starts N local gloo ranks on
the CPU from this one command. Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--sharded", action="store_true", help="use the rows mesh over every rank")
    p.add_argument("--cpu-mesh", type=int, nargs="?", const=8, default=0,
                   help="start this many local gloo ranks on the CPU (default 8)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend of --sharded (default: nccl on cuda, gloo "
                        "on cpu; gloo for several ranks on one card)")
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)
    if args.cpu_mesh:
        from terra_tpu_torch.parallel import distributed

        distributed.spawn_cpu(_recover, args.cpu_mesh, args, "cpu")
        return {}
    if args.sharded:
        from terra_tpu_torch.parallel import distributed

        distributed.initialize(backend=args.backend, device=args.device)
    return _recover(args, args.device)


def _recover(args, dev: str) -> dict:
    """Target, perturbed start and recover() on this process (one rank of
    the process group when sharded)."""
    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng as rng_mod
    from terra_tpu_torch.parallel import distributed

    mesh = None
    if args.sharded or args.cpu_mesh:
        from terra_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=dev)
        dev = mesh.device
    coord = distributed.is_coordinator()
    scene_gt = ttt.scenes.cornell_box(with_blocks=False, device=dev)
    cam = ttt.scenes.cornell_camera(device=dev)
    opts = ttt.RenderOptions(width=args.size, height=args.size, samples_per_pixel=args.spp,
                             bounces=2, integrator=ttt.Integrator.DIRECT, rr_start_bounce=8)
    with torch.no_grad():
        target = optim.render_mean_image(scene_gt, cam, opts, rng_mod.key_from_seed(7), 0,
                                         args.spp)

    # perturb: a wrong wall albedo and a wrong emission
    attrs0 = scene_gt.materials.attrs.clone()
    attrs0[0, 0, :] = torch.tensor([0.3, 0.5, 0.6], device=dev)
    em0 = scene_gt.materials.emissive.clone()
    em0[3, :] = 5.0
    scene0 = dataclasses.replace(scene_gt, materials=dataclasses.replace(
        scene_gt.materials, attrs=attrs0, emissive=em0))

    t0 = time.perf_counter()
    recovered, losses = optim.recover(scene0, cam, opts, target, fields=("attrs", "emissive"),
                                      steps=args.steps, learning_rate=args.lr, seed=7,
                                      mesh=mesh, log_every=max(args.steps // 10, 1) if coord else 0)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    alb = recovered.materials.attrs[0, 0].cpu().numpy()
    em = recovered.materials.emissive[3].cpu().numpy()
    ok = bool(np.abs(alb - 0.73).max() < 0.12 and np.abs(em - 15).max() < 3.0)
    if coord:
        print(f"\n{args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step)")
        print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
        print(f"recovered wall albedo {alb.round(3)}  (truth [0.73 0.73 0.73])")
        print(f"recovered emission    {em.round(2)}  (truth [15 15 15])")
        print("RECOVERED" if ok else "NOT CONVERGED (try more steps)")
        print("losses " + json.dumps(losses), flush=True)
    return {"seconds": dt, "losses": losses, "albedo": alb, "emission": em, "recovered": ok}


if __name__ == "__main__":
    main()
