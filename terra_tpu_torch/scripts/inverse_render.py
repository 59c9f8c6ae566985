"""Inverse rendering demo (bench config 4): recover the Cornell box's wall
albedo and light emission from a rendered target by pixel-loss gradients.

    python -m terra_tpu_torch.scripts.inverse_render [--steps 600] [--device cuda]

The port of ``scripts/inverse_render.py``, with its arguments and printed
lines; the sharded loop (``--sharded``, ``--cpu-mesh``) waits for the
port's ``torch.distributed`` layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)

    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng as rng_mod

    dev = args.device
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
                                      log_every=max(args.steps // 10, 1))
    if dev != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    alb = recovered.materials.attrs[0, 0].cpu().numpy()
    em = recovered.materials.emissive[3].cpu().numpy()
    print(f"\n{args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step)")
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
    print(f"recovered wall albedo {alb.round(3)}  (truth [0.73 0.73 0.73])")
    print(f"recovered emission    {em.round(2)}  (truth [15 15 15])")
    ok = bool(np.abs(alb - 0.73).max() < 0.12 and np.abs(em - 15).max() < 3.0)
    print("RECOVERED" if ok else "NOT CONVERGED (try more steps)")
    return {"seconds": dt, "losses": losses, "albedo": alb, "emission": em, "recovered": ok}


if __name__ == "__main__":
    main()
