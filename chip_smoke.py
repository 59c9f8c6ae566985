#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``terra_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and the script
exits non-zero (there is no CPU fallback):

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. build the CUDA traversal kernel (nvcc, sm_90a) and the native SAH
     builder (g++) from the sources in this checkout, timed;
  2. kernel gate on the 241,764-triangle courtyard: the CUDA kernel against
     its plain PyTorch version on the card (2^20 camera rays, 2^18 uniform
     random rays, 2^18 occlusion rays with t_max, plus watertight), and
     2048 camera rays against brute force; CUDA-event times after warm-up;
  3. the main path: ``terra_tpu_torch.render`` of the production courtyard
     render (384x384, 8 spp, 2 bounces, DIRECT, persistent lanes of 8),
     with the kernel launches it made;
  4. twin: a small courtyard rendered on CPU tensors (plain traversal) and
     on CUDA tensors (the kernel), compared with the golden-test budgets.

The last two lines are a JSON object describing the kernel, the
``nvidia-smi`` line, and then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _compare(name, kernel, plain, t_max=None):
    """Kernel (best_t, best_i) vs plain with the traversal test budgets:
    hit masks equal, t within rtol 1e-4, >= 99% same triangle. Returns the
    max |dt| over hits."""
    from terra_tpu_torch.intersect import T_FAR

    (tk, ik), (tp, ip) = kernel, plain
    far = T_FAR if t_max is None else t_max
    hk, hp = tk < far, tp < far
    n_bad_hit = int((hk != hp).sum())
    hit = hk & hp
    dt = (tk[hit] - tp[hit]).abs()
    max_err = float(dt.max()) if bool(hit.any()) else 0.0
    t_ok = bool((dt <= 1e-4 * tp[hit].abs()).all())
    same_tri = float((ik[hit] == ip[hit]).float().mean()) if bool(hit.any()) else 1.0
    exact = int((tk != tp).sum()) + int((ik != ip).sum())
    print(f"  {name}: rays {tk.numel()} hits {int(hk.sum())} hit-mask mismatches {n_bad_hit} "
          f"max|dt| {max_err:.3e} same-tri {same_tri:.6f} words differing {exact}", flush=True)
    if n_bad_hit or not t_ok or same_tri < 0.99:
        raise AssertionError(f"kernel disagrees with raycast_plain on {name}")
    return max_err


def _twin_match(img, ref, tol=2e-3, flip_budget=8e-3, energy_tol=5e-3):
    """tests/test_golden.py::_assert_twin_match's budgets: pixels above a
    relative deviation of tol and of 1e-4 each within the flip budget, and
    the mean image energy within energy_tol."""
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), 1e-2)
    fracs = {t: float((rel > t).mean()) for t in (tol, 1e-4)}
    energy = abs(img.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    print(f"  twin: frac>{tol:g} {fracs[tol]:.5f} frac>1e-4 {fracs[1e-4]:.5f} "
          f"(budget {flip_budget:g}) energy {energy:.3e} (budget {energy_tol:g}) "
          f"max rel {rel.max():.3e}", flush=True)
    if max(fracs.values()) > flip_budget or energy >= energy_tol:
        raise AssertionError("cpu and cuda renders differ beyond the twin budgets")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")

    # 0. the card
    smi = _smi()
    print(smi, flush=True)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import terra_tpu_torch as ttt
    from terra_tpu_torch import _build, camera, intersect, native
    from terra_tpu_torch.accel import pallas_traverse as pt
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import _lane_ids

    # 1. builds
    t0 = time.perf_counter()
    pt.load_kernel()
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    t_native = time.perf_counter() - t0
    print(f"phase 1: built bvh_traverse (nvcc sm_90a) in {t_kernel:.2f} s, "
          f"terra_native (g++) in {t_native:.2f} s", flush=True)
    for line in _build.build_log(pt.kernel_path()).splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("  ptxas: " + line.strip(), flush=True)

    # 2. kernel gate on the full courtyard
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scene = ttt.scenes.courtyard(device=dev)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    bvh = scene.bvh
    tables = pt.pack_tables(bvh, *scene.geometry.corners())
    print(f"phase 2: courtyard {scene.geometry.num_triangles} tris, {bvh.num_leaves} leaves "
          f"(leaf {bvh.leaf_size}), depth {bvh.depth}, built+committed in {t_scene:.2f} s; "
          f"tables {tables.nodes.numel() * 4 / 2**20:.1f} MiB nodes, "
          f"{(tables.tris.numel() + tables.tri_id.numel()) * 4 / 2**20:.1f} MiB tris", flush=True)
    cam = ttt.scenes.courtyard_camera(device=dev)
    w = 1024
    opts_cam = ttt.RenderOptions(width=w, height=w, samples_per_pixel=1, subpixel_jitter=0.5)
    pixel_idx, px, py, sample_idx = _lane_ids(opts_cam, 1, 0, 0, w, dev)
    r1, r2 = rng.path_uniform2(rng.key_from_seed(0), pixel_idx, sample_idx, 0, 0)
    o_cam, d_cam = camera.generate_rays(cam, w, w, px, py, 0.5, r1, r2)
    o_cam = (o_cam + d_cam * intersect.RAY_OFFSET_DIR).contiguous()
    d_cam = d_cam.contiguous()
    gen = np.random.default_rng(11)
    n_inc = 1 << 18
    lo, hi = bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy()
    o_inc = torch.as_tensor(lo + gen.random((n_inc, 3), np.float32) * (hi - lo), device=dev)
    v = gen.normal(size=(n_inc, 3)).astype(np.float32)
    d_inc = torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=dev)
    t_occ = torch.as_tensor(gen.uniform(0.05, 30.0, n_inc).astype(np.float32), device=dev)

    cases = [("camera 2^20 closest-hit mt", o_cam, d_cam, None, False, "mt"),
             ("random 2^18 closest-hit mt", o_inc, d_inc, None, False, "mt"),
             ("random 2^18 occlusion t_max+any_hit mt", o_inc, d_inc, t_occ, True, "mt"),
             ("random 2^18 occlusion t_max mt", o_inc, d_inc, t_occ, False, "mt"),
             ("random 2^18 closest-hit watertight", o_inc, d_inc, None, False, "watertight")]
    max_err = 0.0
    times = {}
    for name, o, d, tm, any_hit, algo in cases:
        k = pt.raycast_cuda(tables, o, d, tm, any_hit, algo)
        p = pt.raycast_plain(tables, o, d, tm, any_hit, algo)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(name, k, p, tm))
        kernel_ms = _ms(torch, lambda: pt.raycast_cuda(tables, o, d, tm, any_hit, algo), 20)
        plain_ms = _ms(torch, lambda: pt.raycast_plain(tables, o, d, tm, any_hit, algo), 1)
        times[name] = (kernel_ms, plain_ms)
        print(f"  {name}: kernel {kernel_ms:.3f} ms ({o.shape[0] / kernel_ms / 1e3:.1f} Mrays/s), "
              f"plain {plain_ms:.3f} ms ({o.shape[0] / plain_ms / 1e3:.2f} Mrays/s)", flush=True)

    n_check = 2048
    hk = pt.raycast(scene, o_cam[:n_check], d_cam[:n_check])
    hb = intersect.raycast_brute(o_cam[:n_check], d_cam[:n_check], *scene.geometry.corners())
    n_bad = int((hk.hit != hb.hit).sum())
    both = hk.hit & hb.hit
    t_close = bool(torch.allclose(hk.t[both], hb.t[both], rtol=1e-4, atol=1e-4))
    same = float((hk.tri[both] == hb.tri[both]).float().mean())
    print(f"  brute force {n_check} camera rays: hit-mask mismatches {n_bad}, t close {t_close}, "
          f"same-tri {same:.4f}", flush=True)
    if n_bad or not t_close:
        raise AssertionError("kernel disagrees with brute force")

    # 3. the main path: the production courtyard render
    opts = ttt.RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             samples_per_lane=8)
    ttt.render(scene, cam, opts.replace(width=32, height=32), seed=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pt.launches = 0
    t0 = time.perf_counter()
    film = ttt.render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    render_launches = pt.launches
    img = ttt.develop(film)
    nominal = opts.width * opts.height * opts.samples_per_pixel * (opts.bounces + 1) * 2
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    out = os.path.join(tempfile.gettempdir(), "terra_tpu_torch_courtyard.npy")
    np.save(out, img.cpu().numpy())
    print(f"phase 3: courtyard render 384x384x8spp bounces 2 DIRECT lanes of 8: {t_render:.3f} s, "
          f"nominal {nominal / t_render / 1e6:.2f} Mrays/s ({nominal} rays = pixels*spp*"
          f"(bounces+1)*2), kernel launches {render_launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image mean {mean:.5f}, "
          f"finite {finite}, written to {out}", flush=True)
    if render_launches <= 0 or not finite or not mean > 0.0:
        raise AssertionError("main-path render failed its checks")

    # 4. twin: cpu tensors (plain) vs cuda tensors (kernel)
    kw = dict(grid=40, columns=8)
    topts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=4, bounces=2,
                              integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    imgs = []
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        s = ttt.scenes.courtyard(**kw, device=device)
        f = ttt.render(s, ttt.scenes.courtyard_camera(device=device), topts, seed=3)
        imgs.append(f.mean().cpu().numpy())
        print(f"phase 4: small courtyard ({s.geometry.num_triangles} tris) 32x32x4spp DIRECT on "
              f"{device}: {time.perf_counter() - t0:.2f} s, mean {imgs[-1].mean():.5f}", flush=True)
    _twin_match(imgs[1], imgs[0])

    k_ms, p_ms = times["camera 2^20 closest-hit mt"]
    print(json.dumps({"kernels": [{
        "name": "bvh_traverse", "route": "cuda",
        "source": "terra_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "terra_tpu/accel/pallas_traverse.py:81",
        "launches": render_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
