#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``terra_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line or more each; any failure raises and the script
exits non-zero (there is no CPU fallback):

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. build both CUDA traversal kernels and the pattern-probe kernels (nvcc,
     sm_90a) and the native SAH builder (g++) from the sources in this
     checkout, all at once, timed; each kernel instance's ptxas footprint
     (registers, stack frame, spills, static shared memory), and the SASS
     of every probe kernel (``cuobjdump -sass``) checked for the TMA bulk
     copy (UBLKCP) and the mbarrier wait (SYNCS.PHASECHK);
  2. binary-kernel gate on the 241,764-triangle courtyard: the kernel
     against its plain PyTorch version on the card (2^20 camera rays, 2^18
     uniform random rays, 2^18 occlusion rays with t_max, plus
     watertight), and 2048 camera rays against brute force; CUDA-event
     times after warm-up;
  2b. BVH4 gate on the same courtyard and on the 1,013,964-triangle
     courtyard (bench config 3m): for the f32, bf16 and paged tables (S by
     the port's rule, and S = 1), the same five ray batches, each held
     against ``raycast4_plain`` on the card, against the binary kernel on
     the same tree, and against brute force on 2048 rays; kernel and plain
     times; the counted kernel against the uncounted one, with the
     ``count_decode`` totals. Then the start-link gate on both courtyards
     and every table kind (binary, f32, bf16, paged, paged S=1): 2^18 rays,
     each started at a root of ``compact.build_frontier(bvh, 128)`` (wide
     nodes, single leaves, or root 0) and aimed into its subtree's box,
     without and with ``t_max`` seeds on half of them; the kernel against
     the plain walk, 0 differing words, with both times;
  2c. the traversal kernels on the batches the renders send them: one 3b
     render and one 3g render with ``pallas_traverse.traverse_packed``
     wrapped, keeping the sorted (o, d, t_max, any_hit) of a mid-render
     closest-hit and NEE shadow batch of 3b (147,456 lanes) and a
     closest-hit batch of 3g (262,144 lanes); on each, the BVH4 kernel on
     the render's f32 tables (and on the 3b batches the binary kernel on
     the same tree): 0 differing words against the plain walk (the counted
     BVH4 kernel's per-ray pops and leaf tests included), the time (CUDA
     events, mean of 50 after a warm-up), the bound of these rays, the
     ratio, the counters, and the instance's registers, stack frame, shared
     memory and blocks per SM (``pallas_traverse.occupancy``);
  3. the production courtyard render (config 3b: 384x384, 8 spp, 2
     bounces, DIRECT, persistent lanes of 8; every raycast sorted by the
     reference's parent-hit keys), with the table kind ``pack_tables_auto``
     chose and the launches of each kernel; then the same render with the
     sort switched off, which must give the same image bit for bit;
  3m. the 1M-triangle path: ``traverse_packed`` on bf16 tables over 2^20
     camera rays sorted by dir3 keys, as the bench sorts them (sort time,
     sorted and unsorted traversal times, the sorted results scattered
     back equal to the unsorted ones word for word), with its counters;
     the render of the 1M scene at 3b's settings, sorted and unsorted, as
     in phase 3; the per-stage breakdown of ``profile.stage_breakdown``;
  3g. the full-material render (config 3g): the Cornell box with Phong
     walls and a glass block at bench config 2's width (512x512, 4 bounces,
     DIRECT_MIS, persistent lanes), spp cut from 256 to 16; then the 242k
     courtyard at 3b's settings under DIRECT_MIS with env_on_miss and env
     NEE, lit by a constant sky (0.5, 0.6, 0.8);
  3c. the compacted two-phase traversal (``scripts/compact_bench.py``'s
     workload, through ``terra_tpu_torch.scripts.compact_bench``): the 1M
     courtyard, 2^20 dir3-sorted camera rays, frontiers of M = 128 and 256
     leaves, rows of 128 lanes; F, rounds, active rays per tail round,
     BVH4 launches, and the compact seconds against the classic walk, held
     to it (0 hit-mask mismatches, t within rtol 1e-4, >= 99% same
     triangle);
  4. twins: a small courtyard rendered on CPU tensors (plain traversal)
     and on CUDA tensors (the kernels), once with each table kind (binary,
     f32, bf16, paged with 4 resident nodes), compared with the golden-test
     budgets; then CPU-vs-CUDA twins of the glass, mirror, Phong and Disney
     Cornell boxes, of env NEE on a textured sky, and of the four debug
     integrators, under the reference tests' budgets;
  5. the pattern probes: each of the eleven bodies through its
     ``terra_tpu_torch.scripts`` entry point on the card (it must print OK),
     held word for word against its plain PyTorch version on the same input;
     kernel and plain times (CUDA events, mean of 200 runs after a warm-up);
  6. inverse rendering (``optim.py`` on torch autograd): 6a bench config 4
     (the blockless Cornell box by brute force, 32x32, 8 spp, 2 bounces,
     DIRECT, Adam 3e-2 on attrs from a wall albedo of [0.3, 0.5, 0.6]; one
     warm-up step, then 20 timed, CUDA events and host clock; the loss must
     fall); 6b the same on BVH trees of both builders (SAH, LBVH), so the
     BVH4 kernel runs under autograd: the albedo gradient against 6a's
     within 1e-3, against a central difference within 5%, two calls equal
     bit for bit; 6c ``recover`` on the 242k courtyard at 3b's size (cut:
     one sample per lane, rr_start_bounce 8) for 4 Adam steps on attrs,
     textures and positions with a host refit every step: ms per step split
     into forward, backward, Adam and refit plus repack, BVH4 launches per
     step, peak memory, losses; gates: finite losses and gradients, every
     leaf box holds its moved triangles, two gradient calls equal bit for
     bit (deterministic algorithms on; also timed and compared off), and
     the loss on fixed samples falls under a textures-only recover; 6d the
     12x12 gradient of ``test_grad_albedo_matches_fd`` on CPU and CUDA
     tensors within 1e-3;
  7. the command line at full width: 7a the 242k courtyard written as OBJ +
     MTL + two PNG textures (z negated, faces wound (v0, v2, v1), floats as
     %.9g, texels as round(255 v^(1/2.2))) and read back by
     ``io.obj.load_obj`` on the card, each stage timed (directive scan,
     native parse, atlas, commit with the SAH build); every array must
     come back bit-equal, the tree too, the texels within 8-bit sRGB
     steps; 7b ``python3 -m terra_tpu_torch render courtyard.obj`` in a
     subprocess at 3b's settings (``--passes 2 --checkpoint --stats -o
     out.png``; both passes logged, a 384x384 PNG, a finite 16-spp film,
     the stats report), then ``--resume --passes 1`` to 24 spp, with the
     kernels found built in ``_build/``; 7c ``cli.main`` in this process
     with the same arguments: its film bit-equal to 7b's, traversal
     launches per pass, the render clock, nominal rays/s, the CLI's own
     time and peak memory per pass beside phase 3's 3b render; 7d the CLI
     with ``--device cpu`` and on the card on a small courtyard (golden
     twin budgets), and ``console`` on the card with a scripted stdin;
  8. row x sample sharding on ``torch.distributed`` (``parallel/``), with
     ranks started by ``python -m torch.distributed.run``: 8a config 3b
     through ``render_sharded`` on 4 gloo ranks that share the card with
     CUDA tensors, at meshes (4, 1), (2, 2) and (1, 4), and on one NCCL
     rank at (1, 1); the gathered films against phase 3's film (bit-equal
     at (4, 1) and (1, 1); the twin budgets and max |d| <= 1e-5 of the
     largest value at the others), each rank's BVH4 launches, the host-clock
     median of 3 renders per mesh (the ranks time-slice one card: no
     scaling is measured); 8b phase 6c's gradient and 2 Adam steps with a
     host refit at mesh (2, 2), grad_chunks 2, against ``value_and_grad``
     and ``make_train_step`` on this process (loss and every field within
     1e-5 of its largest entry, grad_chunks 1 against 2 too, parameters
     and refit boxes bit-identical on every rank), ms per step and peak
     memory per rank; 8c bench config 5 through ``-m
     terra_tpu_torch.scripts.pod_render``: the 4096 x 4096 Cornell box by
     brute force, 4 bounces, DIRECT_MIS, chunks of 4, row bands of 2^21
     lanes, spp cut from 1024 to 8 (to 4 if one timed band says the phase
     would pass ~300 s); one NCCL rank killed by SIGKILL once its first
     checkpoint exists, then 4 gloo ranks with 2 sample ways resume it;
     every pixel at the full count and three 64-row bands against
     single-process ``render_rows`` on the same samples; 8d the stackless
     packet walk (``accel.traverse.raycast``, plain PyTorch) on 2^16
     camera rays and 2^16 rays of phase 2c's 3b closest-hit batch against
     the BVH4 kernel (hit masks, t where the ids agree, >= 99% same ids;
     any hit against t_max seeds), both timed.

Phase 1 also builds both traversal kernels with the earlier 64-entry stack;
phase 2b gates both kernels on a 1,700-triangle tree whose BVH4 walk needs
65 of the reference's 160 stack entries; phase 2c times the 160- and
64-entry builds in turns on the 3b batches (words must be equal).

The main path is every run through the user's entry points: the sorted
renders of phases 3, 3m and 3g, the sorted ``traverse_packed`` in phase
3m, the compact bench of phase 3c, the CUDA half of each twin in phase 4
(the binary kernel is on it only there, since ``wide_mode`` picks the
BVH4 overlay for both courtyards), the probe entry points of phase 5 and
the training steps and ``recover`` runs of phase 6, the in-process
command lines of phase 7 (7c and the CUDA half of 7d), and the sharded
renders and training steps of the ranks of phases 8a and 8b (each rank
counts its own launches and reports them). Each is run with the launch counts set to 0 and read after; launches that
compare a kernel with its plain version, time it, or compare a sorted run
with an unsorted one are not counted. The last three lines are a JSON
object describing the kernels (with each one's least time on the card,
``bound_ms``: the larger of the bytes its run needs over 3.35 TB/s and its
operations over the 67 TFLOP/s f32 peak; the traversal kernels add
``main_path_ms``, ``main_path_bound_ms``, ``stack_frame_bytes``,
``smem_per_block`` and ``blocks_per_sm`` from phase 2c), the
``nvidia-smi`` line, and then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

N_CHECK = 2048  # rays held against brute force
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
RAY_BYTES = 32             # o, d in (24 B), t, tri out (8 B)
# Operations of one ray-box slab test and one Moller-Trumbore triangle
# test, counted from the kernels' code (subtractions, products, min/max,
# compares); bytes of one leaf slot (9 f32 corners + an i32 id).
BOX_OPS, TRI_OPS, TRI_SLOT_BYTES = 22, 45, 40
# An inner pop of the binary walk reads two links (8 B) and both children's
# boxes (2 x 32 B) and makes two box tests.
BIN_NODE_BYTES = 8 + 2 * 32
# Twin budgets (tol, flip, energy) of tests/test_golden.py::_assert_twin_match
# as the reference tests set them.
GOLDEN = (2e-3, 8e-3, 5e-3)
DELTA = (2e-3, 1.5e-2, 6e-3)   # test_glass.py:181, test_delta_lighting.py:144
PHONG = (2e-3, 1.2e-2, 5e-3)   # test_golden.py test_golden_phong


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _ms(torch, fn, reps: int, warm_up: bool = True, backlog: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run (``warm_up=False``: the caller has just run it).
    With ``backlog`` the stream first gets a sleep kernel longer than the
    host takes to enqueue the runs (``torch.cuda._sleep``, ~10 ms), so a
    kernel shorter than its wrapper's host cost is timed back to back on
    the device, not at the host's launch rate."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _compare(name, kernel, plain, t_max=None, any_hit=False):
    """Kernel (best_t, best_i) vs a reference with the traversal test
    budgets: hit masks equal, t within rtol 1e-4, >= 99% same triangle
    (any-hit stops at any hit, so there only the masks count). Returns the
    max |dt| over hits."""
    from terra_tpu_torch.intersect import T_FAR

    (tk, ik), (tp, ip) = kernel[:2], plain[:2]
    far = T_FAR if t_max is None else t_max
    hk, hp = tk < far, tp < far
    n_bad_hit = int((hk != hp).sum())
    hit = hk & hp
    dt = (tk[hit] - tp[hit]).abs()
    max_err = float(dt.max()) if bool(hit.any()) else 0.0
    t_ok = any_hit or bool((dt <= 1e-4 * tp[hit].abs()).all())
    same_tri = float((ik[hit] == ip[hit]).float().mean()) if bool(hit.any()) else 1.0
    exact = int((tk != tp).sum()) + int((ik != ip).sum())
    print(f"  {name}: rays {tk.numel()} hits {int(hk.sum())} hit-mask mismatches {n_bad_hit} "
          f"max|dt| {max_err:.3e} same-tri {same_tri:.6f} words differing {exact}", flush=True)
    if n_bad_hit or not t_ok or (same_tri < 0.99 and not any_hit):
        raise AssertionError(f"kernel disagrees with its reference on {name}")
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


def _bound(nbytes: float, ops: float) -> tuple:
    """(least milliseconds on the card, what bounds it)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def _walk_bound(torch, pt, tables, walk, n_inner, n_rays, node_bytes, box_tests):
    """Least time of a BVH walk on these rays: ``walk(visits)`` runs the
    plain walk (which pops what the kernel pops) with per-ray counters and
    adds each pop to ``visits`` at the popped id (inner nodes first, then
    the leaves). Bytes: the rays in and out, each node the rays touch read
    once (``node_bytes``) and the real triangle slots of each leaf they
    touch; operations: every inner pop's ``box_tests`` slab tests and, per
    leaf test, that leaf's real triangles (the kernels stop at the
    padding). Operations are priced at 67 TFLOP/s, which counts an FMA as
    two operations; the kernels are built with -fmad=false for bit-exact
    results, so they cannot reach it. Also prints the bound that counts
    every padded slot and the bytes the pops would move if nothing were
    reused. Returns ((ms, what bounds it), the walk's result)."""
    real = pt.leaf_real_counts(tables)
    visits = torch.zeros(n_inner + real.shape[0], dtype=torch.int32, device=real.device)
    res = walk(visits)
    counts = res[2].sum(dim=0)
    pops, leaves = int(counts[0]), int(counts[1])
    lv = visits[n_inner:].long()
    inner_t, leaf_t = int((visits[:n_inner] > 0).sum()), int((lv > 0).sum())
    tri_tests, tri_touched = int((lv * real).sum()), int(real[lv > 0].sum())
    box_ops = (pops - leaves) * box_tests * BOX_OPS
    bound = _bound(n_rays * RAY_BYTES + inner_t * node_bytes + tri_touched * TRI_SLOT_BYTES,
                   box_ops + tri_tests * TRI_OPS)
    padded = _bound(n_rays * RAY_BYTES + inner_t * node_bytes
                    + leaf_t * tables.leaf_size * TRI_SLOT_BYTES,
                    box_ops + leaves * tables.leaf_size * TRI_OPS)
    no_reuse = n_rays * RAY_BYTES + (pops - leaves) * node_bytes + tri_tests * TRI_SLOT_BYTES
    print(f"  counters: pops {pops} leaf tests {leaves} real triangle tests {tri_tests} (padded "
          f"slots {leaves * tables.leaf_size}); touched {inner_t} inner nodes and {leaf_t} "
          f"leaves; bound {bound[0]:.4f} ms ({bound[1]}; every padded slot: {padded[0]:.4f} ms); "
          f"the pops' bytes without reuse {no_reuse / 2**20:.1f} MiB "
          f"({no_reuse / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    return bound, res


def _sass_check(probes, path):
    """Every probe kernel ports a make_async_copy, so its SASS must hold the
    bulk copy (UBLKCP on sm_90a) and the mbarrier phase wait (SYNCS). The
    instruction names found are printed and returned."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    blocks = {b.split()[0]: b for b in re.split(r"\n\s*Function : ", sass)[1:]}
    found = {}
    for name, (fn, _) in probes.KERNELS.items():
        block = blocks.get(f"{fn}_kernel", "")
        copy = sorted(set(re.findall(r"\bUBLKCP[.\w]*", block)))
        wait = sorted(set(re.findall(r"\bSYNCS\.[.\w]*", block)))
        votes = sorted(set(re.findall(r"\b(?:VOTE|SHFL)[.\w]*", block)))
        print(f"  SASS {fn}_kernel: bulk copy {copy}, mbarrier {wait}, warp ops {votes}",
              flush=True)
        if not copy or not any(w.startswith("SYNCS.PHASECHK") for w in wait):
            raise AssertionError(f"{fn}_kernel lacks the bulk copy or the mbarrier wait in SASS")
        found[name] = copy + wait
    return found


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier of a mangled nested name (``_ZN``, then
    each name preceded by its length), or the name itself."""
    pos = 3 if mangled.startswith("_ZN") else len(mangled)
    while m := re.match(r"\d+", mangled[pos:]):
        pos += m.end()
        ident = mangled[pos:pos + int(m.group(0))]
        if ident.endswith("_kernel"):
            return ident
        pos += len(ident)
    return mangled


def _footprints(log: str) -> dict:
    """{instance: (registers, stack frame B, spill stores B, spill loads B,
    static shared memory B)} of every kernel in a ``ptxas -v`` log; an
    instance is the kernel's name and its template arguments."""
    out, name, frame = {}, None, (0, 0, 0)
    for ln in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            name, frame = m.group(1), (0, 0, 0)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", ln):
            frame = tuple(int(x) for x in m.groups())
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            args = re.search(r"kernelI((?:L[ib]\d+E)+)E", name)
            targs = ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) if args else ""
            label = _kernel_name(name) + (f"<{targs}>" if args else "")
            smem = re.search(r"(\d+) bytes smem", ln)
            out[label] = (int(m.group(1)), *frame, int(smem.group(1)) if smem else 0)
            name = None
    return out


def _print_footprints(lib: str, log: str, params: str) -> dict:
    """Prints each instance's ptxas footprint; returns the footprints."""
    fp = _footprints(log)
    print(f"  {lib}: {len(fp)} kernel instances ({params})", flush=True)
    for label, (regs, frame, st, ld, smem) in sorted(fp.items()):
        print(f"    {label}: {regs} registers, stack frame {frame} B, spill stores {st} B, "
              f"spill loads {ld} B, static smem {smem} B", flush=True)
    return fp


def _camera_rays(torch, cam, side, dev):
    """side^2 jittered camera rays of the courtyard camera, nudged off the
    eye as the render nudges them."""
    import terra_tpu_torch as ttt
    from terra_tpu_torch import camera, intersect
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import _lane_ids

    opts = ttt.RenderOptions(width=side, height=side, samples_per_pixel=1, subpixel_jitter=0.5)
    pixel_idx, px, py, sample_idx = _lane_ids(opts, 1, 0, 0, side, dev)
    r1, r2 = rng.path_uniform2(rng.key_from_seed(0), pixel_idx, sample_idx, 0, 0)
    o, d = camera.generate_rays(cam, side, side, px, py, 0.5, r1, r2)
    return (o + d * intersect.RAY_OFFSET_DIR).contiguous(), d.contiguous()


def _random_rays(torch, bvh, n, dev, seed):
    """n rays with origins uniform in the root box and uniform directions,
    and t_max values for occlusion queries."""
    gen = np.random.default_rng(seed)
    lo, hi = bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy()
    o = torch.as_tensor(lo + gen.random((n, 3), np.float32) * (hi - lo), device=dev)
    v = gen.normal(size=(n, 3)).astype(np.float32)
    d = torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=dev)
    t_occ = torch.as_tensor(gen.uniform(0.05, 30.0, n).astype(np.float32), device=dev)
    return o, d, t_occ


def _cases(o_cam, d_cam, o_inc, d_inc, t_occ):
    """The five ray batches of the kernel gates."""
    return [("camera 2^20 closest-hit mt", o_cam, d_cam, None, False, "mt"),
            ("random 2^18 closest-hit mt", o_inc, d_inc, None, False, "mt"),
            ("random 2^18 occlusion t_max+any_hit mt", o_inc, d_inc, t_occ, True, "mt"),
            ("random 2^18 occlusion t_max mt", o_inc, d_inc, t_occ, False, "mt"),
            ("random 2^18 closest-hit watertight", o_inc, d_inc, None, False, "watertight")]


def _brute(torch, scene, o, d, algo):
    """Closest hit of 2048 rays spread over the batch, by brute force over
    every triangle (in blocks of 8192 triangles). Returns (rows, t, tri,
    n_off).

    The reference's watertight test snaps products that cancel to within a
    few ulps to 0, and where two of its three edge functions snap it can
    accept a triangle the ray passes far from (terra_tpu/intersect.py
    ``watertight_components``; ROADMAP queue C). A BVH walk never tests
    such a triangle, since its box test fails first. Rays whose brute-force
    hit point lies off the hit triangle's bounding box are left out of
    ``rows``; ``n_off`` counts them."""
    from terra_tpu_torch import intersect

    rows = torch.arange(0, o.shape[0], o.shape[0] // N_CHECK, device=o.device)[:N_CHECK]
    corners = scene.geometry.corners()
    h = intersect.raycast_brute(o[rows], d[rows], *corners, tri_block=8192, algo=algo)
    tri = torch.where(h.hit, h.tri, 0)
    p = o[rows] + h.t[:, None] * d[rows]
    lo = torch.minimum(torch.minimum(corners[0][tri], corners[1][tri]), corners[2][tri])
    hi = torch.maximum(torch.maximum(corners[0][tri], corners[1][tri]), corners[2][tri])
    tol = 1e-3 * (1.0 + p.abs())
    off = h.hit & ((p < lo - tol) | (p > hi + tol)).any(dim=1)
    return rows[~off], h.t[~off], tri[~off], int(off.sum())


def _bvh4_gate(torch, pt, scene, label, cam, dev, seed):
    """Phase 2b on one scene. Returns {mode: {"max_abs_err", "ms", "plain_ms"}}
    of its camera batch, the overall max |dt| against the plain walk, and
    the binary kernel's {"ms", "bound_ms", "bound_by"} on the camera batch."""
    bvh = scene.bvh
    corners = scene.geometry.corners()
    o_cam, d_cam = _camera_rays(torch, cam, 1024, dev)
    o_inc, d_inc, t_occ = _random_rays(torch, bvh, 1 << 18, dev, seed)
    cases = _cases(o_cam, d_cam, o_inc, d_inc, t_occ)
    binary = pt.pack_tables(bvh, *corners)
    refs = {}
    t0 = time.perf_counter()
    for name, o, d, tm, any_hit, algo in cases:
        refs[name] = (pt.raycast_cuda(binary, o, d, tm, any_hit, algo),
                      *_brute(torch, scene, o, d, algo))
    torch.cuda.synchronize()
    print(f"phase 2b: {label}: {scene.geometry.num_triangles} tris, {bvh.num_wide} wide nodes, "
          f"wide depth {bvh.wide_depth}, {int((bvh.wide_src < 0).sum())} of "
          f"{4 * bvh.num_wide} child slots empty; binary-kernel and brute-force references "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    binary_camera = {}
    for name, o, d, tm, any_hit, algo in cases:
        ms = _ms(torch, lambda: pt.raycast_cuda(binary, o, d, tm, any_hit, algo), 20)
        print(f"  binary {name}: kernel {ms:.3f} ms ({o.shape[0] / ms / 1e3:.1f} Mrays/s)",
              flush=True)
        if name.startswith("camera"):  # the binary walk's least time on these rays
            (b, by), _ = _walk_bound(torch, pt, binary, lambda visits: pt.raycast_plain(
                binary, o, d, count=True, visits=visits), binary.ni, o.shape[0],
                BIN_NODE_BYTES, 2)
            binary_camera = {"ms": ms, "bound_ms": b, "bound_by": by}
    tables = {"f32": pt.pack_tables_wide(bvh, *corners, box_enc="f32"),
              "bf16": pt.pack_tables_wide(bvh, *corners, box_enc="bf16"),
              "paged": pt.pack_tables_paged(bvh, *corners),
              "paged_s1": pt.pack_tables_paged(bvh, *corners, resident_cap=1)}
    out, max_err = {}, 0.0
    for mode, tab in tables.items():
        print(f"  [{label} {mode}] S={tab.s_resident} node table "
              f"{(tab.nodes.numel() + tab.links.numel()) * 4 / 2**20:.2f} MiB resident",
              flush=True)
        for name, o, d, tm, any_hit, algo in cases:
            k = pt.raycast4_cuda(tab, o, d, tm, any_hit, algo)
            p = pt.raycast4_plain(tab, o, d, tm, any_hit, algo)
            torch.cuda.synchronize()
            err = _compare(f"{mode} {name} vs raycast4_plain", k, p, tm, any_hit)
            max_err = max(max_err, err)
            kb, rows, bt, bi, n_off = refs[name]
            _compare(f"{mode} {name} vs binary kernel", k, kb, tm, any_hit)
            tmr = None if tm is None else tm[rows]
            _compare(f"{mode} {name} vs brute force ({N_CHECK} rays, {n_off} off-triangle "
                     f"brute-force hits left out)", (k[0][rows], k[1][rows]), (bt, bi), tmr,
                     any_hit)
            kernel_ms = _ms(torch, lambda: pt.raycast4_cuda(tab, o, d, tm, any_hit, algo), 20)
            # the comparison run above was the plain walk's warm-up
            plain_ms = _ms(torch, lambda: pt.raycast4_plain(tab, o, d, tm, any_hit, algo), 1,
                           warm_up=False)
            print(f"  {mode} {name}: kernel {kernel_ms:.3f} ms "
                  f"({o.shape[0] / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.3f} ms",
                  flush=True)
            if name.startswith("camera"):
                out[mode] = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}
        for name, o, d, tm, any_hit, algo in cases[:2]:
            k0 = pt.raycast4_cuda(tab, o, d, tm, any_hit, algo)
            k1 = pt.raycast4_cuda(tab, o, d, tm, any_hit, algo, count=True)
            same = torch.equal(k0[0], k1[0]) and torch.equal(k0[1], k1[1])
            p1 = pt.raycast4_plain(tab, o, d, tm, any_hit, algo, count=True)
            same = same and all(torch.equal(a, b) for a, b in zip(k1, p1))
            c = pt.count_decode(k1[2])
            util = float(np.mean(c["pops"] / np.maximum(c["iters"], 1)))
            kernel_ms = _ms(torch, lambda: pt.raycast4_cuda(tab, o, d, tm, any_hit, algo,
                                                            count=True), 20)
            plain_ms = _ms(torch, lambda: pt.raycast4_plain(tab, o, d, tm, any_hit, algo,
                                                            count=True), 1, warm_up=False)
            print(f"  {mode} {name} counted: identical to uncounted and to the counted plain "
                  f"walk {same}; kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms; warps "
                  f"{len(c['iters'])}, iters {int(c['iters'].sum())}, pops "
                  f"{int(c['pops'].sum())}, leaves {int(c['leaves'].sum())}, paged "
                  f"{int(c['paged'].sum())}; mean pops/iters per warp {util:.2f} of 32",
                  flush=True)
            if name.startswith("camera"):  # the least time of this walk
                node_bytes = (pt.WIDE_BF16_NODE_BYTES if tab.box_enc == "bf16"
                              else pt.WIDE_F32_NODE_BYTES)
                b, _ = _walk_bound(torch, pt, tab, lambda visits: pt.raycast4_plain(
                    tab, o, d, tm, any_hit, algo, count=True, visits=visits),
                    tab.num_wide, o.shape[0], node_bytes, 4)
                out[mode].update(bound_ms=b[0], bound_by=b[1])
            pages = 0 < tab.s_resident < tab.num_wide
            if not same or bool(c["paged"].sum() > 0) != pages:
                raise AssertionError(f"counted {mode} run differs from the uncounted one or "
                                     f"the counted plain walk, or counts paged visits wrongly")
    return out, max_err, binary_camera


def _start_gate(torch, pt, scene, label, dev, seed):
    """Start-link gate on one scene (phase 2b): 2^18 rays, each started at
    a frontier root (M = 128) or at root 0 and aimed at a point of that
    subtree's box, walked by the kernel and the plain walk in every table
    kind, without and with t_max seeds on half of the rays. Returns
    {kind: {"max_abs_err", "ms", "plain_ms"}} of the seeded case."""
    from terra_tpu_torch.accel import compact
    from terra_tpu_torch.intersect import T_FAR

    bvh = scene.bvh
    corners = scene.geometry.corners()
    t0 = time.perf_counter()
    fr = compact.build_frontier(bvh, 128)
    frontier_s = time.perf_counter() - t0
    pool = torch.cat([fr.roots, torch.zeros(1, dtype=torch.int32, device=dev)])
    boxes = torch.cat([torch.cat([fr.bmin, bvh.node_min[:1]]),
                       torch.cat([fr.bmax, bvh.node_max[:1]])], dim=1)
    n = 1 << 18
    gen = np.random.default_rng(seed)
    pick = torch.as_tensor(gen.integers(0, pool.shape[0], n), device=dev)
    start = pool[pick].contiguous()
    o, _, _ = _random_rays(torch, bvh, n, dev, seed + 1)
    box = boxes[pick]
    aim = box[:, :3] + torch.as_tensor(gen.random((n, 3), np.float32), device=dev) * \
        (box[:, 3:] - box[:, :3]) - o
    d = (aim / aim.norm(dim=1, keepdim=True)).contiguous()
    seeded = torch.as_tensor(np.where(gen.random(n) < 0.5, gen.uniform(0.05, 30.0, n), T_FAR)
                             .astype(np.float32), device=dev)
    w = bvh.num_wide
    print(f"phase 2b: {label} start links: F={fr.roots.shape[0]} frontier roots at M=128 "
          f"({int((fr.roots >= w).sum())} single leaves) built in {frontier_s:.3f} s; "
          f"{n} rays started at {int((start == 0).sum())} root / "
          f"{int(((start > 0) & (start < w)).sum())} wide-node / {int((start >= w).sum())} "
          f"leaf links", flush=True)
    kinds = {"binary": pt.pack_tables(bvh, *corners),
             "f32": pt.pack_tables_wide(bvh, *corners, box_enc="f32"),
             "bf16": pt.pack_tables_wide(bvh, *corners, box_enc="bf16"),
             "paged": pt.pack_tables_paged(bvh, *corners),
             "paged_s1": pt.pack_tables_paged(bvh, *corners, resident_cap=1)}
    out = {}
    for kind, tab in kinds.items():
        st = compact.binary_starts(bvh, start) if kind == "binary" else start
        kfn = pt.raycast_cuda if kind == "binary" else pt.raycast4_cuda
        pfn = pt.raycast_plain if kind == "binary" else pt.raycast4_plain
        for case, tm in (("closest", None), ("t_max seeds", seeded)):
            k = kfn(tab, o, d, tm, start=st)
            p = pfn(tab, o, d, tm, start=st)
            torch.cuda.synchronize()
            err = _compare(f"{kind} start links {case} vs plain", k, p, tm)
            words = int((k[0] != p[0]).sum()) + int((k[1] != p[1]).sum())
            kernel_ms = _ms(torch, lambda: kfn(tab, o, d, tm, start=st), 20)
            plain_ms = _ms(torch, lambda: pfn(tab, o, d, tm, start=st), 1, warm_up=False)
            print(f"  {kind} start links {case}: kernel {kernel_ms:.3f} ms "
                  f"({n / kernel_ms / 1e3:.1f} Mrays/s), plain {plain_ms:.3f} ms", flush=True)
            if words:
                raise AssertionError(f"start-link kernel differs from its plain walk ({kind})")
            if tm is not None:
                out[kind] = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}
    return out


def _capture(torch, ttt, pt, scene, cam, opts, kinds):
    """Renders once with ``pt.traverse_packed`` wrapped and returns, for
    each kind in ``kinds`` ("closest" or "shadow", the any-hit NEE rays),
    the middle one of the batches of that kind the render handed it, as
    (tables, o, d, t_max, any_hit, algo): full wavefronts, sorted by the
    render's keys, dead lanes masked to the miss ray."""
    seen = {k: [] for k in kinds}
    real = pt.traverse_packed

    def spy(tables, o, d, t_max=None, any_hit=False, algo="mt", count_steps=False, start=None):
        kind = "shadow" if any_hit else "closest"
        if kind in seen:
            seen[kind].append((tables, o.clone(), d.clone(),
                               None if t_max is None else t_max.clone(), any_hit, algo))
        return real(tables, o, d, t_max, any_hit, algo, count_steps, start)

    with mock.patch.object(pt, "traverse_packed", spy):
        ttt.render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    return {k: v[len(v) // 2] for k, v in seen.items()}


def _main_path_phase(torch, pt, batches, binary, footprint):
    """Phase 2c: each traversal kernel of the tree on the batches the
    renders send it. Per batch and kernel: words against the plain walk
    (0 expected; the BVH4 kernel counted, so its per-ray pops and leaf
    tests are held too), the kernel's time (CUDA events, mean of 50 after
    a warm-up, queued behind a sleep kernel so that the device runs them
    back to back), the bound of these rays, the ratio, the counters, and the
    instance's registers, stack frame, shared memory and blocks per SM.
    ``binary`` maps batch labels to the binary tables of the same tree.
    Returns {kernel: {batch: row}}."""
    from terra_tpu_torch.intersect import MISS_ORIGIN, T_FAR

    rows = {"bvh4_traverse": {}, "bvh_traverse": {}}
    for label, (tab, o, d, tm, any_hit, algo) in batches.items():
        walks = [("bvh4_traverse", tab, 4, pt.raycast4_cuda, pt.raycast4_plain, tab.num_wide,
                  pt.WIDE_BF16_NODE_BYTES if tab.box_enc == "bf16" else pt.WIDE_F32_NODE_BYTES)]
        if label in binary:
            b = binary[label]
            walks.append(("bvh_traverse", b, 2, pt.raycast_cuda, pt.raycast_plain, b.ni,
                          BIN_NODE_BYTES))
        live = int((o[:, 1] < MISS_ORIGIN / 2).sum())  # dead lanes start at MISS_ORIGIN
        for name, t, arity, kfn, pfn, n_inner, node_bytes in walks:
            count = dict(count=True) if arity == 4 else {}
            k = kfn(t, o, d, tm, any_hit, algo, **count)
            print(f"phase 2c: {name} on the {label} batch ({o.shape[0]} lanes, {live} live, "
                  f"table kind {getattr(t, 'mode', 'binary')}, any_hit {any_hit}, t_max "
                  f"{tm is not None}):", flush=True)
            (bound, by), p = _walk_bound(
                torch, pt, t, lambda v: pfn(t, o, d, tm, any_hit, algo, count=True, visits=v),
                n_inner, o.shape[0], node_bytes, arity)
            words = sum(int((a != b).sum()) for a, b in zip(k, p if arity == 4 else p[:2]))
            ms = _ms(torch, lambda: kfn(t, o, d, tm, any_hit, algo), 50, backlog=True)
            blocks, dyn = pt.occupancy(t, tm is not None, any_hit, algo)
            inst = ("bvh4_traverse_kernel<{},{},{},{},{},0>".format(
                int(algo != "mt"), int(tm is not None), int(any_hit), int(t.box_enc == "bf16"),
                int(t.s_resident > 0)) if arity == 4 else "bvh_traverse_kernel<{},{},{}>".format(
                int(algo != "mt"), int(tm is not None), int(any_hit)))
            regs, frame, st, ld, smem = footprint[name].get(inst, (-1, -1, -1, -1, 0))
            hits = int((k[0] < (T_FAR if tm is None else tm)).sum())
            print(f"  {name} {label}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), ratio "
                  f"{ms / bound:.2f}; hits {hits}; words differing from the plain walk"
                  f"{' (t, id, pops, leaf tests, paged)' if arity == 4 else ''} {words}; "
                  f"{inst}: {regs} registers, stack frame {frame} B, spills {st}/{ld} B, "
                  f"shared memory {smem + dyn} B per block ({dyn} B dynamic), {blocks} blocks "
                  f"per SM", flush=True)
            if words:
                raise AssertionError(f"{name} differs from its plain walk on the {label} batch")
            c = p[2].sum(dim=0)
            rows[name][label] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                                 "pops": int(c[0]), "leaf_tests": int(c[1]),
                                 "stack_frame_bytes": frame, "smem_per_block": smem + dyn,
                                 "blocks_per_sm": blocks}
    return rows


def _render(torch, ttt, pt, scene, cam, opts, label, check_unsorted=True):
    """One render of the main path after a small warm-up, with the launch
    counts of both kernels; then (``check_unsorted``) the same render with
    the ray sort off, which must give the same film bit for bit. Returns
    (seconds, launches, launches4, film) of the sorted render."""
    ttt.render(scene, cam, opts.replace(width=32, height=32), seed=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pt.launches = pt.launches4 = 0
    t0 = time.perf_counter()
    film = ttt.render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, launches4 = pt.launches, pt.launches4
    img = ttt.develop(film)
    nominal = opts.width * opts.height * opts.samples_per_pixel * (opts.bounces + 1) * 2
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    out = os.path.join(tempfile.gettempdir(), f"terra_tpu_torch_{label}.npy")
    np.save(out, img.cpu().numpy())
    print(f"  {label} render {opts.width}x{opts.height}x{opts.samples_per_pixel}spp bounces "
          f"{opts.bounces} {opts.integrator.name} lanes of {opts.samples_per_lane}"
          f"{' env_on_miss env_nee' if opts.env_nee else ''}: table kind "
          f"{pt.wide_mode(scene.bvh) or 'binary'}, {seconds:.3f} s, nominal "
          f"{nominal / seconds / 1e6:.2f} Mrays/s ({nominal} rays = pixels*spp*(bounces+1)*2), "
          f"launches binary {launches} bvh4 {launches4}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image mean {mean:.5f}, "
          f"finite {finite}, written to {out}", flush=True)
    if launches + launches4 <= 0 or not finite or not mean > 0.0:
        raise AssertionError(f"{label} render failed its checks")
    if not check_unsorted:
        return seconds, launches, launches4, film
    with mock.patch.object(pt, "raycast", functools.partial(pt.raycast, sort_rays=False)):
        t0 = time.perf_counter()
        unsorted = ttt.render(scene, cam, opts, seed=0)
        torch.cuda.synchronize()
        unsorted_s = time.perf_counter() - t0
    same = torch.equal(film.acc, unsorted.acc) and torch.equal(film.samples, unsorted.samples)
    print(f"  {label} render with the ray sort off: {unsorted_s:.3f} s (sorted: {seconds:.3f} s); "
          f"films equal bit for bit {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: the sorted and unsorted renders differ")
    return seconds, launches, launches4, film


def _disney(torch, scene):
    """The Disney block with every principled parameter set, as
    tests/test_torch_materials.py sets it."""
    a = scene.materials.attrs.clone()
    a[4, :6] = torch.tensor([(0.8, 0.5, 0.3), (0.5, 0.3, 0.0), (0.4, 0.5, 0.0), (0.6, 0.7, 0.0),
                             (0.3, 0.45, 0.0), (0.5, 0.2, 0.0)], device=a.device)
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, attrs=a))


def _sky_floor(torch, ttt, device):
    """tests/test_envmap.py's open floor (a diffuse quad) under a lat-long
    sky texture with a bright patch, committed with a BVH."""
    from terra_tpu_torch.scene import MaterialTable, TextureAtlas
    from terra_tpu_torch.scenes import make_geometry

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    c = [(-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)]
    geom = make_geometry([(c[0], c[2], c[1]), (c[0], c[3], c[2])], [0, 0], device=device)
    attrs = np.zeros((1, 8, 3), np.float32)
    attrs[0, 0] = 0.7
    mats = MaterialTable(bsdf_type=t(np.zeros(1, np.int32)), attrs=t(attrs),
                         attr_tex=t(np.full((1, 8), -1, np.int32)),
                         emissive=t(np.zeros((1, 3), np.float32)),
                         emissive_tex=t(np.full(1, -1, np.int32)),
                         ior=t(np.full(1, 1.5, np.float32)))
    sky = np.full((32, 64, 3), 0.05, np.float32)
    sky[8:12, 20:28] = 50.0
    atlas = TextureAtlas(data=t(sky[None]), size=t(np.asarray([[32, 64]], np.int32)),
                         filter=t(np.zeros(1, np.int32)), address=t(np.zeros(1, np.int32)))
    return ttt.commit(geom, mats, textures=atlas, env_tex=0, accelerator=ttt.Accelerator.BVH)


def _material_twins(torch, ttt, pt):
    """Phase 4's material, environment and debug twins: each scene rendered
    on CPU tensors and on CUDA tensors, compared under the reference tests'
    budgets. Returns the launches of the CUDA halves."""
    I, B = ttt.Integrator, ttt.BSDFType
    base = dict(width=32, height=32, samples_per_pixel=4, subpixel_jitter=0.5)

    def box(**kw):
        return lambda dev: ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BVH, device=dev,
                                                  **kw)

    def box_cam(dev):
        return ttt.scenes.cornell_camera(device=dev)

    def floor_cam(dev):
        return ttt.Camera.make(position=(0, 0.5, 1.2), direction=(0, -0.4, -1), up=(0, 1, 0),
                               fov_deg=45.0, device=dev)

    cases = [("glass", box(block_bsdf=B.GLASS), box_cam, dict(bounces=4, integrator=I.DIRECT),
              DELTA),
             ("mirror", box(block_bsdf=B.MIRROR), box_cam,
              dict(bounces=3, integrator=I.DIRECT_MIS), DELTA),
             ("phong", box(wall_bsdf=B.PHONG), box_cam, dict(bounces=2, integrator=I.DIRECT),
              PHONG),
             ("disney", lambda dev: _disney(torch, box(block_bsdf=B.DISNEY)(dev)), box_cam,
              dict(bounces=3, integrator=I.DIRECT_MIS), GOLDEN),
             ("env NEE, textured sky", lambda dev: _sky_floor(torch, ttt, dev), floor_cam,
              dict(bounces=2, integrator=I.DIRECT_MIS, env_on_miss=True, env_nee=True), GOLDEN)]
    cases += [(f"debug {i.name}", box(), box_cam, dict(bounces=2, integrator=i), GOLDEN)
              for i in (I.DEBUG_MONO, I.DEBUG_DEPTH, I.DEBUG_NORMALS, I.DEBUG_MIS_WEIGHTS)]
    launches = collections.Counter()
    for label, make_scene, make_cam, kw, budget in cases:
        opts = ttt.RenderOptions(**base, **kw)
        imgs = []
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            pt.launches = pt.launches4 = 0
            f = ttt.render(make_scene(device), make_cam(device), opts, seed=3)
            imgs.append(f.mean().cpu().numpy())
            if device == "cuda":
                launches.update(binary=pt.launches, bvh4=pt.launches4)
            print(f"phase 4: {label} twin 32x32x4spp {opts.integrator.name} on {device}: "
                  f"{time.perf_counter() - t0:.2f} s, mean {imgs[-1].mean():.5f}, launches "
                  f"binary {pt.launches} bvh4 {pt.launches4}", flush=True)
        if not np.isfinite(imgs[1]).all() or not imgs[1].max() > 0.0:
            raise AssertionError(f"{label} twin rendered no finite light")
        _twin_match(imgs[1], imgs[0], *budget)
    return launches


def _with_cap(pt, cap: int):
    """Context in which the traversal wrappers launch the kernels built with
    a ``cap``-entry stack."""
    return mock.patch.multiple(pt, load_kernel=functools.partial(pt.load_kernel, cap),
                               load_kernel4=functools.partial(pt.load_kernel4, cap))


def _cap_ab(torch, pt, batches, binary, footprint64):
    """Phase 2c's A/B of the stack depth: each traversal kernel built with
    the reference's 160-entry stack (the port's) and with the earlier 64
    entries, on the render's batches, timed in turns (160, 64, 64, 160;
    CUDA events, mean of 50 behind a sleep kernel). The two builds must
    give the same words. Returns {kernel: {batch: (ms160, ms64)}}."""
    out = {"bvh4_traverse": {}, "bvh_traverse": {}}
    for label, (tab, o, d, tm, any_hit, algo) in batches.items():
        walks = [("bvh4_traverse", tab, pt.raycast4_cuda)]
        if label in binary:
            walks.append(("bvh_traverse", binary[label], pt.raycast_cuda))
        for name, t, kfn in walks:
            ref = kfn(t, o, d, tm, any_hit, algo)
            with _with_cap(pt, 64):
                got = kfn(t, o, d, tm, any_hit, algo)
                blocks64 = pt.occupancy(t, tm is not None, any_hit, algo)[0]
            words = sum(int((a != b).sum()) for a, b in zip(ref, got))
            times = {160: [], 64: []}
            for cap in (160, 64, 64, 160):
                with _with_cap(pt, cap):
                    times[cap].append(_ms(torch, lambda: kfn(t, o, d, tm, any_hit, algo), 50,
                                          backlog=True))
            ms160, ms64 = (float(np.mean(times[c])) for c in (160, 64))
            frame64 = max(fp[1] for fp in footprint64[name].values())
            print(f"phase 2c: stack A/B {name} {label}: cap 160 {ms160:.4f} ms, cap 64 "
                  f"{ms64:.4f} ms (turns {[round(x, 4) for x in times[160]]} / "
                  f"{[round(x, 4) for x in times[64]]}), 160/64 = {ms160 / ms64:.3f}; words "
                  f"differing {words}; cap 64: blocks per SM {blocks64}, largest stack frame "
                  f"{frame64} B", flush=True)
            if words:
                raise AssertionError(f"{name}: the 64- and 160-entry builds differ on {label}")
            out[name][label] = (ms160, ms64)
    return out


def deep_scene(ttt, dev):
    """1,700 unit right triangles in the planes x = 1.05^k, committed with
    native SAH at leaf 8: binary depth 22, BVH4 depth 21, so the BVH4 walk
    needs 3 * 21 + 2 = 65 stack entries (tests/test_torch_lbvh.py)."""
    from terra_tpu_torch.scenes import make_geometry

    xs = 1.05 ** np.arange(1700)
    tris = [[(x, 0.0, 0.0), (x, 1.0, 0.0), (x, 0.0, 1.0)] for x in xs]
    geom = make_geometry(tris, np.zeros(len(tris), np.int32), device=dev)
    return ttt.commit(geom, ttt.scenes.cornell_box(device=dev).materials,
                      accelerator=ttt.Accelerator.BVH)


def _deep_gate(torch, ttt, pt, dev, footprint, n=1 << 18):
    """Phase 2b's deep tree (ROADMAP fault C1): both kernels against their
    plain walks on 2^18 axis rays that start before the 450 nearest planes
    (the deepest leaves), closest-hit and t_max any-hit; 0 differing words."""
    scene = deep_scene(ttt, dev)
    bvh = scene.bvh
    need2, need4 = bvh.depth + 2, 3 * bvh.wide_depth + 2
    frames = {k: max(fp[1] for fp in v.values()) for k, v in footprint.items()
              if k != "pattern_probes"}
    print(f"phase 2b: deep tree {scene.geometry.num_triangles} tris, depth {bvh.depth} (stack "
          f"{need2}), wide depth {bvh.wide_depth} (stack {need4}), STACK_CAP {pt.STACK_CAP}; "
          f"largest ptxas stack frames {frames}", flush=True)
    if not 64 < need4 <= pt.STACK_CAP:
        raise AssertionError("the deep tree does not need between 65 and STACK_CAP entries")
    gen = np.random.default_rng(41)
    j = gen.integers(1, 450, n)
    o = np.concatenate([0.99 * 1.05 ** j[:, None],
                        gen.uniform(0.05, 0.45, (n, 2)) + (gen.random((n, 1)) < 0.1)], 1)
    d = np.zeros((n, 3))
    d[:, 0] = np.where(gen.random(n) < 0.8, 1.0, -1.0)
    o, d = (torch.as_tensor(x.astype(np.float32), device=dev) for x in (o, d))
    t_occ = torch.as_tensor(gen.uniform(0.0, 1e9, n).astype(np.float32), device=dev)
    corners = scene.geometry.corners()
    out = {"bvh_traverse": 0.0, "bvh4_traverse": 0.0}  # max |dt| against the plain walk
    for name, tab, kfn, pfn in (
            ("bvh_traverse", pt.pack_tables(bvh, *corners), pt.raycast_cuda, pt.raycast_plain),
            ("bvh4_traverse", pt.pack_tables_wide(bvh, *corners), pt.raycast4_cuda,
             pt.raycast4_plain)):
        for case, tm, any_hit in (("closest-hit", None, False), ("t_max any-hit", t_occ, True)):
            k = kfn(tab, o, d, tm, any_hit)
            p = pfn(tab, o, d, tm, any_hit)
            torch.cuda.synchronize()
            err = _compare(f"deep tree {name} {case} vs plain", k, p, tm, any_hit)
            words = int((k[0] != p[0]).sum()) + int((k[1] != p[1]).sum())
            if words:
                raise AssertionError(f"{name} differs from its plain walk on the deep tree")
            out[name] = max(out[name], err)
    return out


def _config4(torch, ttt, dev, accelerator=None, builder="sah"):
    """bench.py's config 4 (bench.py:493-533): the Cornell box without
    blocks, 32x32, 8 spp, 2 bounces, DIRECT, rr_start_bounce 8; the target
    rendered at the true albedo, the start with the wall albedo [0.3, 0.5,
    0.6]. Returns (start scene, camera, options, target, key)."""
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng

    gt = ttt.scenes.cornell_box(with_blocks=False, device=dev)
    if accelerator is not None:
        gt = ttt.commit(gt.geometry, gt.materials, accelerator=accelerator, bvh_builder=builder)
    cam = ttt.scenes.cornell_camera(device=dev)
    opts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=8)
    key = rng.key_from_seed(0)
    with torch.no_grad():
        target = optim.render_mean_image(gt, cam, opts, key, 0, 8)
    attrs = gt.materials.attrs.clone()
    attrs[0, 0] = torch.tensor([0.3, 0.5, 0.6], device=dev)
    return optim.inject_params(gt, {"attrs": attrs}), cam, opts, target, key


def _grad(torch, optim, scene, cam, opts, target, key, fields=("attrs",)):
    """(loss, gradient list) of the MSE loss at the scene's parameters."""
    params = optim._trainable(optim.extract_params(scene, fields, cam=cam))
    loss, grads = optim.value_and_grad(optim.make_loss_fn(cam, opts, target), params, scene,
                                       key, 0)
    torch.cuda.synchronize()
    return float(loss), grads


def _same_bits(a, b) -> bool:
    """Two f32 tensors hold the same bits."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _phase6ab(torch, ttt, pt, dev):
    """Phases 6a and 6b. Returns (launches of the main path {"binary",
    "bvh4"}, results)."""
    from terra_tpu_torch import optim

    launches = collections.Counter()
    adam = functools.partial(torch.optim.Adam, lr=3e-2)
    # 6a: config 4 on the brute-force scene, as the bench commits it
    scene, cam, opts, target, key = _config4(torch, ttt, dev)
    step = optim.make_train_step(cam, opts, target, adam)
    state = optim.TrainState(optim.extract_params(scene, ("attrs",)), None, 0)
    state, loss = step(state, scene, key)  # warm-up
    first = float(loss)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(20):
        state, loss = step(state, scene, key)
    stop.record()
    final = float(loss)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    ev_ms = start.elapsed_time(stop) / 20
    alb = state.params["attrs"][0, 0].detach().cpu().numpy()
    print(f"phase 6a: config 4 (brute force, 32x32x8spp, 2 bounces, DIRECT, Adam 3e-2 on attrs): "
          f"{ev_ms:.2f} ms/step (CUDA events), {host_ms:.2f} ms/step (host clock to a final "
          f"float(loss)); loss {first:.6f} after the warm-up step -> {final:.6f} after 20 more; "
          f"wall albedo {alb.round(4)}", flush=True)
    if not np.isfinite(final) or not final < first:
        raise AssertionError("config 4: the loss did not descend")
    out = {"6a": {"ms_per_step": ev_ms, "host_ms_per_step": host_ms, "loss_first": first,
                  "loss_final": final}}
    # the albedo gradient at the start, brute force
    _, (g_brute,) = _grad(torch, optim, scene, cam, opts, target, key)
    # 6b: the same on BVH scenes, so the kernel runs under autograd
    for builder in ("sah", "lbvh"):
        bscene, bcam, bopts, btarget, bkey = _config4(torch, ttt, dev, ttt.Accelerator.BVH,
                                                      builder)
        pt.launches = pt.launches4 = 0
        bstep = optim.make_train_step(bcam, bopts, btarget, adam)
        bstate, bloss = bstep(optim.TrainState(optim.extract_params(bscene, ("attrs",)), None, 0),
                              bscene, bkey)
        torch.cuda.synchronize()
        launches.update(binary=pt.launches, bvh4=pt.launches4)
        step_l2, step_l4 = pt.launches, pt.launches4
        _, (g1,) = _grad(torch, optim, bscene, bcam, bopts, btarget, bkey)
        _, (g2,) = _grad(torch, optim, bscene, bcam, bopts, btarget, bkey)
        same = _same_bits(g1, g2)
        ga, gb = g1[0, 0].double(), g_brute[0, 0].double()
        rel = float((ga - gb).abs().max() / gb.abs().max())

        def f(x):
            attrs = bscene.materials.attrs.clone()
            attrs[0, 0, :] = x
            with torch.no_grad():
                img = optim.render_mean_image(optim.inject_params(bscene, {"attrs": attrs}),
                                              bcam, bopts, bkey, 0, 8)
            return float(torch.mean((img - 0.5 * btarget) ** 2))

        x = torch.tensor(0.73, device=dev, requires_grad=True)
        attrs = bscene.materials.attrs.clone()
        attrs[0, 0, :] = x
        img = optim.render_mean_image(optim.inject_params(bscene, {"attrs": attrs}), bcam, bopts,
                                      bkey, 0, 8)
        (gx,) = torch.autograd.grad(torch.mean((img - 0.5 * btarget) ** 2), [x])
        g, fd = float(gx), (f(0.73 + 1e-2) - f(0.73 - 1e-2)) / 2e-2
        fd_rel = abs(g - fd) / max(abs(fd), 1e-3)
        print(f"phase 6b: config 4 on a BVH scene ({builder}, table kind "
              f"{pt.wide_mode(bscene.bvh) or 'binary'}): one step {float(bloss):.6f}, launches "
              f"binary {step_l2} bvh4 {step_l4}; albedo gradient {ga.cpu().numpy()} vs brute "
              f"force {gb.cpu().numpy()}: max rel {rel:.3e} (gate 1e-3); d loss / d albedo "
              f"{g:.6e} vs central difference {fd:.6e}: rel {fd_rel:.3e} (gate 0.05); two "
              f"gradient calls bit-equal {same}", flush=True)
        if step_l2 + step_l4 <= 0 or rel > 1e-3 or fd_rel > 0.05 or not same:
            raise AssertionError(f"phase 6b ({builder}) failed a gate")
        out[f"6b/{builder}"] = {"rel_vs_brute": rel, "fd_rel": fd_rel, "launches4": step_l4}
    return launches, out


def _phase6c(torch, ttt, pt, scene, cam, dev, side=384):
    """Phase 6c: recover() on the 242k courtyard at 3b's size (384x384, 8 spp,
    2 bounces, DIRECT, jitter 0.5; cut: samples_per_lane 1, rr_start_bounce
    8) for 4 Adam steps at lr 3e-2 on attrs, textures and positions,
    refitting every step. Each stage is timed between synchronisations by
    wrapping optim.value_and_grad (forward, then backward), the loss (the
    forward), torch.optim.Adam.step, lbvh.refit and pack_tables_auto (the
    repack inside the next forward). Then the gradient at the final state,
    twice with deterministic algorithms and twice without, in turns.

    Losses are compared on the same samples (key 7, offset 0): the loss of
    each step draws new ones. The MSE of this scene is dominated by the
    reference estimator's negative NEE radiance (ROADMAP queue C3), the
    position gradient ignores visibility (optim.py's known limitation) and
    Adam's first steps move every entry by +-lr whatever its gradient, so
    with positions and attributes the loss need not fall; the descent gate
    is a second recover() from the same start on the halved textures alone.
    Returns (launches of the main path, results)."""
    import contextlib
    import warnings

    from terra_tpu_torch import optim
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.ops import rng

    opts = _opts_6c(ttt).replace(width=side, height=side)
    fields = FIELDS_6C
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, opts, rng.key_from_seed(7), 0, 8)
    print(f"phase 6c: target {side}x{side}x8spp: mean {float(target.mean()):.4e}, min "
          f"{float(target.min()):.4e}, max {float(target.max()):.4e}, negative values "
          f"{float((target < 0).float().mean()):.4%}", flush=True)
    start = _start_6c(torch, optim, scene)
    key = rng.key_from_seed(7)
    loss_fn = optim.make_loss_fn(cam, opts, target)
    with torch.no_grad():
        loss_start = float(loss_fn(optim.extract_params(start, fields), start, key, 0))
    optim.recover(start, cam, opts.replace(width=32, height=32), torch.zeros((32, 32, 3), device=dev),
                  fields=fields, steps=1, learning_rate=3e-2, seed=7)  # warm-up, small
    rec = collections.defaultdict(list)

    def timed(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        rec[name].append((time.perf_counter() - t0) * 1e3)
        return r

    real_vg, real_refit, real_pack = optim.value_and_grad, lbvh.refit, pt.pack_tables_auto
    real_adam = torch.optim.Adam.step

    def vg(loss_fn, params, *args):
        l4 = pt.launches4
        loss, grads = timed("forward+backward", real_vg,
                            lambda *a: timed("forward", loss_fn, *a), params, *args)
        rec["bvh4 launches"].append(pt.launches4 - l4)
        finite = [bool(torch.isfinite(g).all()) for g in grads]
        rec["finite"].append(bool(torch.isfinite(loss)) and all(finite))
        if not all(finite):
            print(f"  non-finite gradient entries per field {sorted(params)}: "
                  f"{[int((~torch.isfinite(g)).sum()) for g in grads]}", flush=True)
        return loss, grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pt.launches = pt.launches4 = 0
    t0 = time.perf_counter()
    with mock.patch.object(optim, "value_and_grad", vg), \
            mock.patch.object(lbvh, "refit", lambda *a: timed("refit", real_refit, *a)), \
            mock.patch.object(pt, "pack_tables_auto", lambda *a: timed("pack", real_pack, *a)), \
            mock.patch.object(torch.optim.Adam, "step",
                              lambda self, closure=None: timed("adam", real_adam, self, closure)):
        recovered, losses = optim.recover(start, cam, opts, target, fields=fields, steps=4,
                                          learning_rate=3e-2, seed=7)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) / 4 * 1e3
    launches = {"binary": pt.launches, "bvh4": pt.launches4}
    peak = torch.cuda.max_memory_allocated()
    fwd = rec["forward"]
    bwd = [a - b for a, b in zip(rec["forward+backward"], fwd)]
    print(f"phase 6c: recover on the courtyard ({scene.geometry.num_triangles} tris, table "
          f"kind {pt.wide_mode(scene.bvh) or 'binary'}), {side}x{side}x8spp ({side * side * 8} "
          f"lanes), 2 bounces, DIRECT, fields {fields}, 4 Adam steps at 3e-2: {total:.1f} ms/step "
          f"(host clock); peak memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB held before); launches binary {launches['binary']} "
          f"bvh4 {launches['bvh4']}", flush=True)
    for i in range(4):
        print(f"  step {i}: loss {losses[i]:.6e}; forward {fwd[i]:.1f} ms (of which table pack "
              f"{rec['pack'][i]:.1f} ms), backward {bwd[i]:.1f} ms, Adam {rec['adam'][i]:.2f} "
              f"ms, refit {rec['refit'][i]:.1f} ms (refit + the next pack "
              f"{rec['refit'][i] + (rec['pack'][i + 1] if i + 1 < 4 else rec['pack'][i]):.1f} "
              f"ms), bvh4 launches {rec['bvh4 launches'][i]}, finite {rec['finite'][i]}",
              flush=True)
    # every leaf box holds its moved triangles
    bvh, geom = recovered.bvh, recovered.geometry
    corners = geom.positions[geom.tri_vidx.long()[bvh.leaf_tri.long()]]  # (C, L, 3, 3)
    lo, hi = corners.amin(dim=(1, 2)), corners.amax(dim=(1, 2))
    ni = bvh.num_internal
    contained = bool((lo >= bvh.node_min[ni:]).all() and (hi <= bvh.node_max[ni:]).all())
    moved = float((geom.positions - scene.geometry.positions).abs().max())
    print(f"  positions moved by up to {moved:.4e}; every leaf box holds its triangles "
          f"{contained}", flush=True)
    # the gradient at the final state: deterministic algorithms on and off
    grads, ms = {True: [], False: []}, {True: [], False: []}
    for det in (True, False, False, True):
        ctx = contextlib.nullcontext() if det else mock.patch.object(
            optim, "deterministic", contextlib.nullcontext)
        with ctx, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            loss_end, g = _grad(torch, optim, recovered, cam, opts, target, key, fields)
            ms[det].append((time.perf_counter() - t0) * 1e3)
        grads[det].append(g)
        notes = sorted({str(w.message).split(".")[0][:120] for w in caught})
        if notes:
            print(f"  deterministic {det}: warnings {notes}", flush=True)
    same = {det: all(_same_bits(a, b) for a, b in zip(*grads[det])) for det in (True, False)}
    cross = all(_same_bits(a, b) for a, b in zip(grads[True][0], grads[False][0]))
    print(f"  gradient at the final state (forward + backward): deterministic algorithms "
          f"{np.mean(ms[True]):.1f} ms ({[round(x, 1) for x in ms[True]]}), without "
          f"{np.mean(ms[False]):.1f} ms ({[round(x, 1) for x in ms[False]]}); two calls "
          f"bit-equal: with {same[True]}, without {same[False]}; with == without {cross}",
          flush=True)
    # the descent gate: the textures alone, from the same start
    two = ("textures",)
    pt.launches = pt.launches4 = 0
    rec2, losses2 = optim.recover(start, cam, opts, target, fields=two, steps=4,
                                  learning_rate=3e-2, seed=7)
    torch.cuda.synchronize()
    launches2 = pt.launches4
    launches["binary"] += pt.launches
    launches["bvh4"] += pt.launches4
    with torch.no_grad():
        loss_two = float(loss_fn(optim.extract_params(rec2, two), rec2, key, 0))
    print(f"  loss on the same samples (key 7, offset 0): {loss_start:.6e} at the start; after 4 "
          f"steps {loss_end:.6e} with {fields}, {loss_two:.6e} with {two} (per-step losses "
          f"{[f'{x:.4e}' for x in losses2]}, launches bvh4 {launches2})", flush=True)
    if not (all(np.isfinite(losses)) and all(rec["finite"]) and np.isfinite(loss_end)
            and loss_two < loss_start and contained and moved > 0 and same[True]
            and launches["bvh4"] > 0):
        raise AssertionError("phase 6c failed a gate")
    return launches, {"ms_per_step": total, "forward_ms": fwd, "backward_ms": bwd,
                      "adam_ms": rec["adam"], "refit_ms": rec["refit"], "pack_ms": rec["pack"],
                      "losses": losses, "peak_gib": peak / 2**30,
                      "loss_start": loss_start, "loss_end": loss_end, "loss_two": loss_two,
                      "det_ms": ms[True], "nondet_ms": ms[False],
                      "nondet_bit_equal": same[False]}


def _phase6d(torch, ttt):
    """Phase 6d: test_grad_albedo_matches_fd's setup (12x12, 8 spp, 2
    bounces, DIRECT, no jitter, no roulette) on CPU tensors and on CUDA
    tensors: d loss / d wall albedo and the (attrs, emissive) gradient
    arrays, within 1e-3 relative. Returns the largest relative difference."""
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import rng

    res = {}
    for dev in ("cpu", "cuda"):
        scene = ttt.scenes.cornell_box(device=dev)
        cam = ttt.scenes.cornell_camera(device=dev)
        opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=8, bounces=2,
                                 integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.0,
                                 rr_start_bounce=10)
        with torch.no_grad():
            target = 0.5 * optim.render_mean_image(scene, cam, opts, rng.key_from_seed(1), 0, 8)
        x = torch.tensor(0.73, device=dev, requires_grad=True)
        attrs = scene.materials.attrs.clone()
        attrs[0, 0, :] = x
        img = optim.render_mean_image(optim.inject_params(scene, {"attrs": attrs}), cam, opts,
                                      rng.key_from_seed(0), 0, 8)
        (gx,) = torch.autograd.grad(torch.mean((img - target) ** 2), [x])
        params = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
        _, grads = optim.value_and_grad(optim.make_loss_fn(cam, opts, target), params, scene,
                                        rng.key_from_seed(0), 0)
        res[dev] = [gx.detach().cpu().double()] + [g.detach().cpu().double() for g in grads]
    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(res["cuda"], res["cpu"])]
    print(f"phase 6d: cpu vs cuda gradients (12x12x8spp Cornell, DIRECT): d loss / d albedo "
          f"{float(res['cpu'][0]):.6e} vs {float(res['cuda'][0]):.6e}; largest relative "
          f"difference: albedo scalar {rels[0]:.3e}, attrs array {rels[1]:.3e}, emissive array "
          f"{rels[2]:.3e} (gate 1e-3)", flush=True)
    if max(rels) > 1e-3:
        raise AssertionError("cpu and cuda gradients differ beyond 1e-3")
    return max(rels)


PROBE_ENTRIES = {  # body -> (module, function) of its terra_tpu_torch.scripts entry point
    "smem_dma/hbm_to_smem": ("smem_dma_probe", "probe_hbm_to_smem"),
    "smem_dma/hbm_to_smem_i32_loop": ("smem_dma_probe", "probe_hbm_to_smem_i32_loop"),
    "smem_dma/smem_dma_in_while": ("smem_dma_probe", "probe_smem_dma_in_while"),
    **{f"rowmask/probe{p}": ("rowmask_patterns_probe", f"probe{p}") for p in (1, 2, 3, 4)},
    **{f"paged/probe{p}": ("paged_patterns_probe", f"probe{p}") for p in (1, 2, 3, 4)},
}


def _probe_phase(torch):
    """Phase 5. Returns {kernel: {"launches", "max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by", "replaces", "bodies"}}; a kernel serving
    several bodies reports its slowest body's times."""
    import importlib

    from terra_tpu_torch import probes

    out = {}
    for name, (module, fn) in PROBE_ENTRIES.items():
        body = probes.BODIES[name]
        entry = getattr(importlib.import_module(f"terra_tpu_torch.scripts.{module}"), fn)
        probes.launches = 0
        got, ok = entry("cuda")  # the user's entry point; prints the reference's line
        torch.cuda.synchronize()
        n_launch = probes.launches
        x = probes.make_input(name, "cuda")
        plain = probes.run_plain(name, x)
        words = int((got.view(torch.int32) != plain.view(torch.int32)).sum())
        err = float((got.double() - plain.double()).abs().max())
        kernel_ms = _ms(torch, lambda: probes.run(name, x), 200)
        plain_ms = _ms(torch, lambda: probes.run_plain(name, x), 200)
        bound_ms, bound_by = _bound(body.staged_rows * probes.W * 4 + got.numel() * 4, body.ops)
        print(f"phase 5: {name} ({body.kernel}): OK {ok}, launches {n_launch}, words differing "
              f"from the plain version {words}; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms * 1e6:.2f} ns ({bound_by})", flush=True)
        if not ok or words or n_launch != 1:
            raise AssertionError(f"probe {name} failed on the card")
        k = out.setdefault(body.kernel, {"launches": 0, "max_abs_err": 0.0, "ms": 0.0,
                                         "replaces": body.replaces, "bodies": {}})
        k["launches"] += n_launch
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["bodies"][name] = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
        if kernel_ms >= k["ms"]:
            k.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _export_obj(scene, directory, name):
    """Write a committed scene (DIFFUSE and GGX materials) as ``name.obj`` +
    ``name.mtl`` + one PNG per texture, so that ``load_obj`` gives back its
    arrays: z negated and faces wound (v0, v2, v1), undone by the loader's
    handedness flip; floats as %.9g, which round-trips float32; materials
    named so their sorted order is their id; texels stored as
    round(255 v^(1/2.2)), which ``srgb_decode`` inverts to within 8-bit
    steps. (tests/test_torch_io_config.py holds the same exporter.)"""
    from terra_tpu_torch.io.image import write_png
    from terra_tpu_torch.scene import BSDFType

    def arr(x):
        return x.detach().cpu().numpy()

    g, m, tex = scene.geometry, scene.materials, scene.textures
    pos, vidx = arr(g.positions), arr(g.tri_vidx).astype(np.int64)
    nrm, uvs, mid = arr(g.normals), arr(g.uvs), arr(g.mat_id)
    flip = np.asarray([1, 1, -1], np.float32)
    t = len(vidx)

    def rows(fmt, a):
        return "\n".join(map(fmt.__mod__, map(tuple, a.tolist())))

    corner = np.arange(3 * t, dtype=np.int64).reshape(t, 3) + 1
    face = np.stack([vidx + 1, corner, corner], axis=-1)[:, (0, 2, 1)].reshape(t, 9)
    starts = np.flatnonzero(np.diff(mid)) + 1
    faces = []
    for s, e in zip(np.concatenate([[0], starts]), np.concatenate([starts, [t]])):
        faces.append(f"usemtl m{int(mid[s]):03d}")
        faces.append(rows("f %d/%d/%d %d/%d/%d %d/%d/%d", face[s:e]))
    with open(os.path.join(directory, f"{name}.obj"), "w") as f:
        f.write("\n".join([f"mtllib {name}.mtl", rows("v %.9g %.9g %.9g", pos * flip),
                           rows("vn %.9g %.9g %.9g", nrm.reshape(-1, 3) * flip),
                           rows("vt %.9g %.9g", uvs.reshape(-1, 2)), *faces]) + "\n")

    bsdf, attrs, attr_tex, emis = (arr(x) for x in (m.bsdf_type, m.attrs, m.attr_tex, m.emissive))
    lines = []
    for i in range(len(bsdf)):
        lines += [f"newmtl m{i:03d}", "Kd %.9g %.9g %.9g" % tuple(attrs[i, 0].tolist()),
                  "Ke %.9g %.9g %.9g" % tuple(emis[i].tolist())]
        if bsdf[i] == int(BSDFType.GGX):
            lines += ["Pr %.9g" % attrs[i, 1, 0], "Pm %.9g" % attrs[i, 2, 0]]
        elif bsdf[i] != int(BSDFType.DIFFUSE):
            raise ValueError(f"material {i}: only DIFFUSE and GGX are exported")
        if attr_tex[i, 0] >= 0:
            lines.append(f"map_Kd tex{int(attr_tex[i, 0])}.png")
    with open(os.path.join(directory, f"{name}.mtl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    data, size = arr(tex.data), arr(tex.size)
    for k in range(len(data)):
        h, w = size[k]
        u8 = np.round(255.0 * np.power(np.clip(data[k, :h, :w], 0, 1), 1 / 2.2))
        write_png(os.path.join(directory, f"tex{k}.png"), u8.astype(np.uint8))
    return os.path.join(directory, f"{name}.obj")


def _timed(store: dict, key: str, fn, sync=None):
    """``fn`` wrapped to append its seconds (after ``sync()``) to
    ``store[key]``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync is not None:
            sync()
        store.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return wrapper


def _cli_env(home: str) -> dict:
    """Environment of a ``python -m terra_tpu_torch`` subprocess: this
    checkout on the path, a temporary HOME for the console history."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path else ""), HOME=home)


def _film_npz(path):
    with np.load(path) as z:
        return z["acc"], z["samples"]


def _phase7a(torch, ttt, scene, tmp):
    """Export the courtyard to OBJ + MTL + PNG and import it on the card,
    stage by stage; the arrays must come back bit-equal (texels within
    8-bit sRGB steps). Returns the OBJ path."""
    from terra_tpu_torch import native
    from terra_tpu_torch.io import obj as obj_mod

    t0 = time.perf_counter()
    path = _export_obj(scene, tmp, "courtyard")
    export_s = time.perf_counter() - t0
    stages = {}
    with mock.patch.object(obj_mod, "_scan_directives",
                           _timed(stages, "directive scan", obj_mod._scan_directives)), \
            mock.patch.object(native, "obj_parse",
                              _timed(stages, "native parse", native.obj_parse)), \
            mock.patch.object(obj_mod, "_build_atlas",
                              _timed(stages, "atlas (2 PNGs)", obj_mod._build_atlas)):
        t0 = time.perf_counter()
        geom, mats, atlas = obj_mod.load_obj(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imported = ttt.commit(geom, mats, textures=atlas, accelerator=ttt.Accelerator.BVH)
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    sizes = {e: os.path.getsize(path[:-3] + e) for e in ("obj", "mtl")}
    print(f"phase 7a: exported the courtyard ({scene.geometry.num_triangles} tris) as "
          f"{sizes['obj'] / 1e6:.1f} MB OBJ + MTL + 2 PNGs in {export_s:.2f} s; load_obj on cuda "
          f"{load_s:.2f} s (" + ", ".join(f"{k} {v[0]:.2f} s" for k, v in stages.items())
          + f", the rest (flip, normals, tables, copies) "
          f"{load_s - sum(v[0] for v in stages.values()):.2f} s); commit with the SAH build "
          f"{commit_s:.2f} s", flush=True)
    bad = [f for f in ("positions", "tri_vidx", "normals", "uvs", "mat_id")
           if not _same_bits(getattr(imported.geometry, f), getattr(scene.geometry, f))]
    bad += [f for f in ("bsdf_type", "attrs", "attr_tex", "emissive", "emissive_tex", "ior")
            if not _same_bits(getattr(imported.materials, f), getattr(scene.materials, f))]
    bad += [f for f in ("size", "filter", "address")
            if not _same_bits(getattr(imported.textures, f), getattr(scene.textures, f))]
    same_tree = all(torch.equal(getattr(imported.bvh, f), getattr(scene.bvh, f))
                    for f in ("node_min", "node_max", "node_left", "node_right", "leaf_tri",
                              "wide_child"))
    enc = torch.pow(scene.textures.data.clamp(0, 1), 1 / 2.2) * 255.0
    back = torch.pow(imported.textures.data, 1 / 2.2) * 255.0
    tex_err = float((back - enc).abs().max()) if back.shape == enc.shape else float("inf")
    print(f"  round trip: arrays differing in bits {bad or 'none'}; same SAH tree {same_tree}; "
          f"texels max |diff| {tex_err:.4f} of 0.5 (in 8-bit sRGB steps)", flush=True)
    if bad or not same_tree or not tex_err <= 0.5 + 1e-3:
        raise AssertionError("phase 7a: the imported courtyard differs from the courtyard")
    return path


def _phase7(torch, ttt, pt, scene, render_3b_s):
    """Phase 7: the command line at full width. Returns the launches of the
    in-process CLI runs {"binary", "bvh4"}."""
    from terra_tpu_torch import _build, cli, profile
    from terra_tpu_torch.io import image as image_mod

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="terra_tpu_torch_cli_")
    env = _cli_env(tmp)
    path = _phase7a(torch, ttt, scene, tmp)

    # 7b. the real entry point, in a subprocess: 3b's settings, 2 passes
    args = [path, "--width", "384", "--height", "384", "--spp", "8", "--bounces", "2",
            "--integrator", "direct", "--opt", "render_jitter=0.5",
            "--opt", "camera_position=20,4,3", "--opt", "camera_direction=0,0.08,1",
            "--opt", "camera_fov=60"]
    ck, out = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "out.png")

    def run(argv):
        before = set(os.listdir(_build.BUILD_DIR))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "terra_tpu_torch", *argv], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=600)
        sec = time.perf_counter() - t0
        built = sorted(set(os.listdir(_build.BUILD_DIR)) - before)
        if proc.returncode != 0:
            raise AssertionError(f"phase 7: `{' '.join(argv[:2])} ...` exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return proc, sec, built

    proc, sec, built = run(["render", *args, "--passes", "2", "--checkpoint", ck, "--stats",
                            "-o", out])
    acc16, spp16 = _film_npz(ck)
    shutil.copy(ck, os.path.join(tmp, "ck16.npz"))
    png = image_mod.read_png(out)
    passes = [ln for ln in proc.stderr.splitlines() if "pass " in ln and " done (" in ln]
    stats = [ln for ln in proc.stdout.splitlines() if ln.startswith(("render ", "stage/"))]
    print(f"phase 7b: python3 -m terra_tpu_torch render courtyard.obj (3b's settings, --passes 2 "
          f"--checkpoint --stats -o out.png): rc 0 in {sec:.2f} s; log: {passes}; PNG "
          f"{png.shape}; checkpoint {int(spp16.min())}..{int(spp16.max())} spp, finite "
          f"{bool(np.isfinite(acc16).all())}; kernels rebuilt by the subprocess: "
          f"{built or 'none'}", flush=True)
    for ln in stats:
        print(f"  {ln}", flush=True)
    if (len(passes) != 2 or "pass 2/2 done (16 spp total)" not in passes[-1]
            or png.shape != (384, 384, 3) or not (spp16 == 16).all()
            or not np.isfinite(acc16).all() or not any(s.startswith("stage/raycast") for s in stats)
            or not any(s.startswith("render ") for s in stats)):
        raise AssertionError("phase 7b: the render command failed a gate")
    proc, sec, built_r = run(["render", *args, "--passes", "1", "--checkpoint", ck, "--resume",
                              "-o", out])
    acc24, spp24 = _film_npz(ck)
    print(f"phase 7b: --resume --passes 1: rc 0 in {sec:.2f} s, film {int(spp24.min())}.."
          f"{int(spp24.max())} spp, finite {bool(np.isfinite(acc24).all())}; kernels rebuilt "
          f"{built_r or 'none'}", flush=True)
    if not (spp24 == 24).all() or not np.isfinite(acc24).all():
        raise AssertionError("phase 7b: the resumed render did not reach 24 spp")

    # 7c. the same command in process, timed by wrapping the CLI's callees
    times = {}
    per_pass, clock_sums = [], []

    def sync():
        torch.cuda.synchronize()

    real_render = cli.render

    def render_pass(*a, **k):
        # the profiler's render clock so far: its sum before each pass
        clock_sums.append(profile.profiler.stats("render").sum)
        l2, l4 = pt.launches, pt.launches4
        t0 = time.perf_counter()
        film = real_render(*a, **k)
        torch.cuda.synchronize()
        per_pass.append({"s": time.perf_counter() - t0, "binary": pt.launches - l2,
                         "bvh4": pt.launches4 - l4,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return film

    ck_in = os.path.join(tmp, "ck_inproc.npz")
    profile.profiler.clear()
    torch.cuda.reset_peak_memory_stats()
    patches = [mock.patch.object(cli, "render", render_pass),
               mock.patch.object(cli, "_build_scene",
                                 _timed(times, "build", cli._build_scene, sync)),
               mock.patch.object(cli, "save_render_state",
                                 _timed(times, "checkpoint", cli.save_render_state)),
               mock.patch.object(cli, "develop", _timed(times, "develop", cli.develop, sync)),
               mock.patch.object(image_mod, "save_image",
                                 _timed(times, "png", image_mod.save_image)),
               mock.patch.object(profile, "stage_breakdown",
                                 _timed(times, "stats", profile.stage_breakdown, sync))]
    cwd = os.getcwd()
    pt.launches = pt.launches4 = 0
    try:
        for p in patches:
            p.start()
        os.chdir(tmp)
        t0 = time.perf_counter()
        rc = cli.main(["render", *args, "--passes", "2", "--checkpoint", ck_in, "--stats",
                       "-o", os.path.join(tmp, "out_inproc.png")])
        total = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for p in patches:
            p.stop()
    launches = collections.Counter(binary=pt.launches, bvh4=pt.launches4)
    acc_in, spp_in = _film_npz(ck_in)
    same = acc_in.tobytes() == acc16.tobytes() and np.array_equal(spp_in, spp16)
    nominal = profile.ray_count(ttt.RenderOptions(width=384, height=384, samples_per_pixel=8,
                                                  bounces=2, integrator=ttt.Integrator.DIRECT))
    own = total - sum(sum(v) for v in times.values()) - sum(p["s"] for p in per_pass)
    print(f"phase 7c: cli.main in process, the same arguments: rc {rc}, {total:.2f} s; film "
          f"bit-equal to 7b's two-pass film {same}; launches binary {launches['binary']} bvh4 "
          f"{launches['bvh4']} (with --stats' stage breakdown); scene load + commit "
          f"{sum(times['build']):.2f} s", flush=True)
    clock = np.diff(clock_sums + [profile.profiler.stats("render").sum])
    for i, p in enumerate(per_pass):
        print(f"  pass {i + 1}: render {clock[i]:.3f} s (the profiler's render clock; "
              f"{p['s']:.3f} s inside it), nominal {nominal / clock[i] / 1e6:.2f} "
              f"Mrays/s ({nominal:.0f} rays), launches binary {p['binary']} bvh4 {p['bvh4']}, "
              f"checkpoint write {times['checkpoint'][i]:.3f} s, peak memory "
              f"{p['peak_gib']:.2f} GiB", flush=True)
    print(f"  develop {sum(times['develop']):.4f} s, PNG write {sum(times['png']):.3f} s, --stats "
          f"{sum(times['stats']):.2f} s, the rest of the CLI's own time {own:.3f} s; phase 3's "
          f"3b render in this call: {render_3b_s:.3f} s", flush=True)
    if rc != 0 or not same or launches["binary"] + launches["bvh4"] <= 0 or \
            any(p["binary"] + p["bvh4"] <= 0 for p in per_pass):
        raise AssertionError("phase 7c: the in-process CLI failed a gate")

    # 7d. CPU against CUDA through the CLI on a small courtyard, and the console
    small_dir = os.path.join(tmp, "small")
    os.makedirs(small_dir)
    small = _export_obj(ttt.scenes.courtyard(grid=40, columns=8, device="cpu"), small_dir, "small")
    with open(os.path.join(small_dir, "small.config"), "w") as f:  # the per-scene autoload
        f.write("camera_position = 20 4 3\ncamera_direction = 0 0.08 1\ncamera_fov = 60\n")
    imgs = {}
    for device in ("cpu", "cuda"):
        ck_d = os.path.join(tmp, f"ck_{device}.npz")
        l2, l4 = pt.launches, pt.launches4
        t0 = time.perf_counter()
        cwd = os.getcwd()
        try:
            os.chdir(tmp)
            rc = cli.main(["render", small, "--width", "32", "--height", "32", "--spp", "4",
                           "--bounces", "2", "--integrator", "direct", "--opt",
                           "render_jitter=0.5", "--checkpoint", ck_d, "--device", device])
        finally:
            os.chdir(cwd)
        if device == "cuda":
            launches.update(binary=pt.launches - l2, bvh4=pt.launches4 - l4)
        acc, spp = _film_npz(ck_d)
        imgs[device] = acc / np.maximum(spp, 1)[..., None]
        print(f"phase 7d: CLI on the small courtyard (grid 40, 8 columns) 32x32x4spp DIRECT "
              f"--device {device}: rc {rc}, {time.perf_counter() - t0:.2f} s, mean "
              f"{imgs[device].mean():.5f}, launches binary {pt.launches - l2} bvh4 "
              f"{pt.launches4 - l4}", flush=True)
        if rc != 0 or not np.isfinite(imgs[device]).all() or not imgs[device].mean() > 0.0:
            raise AssertionError(f"phase 7d: the CLI on {device} failed")
    _twin_match(imgs["cuda"], imgs["cpu"], *GOLDEN)
    shot = os.path.join(tmp, "console.png")
    script = f"opt set width 64\nstep\nsave {shot}\nmesh list\nexit\n"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "terra_tpu_torch", "console", small], cwd=tmp,
                          env=env, input=script, capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    objects = len(re.findall(r"object +\d+: \d+ tris", proc.stdout))
    shape = image_mod.read_png(shot).shape if os.path.exists(shot) else None
    print(f"phase 7d: console on cuda with a scripted stdin (opt set width 64, step, save, mesh "
          f"list, exit): rc {proc.returncode} in {sec:.2f} s, PNG {shape}, {objects} objects "
          f"listed", flush=True)
    if proc.returncode != 0 or shape != (256, 64, 3) or objects <= 0:
        raise AssertionError(f"phase 7d: the console script failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    shutil.rmtree(tmp)
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --- phase 8: row x sample sharding on torch.distributed -------------------

SHARD_MESHES = [(4, 1), (2, 2), (1, 4)]
FIELDS_6C = ("attrs", "textures", "positions")


def _opts_3b(ttt):
    return ttt.RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             samples_per_lane=8)


def _opts_6c(ttt):
    """Phase 6c's training render: 3b's size, one sample per lane, no roulette."""
    return ttt.RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             rr_start_bounce=8)


def _start_6c(torch, optim, scene):
    """Phase 6c's start: the wall albedo [0.3, 0.5, 0.6], the textures halved."""
    attrs = scene.materials.attrs.clone()
    attrs[0, 0] = torch.tensor([0.3, 0.5, 0.6], device=attrs.device)
    return optim.inject_params(scene, {"attrs": attrs, "textures": scene.textures.data * 0.5})


def _refit(lbvh, scene, params):
    """The scene with its tree refit to the step's positions, as recover() does."""
    geom = dataclasses.replace(scene.geometry, positions=params["positions"].detach())
    return dataclasses.replace(scene, bvh=lbvh.refit(scene.bvh, geom))


def _train_2(torch, optim, lbvh, step, start, key):
    """Two steps of ``step`` from phase 6c's start with a host refit after
    each; returns ([(loss, params, node_min, node_max, ms, peak GiB)] per step)."""
    state = optim.TrainState(optim.extract_params(start, FIELDS_6C), None, 0)
    scene, out = start, []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loss = step(state, scene, key)
        scene = _refit(lbvh, scene, state.params)
        torch.cuda.synchronize()
        out.append((float(loss), {k: v.detach().clone() for k, v in state.params.items()},
                    scene.bvh.node_min.clone(), scene.bvh.node_max.clone(),
                    (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2**30))
    return out


def _rank_job(argv) -> None:
    """One rank of phase 8 (started by ``python -m torch.distributed.run``):
    ``--rank-job shard`` renders config 3b through ``render_sharded`` at
    meshes (4, 1), (2, 2) and (1, 4) (3 times each) and takes phase 6c's
    sharded gradient and 2 Adam steps at (2, 2), grad_chunks 2; ``--rank-job
    nccl`` renders 3b at (1, 1). Each rank writes what it measured to
    ``--out``; rank 0 also the gathered films and gradients."""
    import argparse

    import torch
    import torch.distributed as dist

    import terra_tpu_torch as ttt
    from terra_tpu_torch import optim
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.accel import pallas_traverse as pt
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import band_rows_of, gather_rows, make_mesh, render_sharded

    p = argparse.ArgumentParser()
    p.add_argument("--rank-job", choices=("shard", "nccl"))
    p.add_argument("--out")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.initialize(backend=args.backend, device="cuda")
    rank = dist.get_rank()
    res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "world": dist.get_world_size()}
    if args.rank_job == "nccl":  # a collective through the backend itself
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        dist.barrier()
        res["all_reduce"] = float(x[0])
    scene = ttt.scenes.courtyard(device=dev)
    cam = ttt.scenes.courtyard_camera(device=dev)
    opts = _opts_3b(ttt)
    shapes = SHARD_MESHES if args.rank_job == "shard" else [(1, 1)]
    meshes = {shape: make_mesh(shape, device="cuda") for shape in shapes}
    render_sharded(scene, cam, opts.replace(width=32, height=32), meshes[shapes[0]], seed=1)
    for (r, s), mesh in meshes.items():
        seconds, launches = [], []
        for i in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            pt.launches = pt.launches4 = 0
            t0 = time.perf_counter()
            film = render_sharded(scene, cam, opts, mesh, seed=0)
            torch.cuda.synchronize()
            dist.barrier()
            seconds.append(time.perf_counter() - t0)
            launches.append([pt.launches, pt.launches4])
            if i == 0:
                rows = band_rows_of(mesh, opts.height)
                acc = gather_rows(film.acc, rows, opts.height, mesh)
                samples = gather_rows(film.samples, rows, opts.height, mesh)
        res[f"{r}x{s}"] = {"seconds": seconds, "launches": launches, "row": mesh.row,
                           "sample": mesh.sample}
        if rank == 0:
            np.save(os.path.join(args.out, f"film_{r}x{s}.npy"), acc.cpu().numpy())
            np.save(os.path.join(args.out, f"samples_{r}x{s}.npy"), samples.cpu().numpy())
    if args.rank_job == "shard":
        mesh = meshes[(2, 2)]
        o6 = _opts_6c(ttt)
        target = torch.load(os.path.join(args.out, "target_6c.pt"), map_location=dev)
        start = _start_6c(torch, optim, scene)
        key = rng.key_from_seed(7)
        params = optim._trainable(optim.extract_params(start, FIELDS_6C))
        pt.launches = pt.launches4 = 0
        for chunks in (1, 2):
            loss, grads = optim.make_grad_fn_sharded(cam, o6, target, mesh,
                                                     grad_chunks=chunks)(params, start, key, 0)
            if rank == 0:
                torch.save({"loss": float(loss), **{k: g.cpu() for k, g in grads.items()}},
                           os.path.join(args.out, f"grads_{chunks}.pt"))
        step = optim.make_train_step_sharded(cam, o6, target,
                                             functools.partial(torch.optim.Adam, lr=3e-2), mesh,
                                             grad_chunks=2)
        steps = _train_2(torch, optim, lbvh, step, start, key)
        res["train"] = {"losses": [x[0] for x in steps], "ms": [x[4] for x in steps],
                        "peak_gib": [x[5] for x in steps]}
        res["train_launches"] = [pt.launches, pt.launches4]
        torch.save([{**{k: v.cpu() for k, v in x[1].items()}, "node_min": x[2].cpu(),
                     "node_max": x[3].cpu()} for x in steps],
                   os.path.join(args.out, f"params_rank{rank}.pt"))
    with open(os.path.join(args.out, f"{args.rank_job}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _torchrun(nproc: int, argv, log: str) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks from the repository root, output to ``log``; returns the running
    launcher (stop it with :func:`_kill_tree`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes", "1",
             "--nproc-per-node", str(nproc), *argv], cwd=root, env=env, stdout=f,
            stderr=subprocess.STDOUT, start_new_session=True)


def _kill_tree(pid: int) -> None:
    """SIGKILL a process and every process under it, ranks first: the
    launcher starts each rank in a session of its own, so killing the
    launcher's process group would leave the ranks running."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    children[int(f.read().rsplit(")", 1)[1].split()[1])].append(int(entry))
            except (OSError, IndexError, ValueError):
                continue
    tree, todo = [], [pid]
    while todo:
        p = todo.pop()
        tree.append(p)
        todo.extend(children.get(p, []))
    for p in reversed(tree):
        try:
            os.kill(p, 9)
        except ProcessLookupError:
            pass


def _wait(proc, log: str, what: str, timeout: float) -> str:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_tree(proc.pid)
        proc.wait()
        rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"phase 8: {what} exited {rc}:\n{text[-4000:]}")
    return text


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _phase8ab(torch, ttt, pt, scene, cam, film_3b, render_3b_s, tmp):
    """Phases 8a and 8b: the sharded 3b render on 4 gloo ranks sharing the
    card and on one NCCL rank, against phase 3's film; phase 6c's sharded
    gradient and Adam steps at mesh (2, 2) against the unsharded ones on
    this process. Returns (launches of the ranks' main path, results)."""
    from terra_tpu_torch import optim
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.ops import rng

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "phase8")
    os.makedirs(out, exist_ok=True)
    # the unsharded references of 8b, on this process
    o6 = _opts_6c(ttt)
    key = rng.key_from_seed(7)
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, o6, key, 0, 8)
    torch.save(target, os.path.join(out, "target_6c.pt"))
    start = _start_6c(torch, optim, scene)
    params = optim._trainable(optim.extract_params(start, FIELDS_6C))
    loss0, g_ref = optim.value_and_grad(optim.make_loss_fn(cam, o6, target), params, start, key, 0)
    g_ref = dict(zip(sorted(params), g_ref))
    ref_steps = _train_2(torch, optim, lbvh, optim.make_train_step(
        cam, o6, target, functools.partial(torch.optim.Adam, lr=3e-2)), start, key)
    del params
    torch.cuda.empty_cache()

    shard_log, nccl_log = os.path.join(out, "shard.log"), os.path.join(out, "nccl.log")
    t0 = time.perf_counter()
    _wait(_torchrun(4, [os.path.abspath(__file__), "--rank-job", "shard", "--out", out,
                        "--backend", "gloo"], shard_log), shard_log, "the 4 gloo ranks", 900)
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _wait(_torchrun(1, [os.path.abspath(__file__), "--rank-job", "nccl", "--out", out],
                    nccl_log), nccl_log, "the NCCL rank", 600)
    nccl_s = time.perf_counter() - t0
    ranks = []
    for i in range(4):
        with open(os.path.join(out, f"shard_rank{i}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(out, "nccl_rank0.json")) as f:
        nccl = json.load(f)
    print(f"phase 8a: 4 ranks on one card ({ranks[0]['backend']}, {ranks[0]['device']}, CUDA "
          f"tensors) in {shard_s:.1f} s of launcher, 1 {nccl['backend']} rank in {nccl_s:.1f} s "
          f"(all_reduce of 1.0 over 1 rank: {nccl['all_reduce']}); the 4 ranks time-slice the "
          f"one card, so these times measure no scaling", flush=True)

    ref = film_3b.acc.cpu().numpy()
    launches = collections.Counter()
    results = {}
    ok = True
    for label, rows in [(f"{r}x{s}", ranks) for r, s in SHARD_MESHES] + [("1x1", [nccl])]:
        acc = np.load(os.path.join(out, f"film_{label}.npy"))
        n = np.load(os.path.join(out, f"samples_{label}.npy"))
        med = float(np.median(rows[0][label]["seconds"]))
        per_rank = [sum(x[1] for x in rk[label]["launches"]) for rk in rows]
        for rk in rows:
            launches.update(binary=sum(x[0] for x in rk[label]["launches"]),
                            bvh4=sum(x[1] for x in rk[label]["launches"]))
        bit = bool(np.array_equal(acc, ref))
        dmax = float(np.abs(acc - ref).max())
        bound = 1e-5 * float(np.abs(ref).max())
        print(f"phase 8a: mesh ({label.replace('x', ', ')}) "
              f"{'nccl' if label == '1x1' else 'gloo'}: render_sharded 384x384x8spp, host-clock "
              f"median of 3 {med:.3f} s (runs {[round(x, 3) for x in rows[0][label]['seconds']]}; "
              f"phase 3's single-process render {render_3b_s:.3f} s); BVH4 launches per "
              f"rank over the 3 renders {per_rank}; film samples {int(n.min())}..{int(n.max())}; "
              f"bit-equal to phase 3's film {bit}; max |d| {dmax:.3e} (bound {bound:.3e})",
              flush=True)
        if label in ("4x1", "1x1"):
            ok &= bit
        else:
            _twin_match(acc, ref)
            ok &= dmax <= bound
        ok &= bool((n == 8).all()) and min(per_rank) > 0
        results[label] = {"median_s": med, "seconds": rows[0][label]["seconds"],
                          "bvh4_launches_per_rank": per_rank, "bit_equal": bit, "max_abs": dmax}

    # 8b: gradients, the two steps, parameters across ranks
    g1, g2 = (torch.load(os.path.join(out, f"grads_{c}.pt")) for c in (1, 2))
    rel = {k: _max_rel(g2[k].numpy(), g_ref[k].cpu().numpy()) for k in g_ref}
    rel12 = {k: _max_rel(g2[k].numpy(), g1[k].numpy()) for k in g_ref}
    loss_rel = abs(g2["loss"] - float(loss0)) / abs(float(loss0))
    params = [torch.load(os.path.join(out, f"params_rank{i}.pt")) for i in range(4)]
    same = all(torch.equal(params[0][s][k], pr[s][k]) for pr in params[1:] for s in range(2)
               for k in params[0][s])
    losses = ranks[0]["train"]["losses"]
    ref_losses = [x[0] for x in ref_steps]
    step_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    # the unsharded loss at the sharded run's own parameters (and refit
    # tree) of each step, with make_train_step's samples: Adam's first
    # steps move an entry by about +-lr whatever its size, so a gradient
    # entry near 0 whose sign the sums' order flips sends the two
    # trajectories apart after step 0; this holds each step's loss itself
    loss_fn = optim.make_loss_fn(cam, o6, target)
    own = [float(loss0)]
    p_sh = {k: v.to(scene.device) for k, v in params[0][0].items()}
    at = optim.inject_params(start, {k: p_sh[k] for k in FIELDS_6C})
    at = dataclasses.replace(at, bvh=dataclasses.replace(at.bvh, node_min=p_sh["node_min"],
                                                         node_max=p_sh["node_max"]))
    with torch.no_grad():
        own.append(float(loss_fn({k: p_sh[k] for k in FIELDS_6C}, at, key, 8)))
    own_rel = [abs(a - b) / abs(b) for a, b in zip(losses, own)]
    flips = {k: int(((p_sh[k] - ref_steps[0][1][k]).abs() > 3e-2).sum()) for k in FIELDS_6C}
    for rk in ranks:
        launches.update(binary=rk["train_launches"][0], bvh4=rk["train_launches"][1])
    print(f"phase 8b: phase 6c's gradient at mesh (2, 2) (384x384x8spp, fields {FIELDS_6C}): loss "
          f"{g2['loss']:.6e} vs unsharded {float(loss0):.6e} (rel {loss_rel:.2e}); grad_chunks 2 "
          f"vs unsharded, max |d| / largest entry per field "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }; grad_chunks 2 vs 1 "
          f"{ {k: f'{v:.2e}' for k, v in rel12.items()} }", flush=True)
    for i in range(2):
        print(f"  Adam step {i} (grad_chunks 2, host refit): loss {losses[i]:.6e}, the unsharded "
              f"loss at the same parameters {own[i]:.6e} (rel {own_rel[i]:.2e}), make_train_step's "
              f"{ref_losses[i]:.6e} (rel {step_rel[i]:.2e}); ms/step per rank "
              f"{[round(rk['train']['ms'][i], 1) for rk in ranks]} (unsharded on this process "
              f"{ref_steps[i][4]:.1f}); peak memory per rank GiB "
              f"{[round(rk['train']['peak_gib'][i], 2) for rk in ranks]} (unsharded "
              f"{ref_steps[i][5]:.2f})", flush=True)
    print(f"  entries that step 0 moved apart from make_train_step's by more than lr (an Adam "
          f"sign flip of a gradient near 0) {flips} of "
          f"{ {k: int(v.numel()) for k, v in ref_steps[0][1].items()} }", flush=True)
    print(f"  parameters and refit boxes bit-identical across the 4 ranks after each step {same}; "
          f"BVH4 launches per rank (gradients + steps) "
          f"{[rk['train_launches'][1] for rk in ranks]}; phase 8a-b {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    ok &= loss_rel <= 1e-5 and max(rel.values()) <= 1e-5 and max(rel12.values()) <= 1e-5
    ok &= same and step_rel[0] <= 1e-5 and max(own_rel) <= 1e-5
    if not ok:
        raise AssertionError("phase 8a/8b failed a gate")
    results["8b"] = {"grad_rel": rel, "chunks_rel": rel12, "loss_rel": loss_rel,
                     "step_losses": losses, "ref_losses": ref_losses, "own_losses": own,
                     "flips": flips,
                     "ms": [rk["train"]["ms"] for rk in ranks],
                     "peak_gib": [rk["train"]["peak_gib"] for rk in ranks]}
    return launches, results


def _phase8c(torch, ttt, tmp):
    """Phase 8c: bench config 5 through ``python -m torch.distributed.run
    ... -m terra_tpu_torch.scripts.pod_render``: the 4096 x 4096 Cornell box
    by brute force, 4 bounces, DIRECT_MIS, chunks of 4 (cut: spp 1024 -> 8,
    or 4 if one timed band says the phase would pass ~300 s), row bands of
    at most 2^21 lanes. Run 1: one NCCL rank, a checkpoint every chunk,
    SIGKILL once the first checkpoint exists. Run 2: 4 gloo ranks sharing
    the card, 2 sample ways, resuming that file. Gate: every pixel at the
    full sample count, and three 64-row bands of the film against
    single-process ``render_rows`` on the same samples."""
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.render import MAX_WAVEFRONT_LANES, render_rows

    t_phase = time.perf_counter()
    out = os.path.join(tmp, "phase8c")
    os.makedirs(out, exist_ok=True)
    dev = torch.device("cuda")
    scene = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BRUTE, device=dev)
    cam = ttt.scenes.cornell_camera(device=dev)
    side, spp, chunk = 4096, 8, 4

    def options(spp):
        return ttt.RenderOptions(width=side, height=side, samples_per_pixel=spp, bounces=4,
                                 integrator=ttt.Integrator.DIRECT_MIS, subpixel_jitter=0.5)

    key = rng.key_from_seed(0)
    band = MAX_WAVEFRONT_LANES // (side * chunk)
    render_rows(scene, cam, options(spp), key, 0, chunk, 0, 8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_rows(scene, cam, options(spp), key, 0, chunk, 0, band)
    torch.cuda.synchronize()
    t_band = time.perf_counter() - t0
    estimate = t_band * (side // band) * (spp // chunk)
    cut = estimate > 200.0
    if cut:
        spp, chunk = 4, 2
        band = MAX_WAVEFRONT_LANES // (side * chunk)
    print(f"phase 8c: one {band}-row band of 4096x4096 at {chunk} spp, 4 bounces, DIRECT_MIS, "
          f"brute force: {t_band:.2f} s; the frame at 8 spp estimated {estimate:.0f} s, so spp "
          f"{spp} (cut from 1024{', and further from 8' if cut else ''}), chunk {chunk}, row band "
          f"{band} ({band * side * chunk} lanes a launch)", flush=True)
    ckpt, logs = os.path.join(out, "pod.npz"), [os.path.join(out, f"run{i}.log") for i in (1, 2)]
    argv = ["-m", "terra_tpu_torch.scripts.pod_render", "--width", str(side), "--height",
            str(side), "--spp", str(spp), "--chunk", str(chunk), "--bounces", "4",
            "--integrator", "direct-mis", "--row-band", str(band), "--checkpoint", ckpt,
            "--checkpoint-every", "1"]
    t0 = time.perf_counter()
    run1 = _torchrun(1, [*argv, "-o", os.path.join(out, "run1.png")], logs[0])
    while not os.path.exists(ckpt) and run1.poll() is None and time.perf_counter() - t0 < 600:
        time.sleep(0.05)
    _kill_tree(run1.pid)  # if it had ended already, the gate below refuses the run
    rc1 = run1.wait()
    run1_s = time.perf_counter() - t0
    with open(logs[0]) as f:
        log1 = f.read()
    if not os.path.exists(ckpt):
        raise AssertionError(f"phase 8c: run 1 wrote no checkpoint (rc {rc1}):\n{log1[-3000:]}")
    with np.load(ckpt) as z:
        n1 = z["samples"]
    killed_at = int(n1.max())
    print(f"phase 8c: run 1 (1 nccl rank) killed by SIGKILL {run1_s:.1f} s after its start, once "
          f"its first checkpoint existed: rc {rc1}, checkpoint at {killed_at} spp (uniform "
          f"{bool((n1 == killed_at).all())}), image written "
          f"{os.path.exists(os.path.join(out, 'run1.png'))}; its lines: "
          f"{[ln for ln in log1.splitlines() if ln.startswith(('mesh:', 'spp'))]}", flush=True)
    t0 = time.perf_counter()
    log2 = _wait(_torchrun(4, [*argv, "--backend", "gloo", "--sample-ways", "2", "-o",
                               os.path.join(out, "run2.png")], logs[1]), logs[1],
                 "run 2 of pod_render", 900)
    run2_s = time.perf_counter() - t0
    with np.load(ckpt) as z:
        acc, n = z["acc"], z["samples"]
    png = os.path.join(out, "run2.png")
    print(f"phase 8c: run 2 (4 gloo ranks, 2 sample ways) {run2_s:.1f} s: "
          f"{[ln for ln in log2.splitlines() if ln.startswith(('mesh:', 'resumed', 'spp', 'wrote'))]}; "
          f"film samples {int(n.min())}..{int(n.max())}, PNG {os.path.getsize(png) if os.path.exists(png) else 0} B",
          flush=True)
    ok = rc1 != 0 and 0 < killed_at < spp and bool((n1 == killed_at).all())
    ok &= bool((n == spp).all()) and os.path.exists(png) and f"resumed at {killed_at} spp" in log2
    opts = options(spp)
    bands = {}
    thirds = (("top", side // 8), ("middle", side // 2 - 32), ("bottom", side * 7 // 8 - 64))
    for label, r0 in thirds:
        ref = sum(render_rows(scene, cam, opts, key, c, chunk, r0, 64)
                  for c in range(0, spp, chunk)).cpu().numpy()
        got = acc[r0:r0 + 64]
        dmax, bound = float(np.abs(got - ref).max()), 1e-5 * float(np.abs(ref).max())
        print(f"  band {label} (rows {r0}..{r0 + 63}) against render_rows on the same samples: "
              f"max |d| {dmax:.3e} (bound {bound:.3e})", flush=True)
        _twin_match(got, ref)
        ok &= dmax <= bound and bound > 0.0
        bands[label] = dmax
    print(f"phase 8c: {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not ok:
        raise AssertionError("phase 8c failed a gate")
    return {"spp": spp, "chunk": chunk, "band": band, "t_band_s": t_band, "run1_s": run1_s,
            "run2_s": run2_s, "killed_at": killed_at, "bands_max_abs": bands}


def _phase8d(torch, pt, scene, cam, bounce):
    """Phase 8d: the stackless packet walk (``accel.traverse.raycast``,
    plain PyTorch with one host read per loop trip) on 2^16 camera rays and
    2^16 rays of the mid-render 3b closest-hit batch of phase 2c, against
    the BVH4 kernel on f32 tables: hit masks equal, t equal wherever the
    triangle ids agree, >= 99% of ids equal; then occlusion (any hit)
    against t_max seeds: hit masks equal. Times both."""
    from terra_tpu_torch.accel import traverse
    from terra_tpu_torch.intersect import T_FAR

    dev = torch.device("cuda")
    tables = pt.pack_tables_wide(scene.bvh, *scene.geometry.corners(), box_enc="f32")
    batches = {"camera": _camera_rays(torch, cam, 256, dev), "3b bounce": bounce}
    gen = torch.Generator(device="cpu").manual_seed(8)
    rows, ok = {}, True
    for label, (o, d) in batches.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = traverse.raycast(scene, o, d)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        kt, ki = pt.raycast4_cuda(tables, o, d)
        kernel_ms = _ms(torch, lambda: pt.raycast4_cuda(tables, o, d), 20)
        hk = kt < T_FAR
        bad = int((h.hit != hk).sum())
        same = h.tri[hk] == ki[hk]
        frac = float(same.float().mean()) if bool(hk.any()) else 1.0
        t_ok = bool(torch.equal(h.t[hk][same], kt[hk][same]))
        tm = (torch.rand(o.shape[0], generator=gen) * 60.0).to(dev)
        ha = traverse.raycast(scene, o, d, t_max=tm, any_hit=True)
        at, _ = pt.raycast4_cuda(tables, o, d, tm, True)
        bad_any = int((ha.hit != (at < tm)).sum())
        print(f"phase 8d: packet walk on {o.shape[0]} {label} rays: {walk_s:.3f} s (host clock) vs "
              f"the BVH4 kernel {kernel_ms:.4f} ms; hits {int(hk.sum())}, hit-mask mismatches {bad}, "
              f"same triangle {frac:.6f}, t equal where the ids agree {t_ok}; any hit against "
              f"t_max: {int(ha.hit.sum())} occluded, mismatches {bad_any}", flush=True)
        ok &= bad == 0 and frac >= 0.99 and t_ok and bad_any == 0 and bool(hk.any())
        rows[label] = {"walk_s": walk_s, "kernel_ms": kernel_ms, "same_tri": frac}
    if not ok:
        raise AssertionError("phase 8d: the packet walk disagrees with the BVH4 kernel")
    return rows


TWIN_TABLES = {
    "binary": lambda pt: pt.pack_tables,
    "f32": lambda pt: lambda bvh, *c: pt.pack_tables_wide(bvh, *c, box_enc="f32"),
    "bf16": lambda pt: lambda bvh, *c: pt.pack_tables_wide(bvh, *c, box_enc="bf16"),
    "paged4": lambda pt: lambda bvh, *c: pt.pack_tables_paged(bvh, *c, resident_cap=4),
}


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
    from terra_tpu_torch import _build, intersect, native, probes, profile
    from terra_tpu_torch.accel import pallas_traverse as pt
    from terra_tpu_torch.accel import traverse
    from terra_tpu_torch.scripts import compact_bench

    # 1. builds, all started together
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # the traversal kernels also with a 64-entry stack, for phase 2c's A/B
    with ThreadPoolExecutor(6) as ex:
        futs = {name: ex.submit(timed, fn) for name, fn in
                (("bvh_traverse", pt.load_kernel), ("bvh4_traverse", pt.load_kernel4),
                 ("bvh_traverse cap 64", functools.partial(pt.load_kernel, 64)),
                 ("bvh4_traverse cap 64", functools.partial(pt.load_kernel4, 64)),
                 ("pattern_probes", probes.load_kernel), ("terra_native", native.load))}
        build_s = {name: f.result() for name, f in futs.items()}
    print("phase 1: built, in parallel, " + ", ".join(
        f"{name} ({'g++' if name == 'terra_native' else 'nvcc sm_90a'}) in {sec:.2f} s"
        for name, sec in build_s.items()), flush=True)
    footprint = {
        name: _print_footprints(name, _build.build_log(path), params)
        for name, path, params in (
            ("bvh_traverse", pt.kernel_path(), f"ALGO, HAS_TMAX, ANY_HIT; {pt.STACK_CAP}-entry "
             "stack"),
            ("bvh4_traverse", pt.kernel4_path(), "ALGO, HAS_TMAX, ANY_HIT, ENC, PAGED, COUNT; "
             f"{pt.STACK_CAP}-entry stack"),
            ("pattern_probes", probes.kernel_path(), "one per site"))}
    footprint64 = {
        name: _print_footprints(f"{name} (cap 64)", _build.build_log(path(64)), "64-entry stack")
        for name, path in (("bvh_traverse", pt.kernel_path), ("bvh4_traverse", pt.kernel4_path))}
    _sass_check(probes, probes.kernel_path())

    # 2. binary-kernel gate on the full courtyard
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
    o_cam, d_cam = _camera_rays(torch, cam, 1024, dev)
    o_inc, d_inc, t_occ = _random_rays(torch, bvh, 1 << 18, dev, 11)
    max_err = 0.0
    times = {}
    for name, o, d, tm, any_hit, algo in _cases(o_cam, d_cam, o_inc, d_inc, t_occ):
        k = pt.raycast_cuda(tables, o, d, tm, any_hit, algo)
        p = pt.raycast_plain(tables, o, d, tm, any_hit, algo)
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(name, k, p, tm))
        kernel_ms = _ms(torch, lambda: pt.raycast_cuda(tables, o, d, tm, any_hit, algo), 20)
        plain_ms = _ms(torch, lambda: pt.raycast_plain(tables, o, d, tm, any_hit, algo), 1)
        times[name] = (kernel_ms, plain_ms)
        print(f"  {name}: kernel {kernel_ms:.3f} ms ({o.shape[0] / kernel_ms / 1e3:.1f} Mrays/s), "
              f"plain {plain_ms:.3f} ms ({o.shape[0] / plain_ms / 1e3:.2f} Mrays/s)", flush=True)

    print("  camera 2^20 (binary):", flush=True)
    bin_bound, _ = _walk_bound(
        torch, pt, tables,
        lambda visits: pt.raycast_plain(tables, o_cam, d_cam, count=True, visits=visits),
        tables.ni, o_cam.shape[0], BIN_NODE_BYTES, 2)

    hk = pt.raycast(scene, o_cam[:N_CHECK], d_cam[:N_CHECK], tables=tables)
    hb = intersect.raycast_brute(o_cam[:N_CHECK], d_cam[:N_CHECK], *scene.geometry.corners())
    n_bad = int((hk.hit != hb.hit).sum())
    both = hk.hit & hb.hit
    t_close = bool(torch.allclose(hk.t[both], hb.t[both], rtol=1e-4, atol=1e-4))
    same = float((hk.tri[both] == hb.tri[both]).float().mean())
    print(f"  brute force {N_CHECK} camera rays: hit-mask mismatches {n_bad}, t close {t_close}, "
          f"same-tri {same:.4f}", flush=True)
    if n_bad or not t_close:
        raise AssertionError("kernel disagrees with brute force")

    # 2b. BVH4 gate on both courtyards
    t0 = time.perf_counter()
    mega = ttt.scenes.courtyard(grid=690, columns=40, device=dev)
    torch.cuda.synchronize()
    t_mega = time.perf_counter() - t0
    print(f"phase 2b: 1M courtyard built on the host and committed to cuda in {t_mega:.2f} s "
          f"({mega.geometry.num_triangles} tris, {mega.bvh.num_leaves} leaves, depth "
          f"{mega.bvh.depth})", flush=True)
    gate4, binary_camera = {}, {}
    max_err4 = 0.0
    for label, sc, seed in (("courtyard 242k", scene, 11), ("courtyard 1M", mega, 12)):
        gate4[label], err, binary_camera[label] = _bvh4_gate(torch, pt, sc, label, cam, dev, seed)
        max_err4 = max(max_err4, err)
    starts = {label: _start_gate(torch, pt, sc, label, dev, seed)
              for label, sc, seed in (("courtyard 242k", scene, 21), ("courtyard 1M", mega, 22))}
    for label, g in starts.items():
        max_err = max(max_err, g["binary"]["max_abs_err"])
        for kind, v in g.items():
            max_err4 = max(max_err4, v["max_abs_err"])
            if kind != "binary":
                gate4[label][f"start_links/{kind}"] = v
    deep = _deep_gate(torch, ttt, pt, dev, footprint)
    max_err, max_err4 = max(max_err, deep["bvh_traverse"]), max(max_err4, deep["bvh4_traverse"])

    # 2c. the traversal kernels on the batches the renders send them:
    # config 3b (below) and config 3g (the full-material render at bench
    # config 2's width, bench.py:202-219, spp cut from 256 to 16)
    opts = _opts_3b(ttt)
    g_scene = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BVH,
                                     wall_bsdf=ttt.BSDFType.PHONG,
                                     block_bsdf=ttt.BSDFType.GLASS, device=dev)
    g_cam = ttt.scenes.cornell_camera(device=dev)
    g_opts = ttt.RenderOptions(width=512, height=512, samples_per_pixel=16, bounces=4,
                               integrator=ttt.Integrator.DIRECT_MIS, subpixel_jitter=0.5,
                               samples_per_launch=16, samples_per_lane=16)
    t0 = time.perf_counter()
    cap = _capture(torch, ttt, pt, scene, cam, opts, ("closest", "shadow"))
    batches = {"3b closest-hit": cap["closest"], "3b shadow": cap["shadow"],
               "3g closest-hit": _capture(torch, ttt, pt, g_scene, g_cam, g_opts,
                                          ("closest",))["closest"]}
    print(f"phase 2c: captured the mid-render batches of one 3b and one 3g render in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    bin_3b = pt.pack_tables(bvh, *scene.geometry.corners())
    main_rows = _main_path_phase(torch, pt, batches,
                                 {"3b closest-hit": bin_3b, "3b shadow": bin_3b}, footprint)
    cap_ab = _cap_ab(torch, pt, batches, {"3b closest-hit": bin_3b, "3b shadow": bin_3b},
                     footprint64)
    # 2^16 live rays of the 3b closest-hit batch, for phase 8d
    _, o_b, d_b = cap["closest"][:3]
    live_b = torch.nonzero(o_b[:, 1] < intersect.MISS_ORIGIN / 2).squeeze(1)
    pick = live_b[torch.linspace(0, live_b.numel() - 1, min(1 << 16, live_b.numel()),
                                 device=dev).long()]
    bounce_8d = (o_b[pick].contiguous(), d_b[pick].contiguous())
    del cap, batches

    # 3. the production courtyard render (config 3b)
    main_launches = collections.Counter()
    print("phase 3: config 3b", flush=True)
    render_3b_s, l2, l4, film_3b = _render(torch, ttt, pt, scene, cam, opts, "courtyard")
    main_launches.update(binary=l2, bvh4=l4)

    # 3m. the 1M-triangle path (config 3m): dir3-sorted rays, as the bench
    print(f"phase 3m: config 3m, wide_mode {pt.wide_mode(mega.bvh)}", flush=True)
    packed = pt.pack_tables_wide(mega.bvh, *mega.geometry.corners(), box_enc="bf16")
    o_u, d_u = _camera_rays(torch, cam, 1024, dev)
    sort_ms = _ms(torch, lambda: traverse.sort_order(mega.bvh, o_u, d_u, "dir3"), 20)
    order = traverse.sort_order(mega.bvh, o_u, d_u, "dir3")
    o_m, d_m = o_u[order].contiguous(), d_u[order].contiguous()
    pt.launches = pt.launches4 = 0
    bt, bi = pt.traverse_packed(packed, o_m, d_m)
    torch.cuda.synchronize()
    main_launches.update(binary=pt.launches, bvh4=pt.launches4)
    tp_ms = _ms(torch, lambda: pt.traverse_packed(packed, o_m, d_m), 20)
    c = pt.count_decode(pt.traverse_packed(packed, o_m, d_m, count_steps=True)[2])
    hits = int((bt < intersect.T_FAR).sum())
    print(f"  dir3 sort of 2^20 camera rays (keys + stable argsort): {sort_ms:.3f} ms", flush=True)
    print(f"  traverse_packed bf16, 2^20 camera rays (dir3-sorted): {tp_ms:.3f} ms "
          f"({o_m.shape[0] / tp_ms / 1e3:.1f} Mrays/s), hits {hits}; counters: iters "
          f"{int(c['iters'].sum())} pops {int(c['pops'].sum())} leaf tests "
          f"{int(c['leaves'].sum())} paged {int(c['paged'].sum())}", flush=True)
    ut, ui = pt.traverse_packed(packed, o_u, d_u)
    tu_ms = _ms(torch, lambda: pt.traverse_packed(packed, o_u, d_u), 20)
    cu = pt.count_decode(pt.traverse_packed(packed, o_u, d_u, count_steps=True)[2])
    back_t, back_i = torch.empty_like(bt), torch.empty_like(bi)
    back_t[order], back_i[order] = bt, bi
    same = torch.equal(back_t, ut) and torch.equal(back_i, ui)
    print(f"  traverse_packed bf16, the same rays unsorted: {tu_ms:.3f} ms "
          f"({o_u.shape[0] / tu_ms / 1e3:.1f} Mrays/s); counters: iters "
          f"{int(cu['iters'].sum())} pops {int(cu['pops'].sum())}; sorted results scattered "
          f"back equal the unsorted ones word for word {same}", flush=True)
    if hits <= 0 or not bool(torch.isfinite(bt[bt < intersect.T_FAR]).all()):
        raise AssertionError("traverse_packed on the 1M scene found no finite hits")
    if not same:
        raise AssertionError("sorting the rays changed traverse_packed's results")
    _, l2, l4, _ = _render(torch, ttt, pt, mega, cam, opts, "courtyard_1m")
    main_launches.update(binary=l2, bvh4=l4)
    if pt.wide_mode(mega.bvh) is not None and l4 <= 0:
        raise AssertionError("the 1M render did not launch the BVH4 kernel")
    stages = profile.stage_breakdown(mega, cam, opts, probe_lanes=1 << 18)
    print("  stage breakdown (1M scene, 2^18 camera lanes, least of 3, CUDA events): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items()), flush=True)

    # 3g. the full-material render at bench config 2's width (bench.py:202-219,
    # spp cut from 256 to 16), then the courtyard under a constant sky
    print("phase 3g: config 3g (Cornell box, Phong walls, glass block)", flush=True)
    _, l2, l4, _ = _render(torch, ttt, pt, g_scene, g_cam, g_opts, "cornell_3g",
                        check_unsorted=False)
    main_launches.update(binary=l2, bvh4=l4)
    sky = dataclasses.replace(scene, env_value=torch.tensor([0.5, 0.6, 0.8], device=dev))
    s_opts = opts.replace(integrator=ttt.Integrator.DIRECT_MIS, env_on_miss=True, env_nee=True)
    _, l2, l4, _ = _render(torch, ttt, pt, sky, cam, s_opts, "courtyard_sky",
                           check_unsorted=False)
    main_launches.update(binary=l2, bvh4=l4)

    # 3c. the compacted two-phase traversal (compact_bench's workload)
    print("phase 3c: compact_bench --M 128 256 (1M courtyard, 2^20 dir3-sorted camera rays)",
          flush=True)
    pt.launches = pt.launches4 = 0
    bench = compact_bench.main(["--M", "128", "256"])
    main_launches.update(binary=pt.launches, bvh4=pt.launches4)
    for m, row in bench["M"].items():
        print(f"  M={m}: F={row['F']}, rounds {row['rounds']}, compact {row['compact_s']:.4f} s "
              f"vs classic {bench['classic_s']:.4f} s (host clock, least of 3), hit-mask "
              f"mismatches {row['hit_mismatch']}, same-tri {row['same_tri']:.6f}", flush=True)

    # 4. twins: cpu tensors (plain) vs cuda tensors (kernel), per table kind
    kw = dict(grid=40, columns=8)
    topts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=4, bounces=2,
                              integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    small = {device: ttt.scenes.courtyard(**kw, device=device) for device in ("cpu", "cuda")}
    for kind, packer in TWIN_TABLES.items():
        imgs = []
        with mock.patch.object(pt, "pack_tables_auto", packer(pt)):
            for device in ("cpu", "cuda"):
                t0 = time.perf_counter()
                pt.launches = pt.launches4 = 0
                f = ttt.render(small[device], ttt.scenes.courtyard_camera(device=device), topts,
                               seed=3)
                imgs.append(f.mean().cpu().numpy())
                if device == "cuda":
                    main_launches.update(binary=pt.launches, bvh4=pt.launches4)
                print(f"phase 4: {kind} tables, small courtyard "
                      f"({small[device].geometry.num_triangles} tris) 32x32x4spp DIRECT on "
                      f"{device}: {time.perf_counter() - t0:.2f} s, mean {imgs[-1].mean():.5f}, "
                      f"launches binary {pt.launches} bvh4 {pt.launches4}", flush=True)
        _twin_match(imgs[1], imgs[0])
    main_launches.update(_material_twins(torch, ttt, pt))

    # 5. the pattern probes through their entry points
    probe_rows = _probe_phase(torch)

    # 6. inverse rendering: config 4 (brute force, then BVH trees from both
    # builders), the courtyard at 3b's size, and a cpu-vs-cuda gradient twin
    launches6, inverse = _phase6ab(torch, ttt, pt, dev)
    main_launches.update(launches6)
    launches6c, inverse["6c"] = _phase6c(torch, ttt, pt, scene, cam, dev)
    main_launches.update(launches6c)
    inverse["6d_max_rel"] = _phase6d(torch, ttt)

    # 7. the command line at full width: the courtyard exported to OBJ and
    # rendered through `python -m terra_tpu_torch render` and `cli.main`
    main_launches.update(_phase7(torch, ttt, pt, scene, render_3b_s))

    # 8. row x sample sharding on torch.distributed (8a-8c), and the
    # stackless packet walk (8d)
    tmp8 = tempfile.mkdtemp(prefix="terra_tpu_torch_phase8_")
    try:
        launches8, shard = _phase8ab(torch, ttt, pt, scene, cam, film_3b, render_3b_s, tmp8)
        main_launches.update(launches8)
        shard["8c"] = _phase8c(torch, ttt, tmp8)
        shard["8d"] = _phase8d(torch, pt, scene, cam, bounce_8d)
    finally:
        shutil.rmtree(tmp8, ignore_errors=True)

    print(f"main-path launches: {dict(main_launches)}; probes "
          f"{ {k: v['launches'] for k, v in probe_rows.items()} }", flush=True)
    if main_launches["binary"] <= 0 or main_launches["bvh4"] <= 0 or \
            sorted(probe_rows) != sorted(probes.KERNELS) or \
            any(v["launches"] <= 0 for v in probe_rows.values()):
        raise AssertionError("a kernel of the main path was never launched")
    k_ms, p_ms = times["camera 2^20 closest-hit mt"]
    m4 = gate4["courtyard 1M"]["bf16"]
    walks = "no single PyTorch call walks a BVH"

    def main_path(name):
        """The phase-2c keys of one traversal kernel, per batch."""
        r = main_rows[name]
        return {"main_path_ms": {b: v["ms"] for b, v in r.items()},
                "stack_ab_ms_cap160_cap64": cap_ab[name],
                "main_path_bound_ms": {b: v["bound_ms"] for b, v in r.items()},
                "stack_frame_bytes": max(fp[1] for fp in footprint[name].values()),
                "smem_per_block": {b: v["smem_per_block"] for b, v in r.items()},
                "blocks_per_sm": {b: v["blocks_per_sm"] for b, v in r.items()}}

    kernels = [
        {"name": "bvh_traverse", "route": "cuda",
         "source": "terra_tpu_torch/csrc/bvh_traverse.cu",
         "replaces": "terra_tpu/accel/pallas_traverse.py:81",
         "launches": main_launches["binary"], "max_abs_err": max_err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bin_bound[0], "bound_by": bin_bound[1],
         "library_ms": None, "library": walks, **main_path("bvh_traverse"),
         "modes": {**{f"{label}/start_links": g["binary"] for label, g in starts.items()},
                   **{f"{label}/camera": v for label, v in binary_camera.items()}}},
        {"name": "bvh4_traverse", "route": "cuda",
         "source": "terra_tpu_torch/csrc/bvh4_traverse.cu",
         "replaces": "terra_tpu/accel/pallas_traverse.py:81",
         "launches": main_launches["bvh4"], "max_abs_err": max_err4,
         "ms": m4["ms"], "plain_ms": m4["plain_ms"], "bound_ms": m4["bound_ms"],
         "bound_by": m4["bound_by"],
         "library_ms": None, "library": walks, **main_path("bvh4_traverse"),
         "modes": {f"{label}/{mode}": v for label, g in gate4.items() for mode, v in g.items()}},
    ]
    for name, row in probe_rows.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "terra_tpu_torch/csrc/pattern_probes.cu",
                        "library_ms": None,
                        "library": "no single PyTorch call computes a probe body",
                        **row})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--rank-job" in sys.argv:
        _rank_job(sys.argv[1:])
    else:
        main()
