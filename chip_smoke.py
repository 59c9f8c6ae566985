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
  1b. the threefry kernel (``csrc/threefry.cu``, ``ops.rng``) at the
     three benchmark cells' bounce batches (147,456 lanes and 4 stream
     pairs, 262,144 and 6, 147,456 and 7) and their pixel jitter (one
     pair): every uniform against the plain int64 chain on the card word
     for word, with the bounce per lane and as an int and the key as a
     device pair and as ints (0 differing words); the kernel's device
     time (CUDA events, a launch's share of a captured graph of 100
     launches, as the launch units replay it), its bound (the bytes, and
     the SASS of each uniforms_kernel<NB> instance from ``cuobjdump -sass``
     priced pipe by pipe), and the plain chain's time as a captured CUDA
     graph replays it (the render's form);
  1c. the row-accumulate kernel (``csrc/row_accumulate.cu``,
     ``ops.row_accumulate``: the backward of the training path's row
     gathers) at ``courtyard.inverse``'s shapes: 1,179,648 lanes into the
     (241,764 x 26) triangle table with row 0's run at the cell's miss
     share, the same lanes into the (32,768 x 3) atlas, and the 725,292
     corners of the 241,764 triangles into the (725,292 x 3) positions; against its plain version
     (0 differing words) and against itself (equal bits over two calls);
     a call's device time in a captured graph of 100 (the sort, the zeroed
     table and the level launches), its bytes bound, the plain version's
     time and PyTorch's deterministic ``index_put_(accumulate=True)`` in a
     graph of 100 (``library_ms``);
  1d. the refit kernel (``csrc/bvh_refit.cu``, ``accel.lbvh.refit_`` on
     CUDA positions) on the 241,764-triangle courtyard's SAH and LBVH
     trees after a move of every vertex by up to +-0.001 (the training
     cell's start): against the plain twin ``_refit_host`` (equal values,
     a zero's sign aside) and against itself (equal bits over two calls),
     two launches a refit; a refit's device time in a captured graph of
     100, its bytes bound priced from the shapes, and the wall time of the
     host refit it replaced (the positions and the topology to the host,
     ``_refit_host``, the boxes back, between synchronisations);
  1e. the brute-force sweep kernel (``csrc/sweep.cu``,
     ``intersect.raycast_sweep`` on CUDA rays) at ``cornell.render``'s
     raycast: 262,144 jittered camera rays of the Cornell camera against
     its 32 triangles, without and with a ``t_max`` (uniform in (0, 1000)),
     both intersectors: against the plain grid ``raycast_brute`` on the
     card (t, tri and hit word for word), one launch a raycast; a launch's
     device time in a captured graph of 100, its bound (46 f32 operations
     a pair over 67 TFLOP/s, or the rays read and the hits written over
     3.35 TB/s) and the grid's time in a captured graph of 10;
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
     reference's parent-hit keys), after a warm-up render that captures its
     CUDA graphs, with the table kind ``pack_tables_auto`` chose and the
     launches of each kernel; then the same render with the sort switched
     off (captured anew), which must give the same image bit for bit;
  3m. the 1M-triangle path: ``traverse_packed`` on bf16 tables over 2^20
     camera rays sorted by dir3 keys, as the bench sorts them (sort time,
     sorted and unsorted traversal times, the sorted results scattered
     back equal to the unsorted ones word for word), with its counters;
     the render of the 1M scene at 3b's settings, sorted and unsorted, as
     in phase 3; the per-stage breakdown of ``profile.stage_breakdown``,
     its stages captured as CUDA graphs (as it runs) and eagerly, each the
     least of 3 replays or calls after one more, CUDA events; every
     captured stage's outputs equal to the eager stage's word for word;
  3g. the full-material render (config 3g): the Cornell box with Phong
     walls and a glass block at bench config 2's width (512x512, 4 bounces,
     DIRECT_MIS, persistent lanes), spp cut from 256 to 16; then the 242k
     courtyard at 3b's settings under DIRECT_MIS with env_on_miss and env
     NEE, lit by a constant sky (0.5, 0.6, 0.8);
  3c. the compacted two-phase traversal (``scripts/compact_bench.py``'s
     workload, through ``terra_tpu_torch.scripts.compact_bench``): the 1M
     courtyard, 2^20 dir3-sorted camera rays, frontiers of M = 128 and 256
     leaves, rows of 128 lanes, tail buckets (1, 8, 64); the stages
     within ``compact.GRAPH_SWEEP`` captured as units by the first call,
     the others op by op at their exact sizes, a later call capturing
     nothing; F, rounds, active rays and lanes run per tail round, BVH4
     launches per call of ``raycast_compact`` and of the eager call
     (equal), replays per call, warm-up and capture seconds, pool bytes,
     the hits equal to the eager call's (``raycast_compact_eager``) word
     for word, and both held to the classic walk (0 hit-mask mismatches, t
     within rtol 1e-4, >= 99% same triangle); the compact seconds against
     the classic walk (least of 3), eager and ``raycast_compact`` in turns
     (E G G E E G, medians of 3), phase 1 alone; each stage of one call
     timed op by op at its exact size and as a unit replayed at its bucket
     and at the least power of two that holds it; then
     tests/test_torch_compact.py's ray-0 case (600 rays of a 3000-triangle
     scene, frontiers of 4 leaves, the ray with the most pairs before its
     hit as ray 0) with tail buckets, every stage a replayed unit: ray 0's
     hit the classic walk's word for word, the last rounds padded (its
     launches are printed apart from the main path's); and M = 128 with
     tail buckets (1, 8, 64, 512, 4096), whose small tail rounds replay
     units, against the eager walk in turns, hits equal word for word;
  4. twins: a small courtyard rendered on CPU tensors (plain traversal)
     and on CUDA tensors (the kernels), once with each table kind (binary,
     f32, bf16, paged with 4 resident nodes), compared with the golden-test
     budgets; then CPU-vs-CUDA twins of the glass, mirror, Phong and Disney
     Cornell boxes, of env NEE on a textured sky, and of the four debug
     integrators, under the reference tests' budgets;
  5. the pattern probes: each of the eleven bodies through its
     ``terra_tpu_torch.scripts`` entry point on the card (it must print OK),
     held word for word against its plain PyTorch version on the same input,
     on 8 seeded inputs and, for the i32 loop, on its 10 trip-count edges
     (0 differing words); each kernel's device time (the i32 loop's also at
     128 trips)
     (CUDA events over 200 launches back to back behind a sleep backlog),
     its time at the host's launch rate (``host_ms``), the plain version's, and the launch
     floor (an empty kernel launched with the kernel's block size, timed
     the same way); the kernels ranked by launches x (device ms - bound);
  6. inverse rendering (``optim.py`` on torch autograd): 6a bench config 4
     (the blockless Cornell box by brute force, 32x32, 8 spp, 2 bounces,
     DIRECT, Adam 3e-2 on attrs from a wall albedo of [0.3, 0.5, 0.6]; one
     step that captures the training unit, then 20 timed, CUDA events and
     host clock; the loss must fall); 6b the same on BVH trees of both
     builders (SAH, LBVH), so the BVH4 kernel runs under autograd: the
     albedo gradient against 6a's within 1e-3, against a central difference
     within 5%, two calls equal bit for bit; 6c ``recover`` on the 242k
     courtyard at 3b's size (cut: one sample per lane, rr_start_bounce 8)
     for 4 Adam steps on attrs, textures and positions with a refit
     every step, on eager steps (``value_and_grad`` and ``Adam.step``, every
     op from the host: the A/B baseline of 10c): ms per step split into
     forward, backward, Adam and refit plus repack, BVH4 launches per step,
     peak memory, losses; gates: finite losses and gradients, every leaf
     box holds its moved triangles, two gradient calls equal bit for bit
     (deterministic algorithms on; also timed and compared off), and the
     loss on fixed samples falls under a textures-only recover (graphed);
     6d the 12x12 gradient of ``test_grad_albedo_matches_fd`` on CPU and
     CUDA tensors within 1e-3;
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
     refit at mesh (2, 2), grad_chunks 2, against ``value_and_grad``
     and ``make_train_step`` on this process (loss and every field within
     1e-5 of its largest entry, grad_chunks 1 against 2 too, parameters
     and refit boxes bit-identical on every rank), ms per step and peak
     memory per rank; the same ranks run phase 10d; 8c bench config 5
     through ``-m terra_tpu_torch.scripts.pod_render``: the 4096 x 4096 Cornell box by
     brute force, 4 bounces, DIRECT_MIS, chunks of 4, row bands of 2^21
     lanes, spp cut from 1024 to 8 (to 4 if one timed band says the phase
     would pass ~300 s); one NCCL rank killed by SIGKILL once its first
     checkpoint exists, then 4 gloo ranks with 2 sample ways resume it;
     every pixel at the full count and three 64-row bands against
     single-process ``render_rows`` on the same samples; 8d the stackless
     packet walk (``accel.traverse.raycast``, plain PyTorch) on 2^16
     camera rays and 2^16 rays of phase 2c's 3b closest-hit batch against
     the BVH4 kernel (hit masks, t where the ids agree, >= 99% same ids;
     any hit against t_max seeds), both timed;
  9. the launch units as CUDA graphs (``graphs.py``; every ``render`` on
     the card above already replays them): for cells 3b, 3m, 3g and the
     sky, 9a the graphed render against the eager one (``render_rows`` in
     the same order) word for word, a second seed at a later sample offset
     on the same graph, loop trips and BVH4 launches per render; on 3b
     ``render_band`` replayed at rows 0, H/2 and H - rows against
     ``render_rows``, a second courtyard and the same one changed in place
     (each its own image), and a host read planted in the loop body (the
     render must raise; nothing falls back); 9b eager and graphed renders
     in turns (E G G E E G), medians of 3, warm-up and capture seconds,
     replays, trips, peak memory and the graph pool's bytes, where a
     graphed render's time goes (CUDA events around each replay against the
     host clock; the profiler's kernel time by name), and 7c's CLI passes
     through the graphs;
  10. the training units as CUDA graphs (``graphs.TrainUnit``; every
     ``make_train_step``, sharded step and ``recover`` on the card above
     already replays them): 10a config 4's graphed step against
     ``value_and_grad`` at the same state and offset (loss and gradient bit
     for bit), 20 more steps against the eager step with the same Adam
     (parameters bit for bit, else within 1e-6 relative), ms per step
     graphed and eager in turns (E G G E E G, 20 steps a turn, medians of
     3), warm-up, capture and pool; 10b config 4 on SAH and LBVH trees:
     BVH4 launches of one replay equal to one eager step's, the graphed
     step's albedo gradient against brute force (1e-3) and a central
     difference (0.05), two replays from the same state bit for bit; 10c
     phase 6c's ``recover`` through the graphed step, one step more than
     6c: one capture, 6c's 4 losses bit for bit
     (else within 2e-3 relative), the tables the last replay packed and
     the BVH4 hits on its first ray batch equal to a fresh pack of a fresh
     refit, ms per step with the graphs' stages (CUDA events) and the
     refit, peak memory and pool, the fifth backward's kernels by name
     (the profiler), and an eager backward at the recovered state under
     the profiler with ``record_shapes``: its index accumulates and
     matrix products by input shape (which tables cost what; a replay
     records no op shapes), with ``scripts/backward_profile.py``'s
     helpers; 10f the small-table fetches by one-hot product
     (``ops/onehot.py``): with TF32 allowed (``allow_tf32``,
     ``set_float32_matmul_precision("high")``), ``fetch_rows`` and
     ``_oh_pick`` on the courtyard's material and light tables and a
     random 512 x 26 table at 6c's lanes equal the plain gather word for
     word (its -0.0 read as +0.0) and their gradients equal those taken
     with TF32 off, the flags restored after; two graphed courtyard
     steps from the same state give gradients equal bit for bit to each
     other and to ``value_and_grad``'s, with the
     ``CUBLAS_WORKSPACE_CONFIG`` in force printed; the graphed 3b, sky
     and 3g renders with the one-hot fetches against the same renders
     and config 4's graphed step with gathers, in turns (host clock,
     kernel time, pool bytes and peak allocation above the held base;
     films equal word for word); 10d (in phase 8's ranks) the sharded step at (2, 2),
     grad_chunks 2, on 4 gloo ranks and at (1, 1) on one NCCL rank against
     the same bodies run uncaptured: gradients and the parameters after 2
     Adam steps bit for bit, ms per step per rank; 10e a host read planted
     in the loss must make the capture raise, naming the stage;
  11. the port's ``bench.py``: ``python -m terra_tpu_torch.bench`` in a
     subprocess (configs 1, 2, 3, 3i, 3s, 3b, 3m and 4 as the root
     ``bench.py`` writes them), its lines and log printed with its
     seconds; it must exit 0 with the eight metric lines, each value
     finite and positive, no error line, and the OK lines of both kernel
     gates (the kernel against brute force before config 3, against the
     packet walk before 3m); each line's traversal launches (the gates'
     left out) go to the main path's count and to the kernel line
     (``bench_launches``).

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
counts its own launches and reports them), the graphed renders of phase
9, the graphed training steps of phase 10 and the bench of phase 11 (its
process counts its own launches and prints them on each line: a config's
warm-up, its timed calls or renders and 3m's counted launch, not its
gate). A replayed graph adds the launches its capture recorded
(``graphs.StagedUnit``, ``graphs.TrainUnit``). Each is run with the
launch counter (``profile.kernel_launches``, by kernel name) cleared and
read after; launches that compare a kernel with its plain version, time
it, gate it, or compare a sorted run with an unsorted one are not
counted. The bench of phase 11 counts the traversal kernels only.
The last three lines are a JSON object describing the kernels (with each
one's least time on the card, ``bound_ms``: the larger of the bytes its
run needs over 3.35 TB/s and its operations over the 67 TFLOP/s f32 peak,
for the threefry kernel its SASS priced on each pipe, ``SASS_RATES``; its row
also holds phase 1b's ``cells``; the traversal kernels add
``main_path_ms``, ``main_path_bound_ms``, ``stack_frame_bytes``,
``smem_per_block`` and ``blocks_per_sm`` from phase 2c), the
``nvidia-smi`` line, and then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
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
# The threefry kernel's bound from its SASS: each instruction of a
# uniforms_kernel<NB> instance is priced on its pipe at the thread
# instructions an H100 SM retires a clock there (the CUDA C++ Programming
# Guide's throughput table for compute capability 9.0): the integer ALU
# (IADD3, LOP3, SHF, ...) 64; IMAD, which issues on the FMA pipe's heavy
# half, 64; f32 FMUL/FADD/FFMA with IMAD 128; conversions on the XU 16;
# and every instruction takes an issue slot, 4 warps or 128 threads a
# clock. The pipes run side by side, so a lane's time is its largest
# share, at 132 SMs x the 1.98 GHz boost clock. A lane reads its pixel,
# sample and bounce (8 B each) and writes 8 B a cipher.
SM_CLOCKS_PER_S = 132 * 1.98e9
SASS_RATES = {"issue": 128, "alu": 64, "imad": 64, "fma": 128, "xu": 16}
SASS_PIPES = (
    ("imad", r"IMAD|IMUL"), ("fma", r"FFMA|FMUL|FADD|HFMA2|HMUL2|HADD2"),
    ("xu", r"I2F|F2I|F2F|MUFU|POPC|FLO|BREV"),
    ("alu", r"IADD3|LOP3|SHF|ISETP|SEL|LEA|PRMT|IMNMX|IABS|I2FP|F2FP|FSEL|FSETP|FMNMX|MOV|P2R|R2P"
            r"|PLOP3|VIADD|VIMNMX"))
# The benchmark cells' bounce batches: (cell, lanes, integrator, env NEE).
THREEFRY_CELLS = (("courtyard.render", 384 * 384, "DIRECT", False),
                  ("cornell.render", 512 * 512, "DIRECT_MIS", False),
                  ("courtyard.sky", 384 * 384, "DIRECT_MIS", True))
# The row accumulates of courtyard.inverse's step, at its shapes: (name,
# lanes, table rows, columns, ids). "misses": ROW0_SHARE of the lanes on
# row 0 (the lanes that missed gather triangle 0; the first bounce's share
# in phase 6c's step, measured on the H100: 0.32, then 0.23 and 0.10), the
# others uniform over the other rows; "uniform": uniform over the rows;
# "corners": each row once (the soup's three corner ids a triangle, in one
# gather).
ROW0_SHARE = 0.32
ACCUMULATE_CASES = (("triangles", 384 * 384 * 8, 241764, 26, "misses"),
                    ("atlas", 384 * 384 * 8, 2 * 128 * 128, 3, "uniform"),
                    ("positions", 3 * 241764, 725292, 3, "corners"))
# Twin budgets (tol, flip, energy) of tests/test_golden.py::_assert_twin_match
# as the reference tests set them.
GOLDEN = (2e-3, 8e-3, 5e-3)
DELTA = (2e-3, 1.5e-2, 6e-3)   # test_glass.py:181, test_delta_lighting.py:144
PHONG = (2e-3, 1.2e-2, 5e-3)   # test_golden.py test_golden_phong


def _ms(fn, reps: int, warm_up: bool = True, backlog: bool = False) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events
    (:func:`terra_tpu_torch.profile.device_ms`; ``backlog``: behind a sleep
    kernel, so a kernel shorter than its wrapper's host cost is timed back
    to back on the device)."""
    from terra_tpu_torch.profile import device_ms

    return device_ms(fn, reps, warm_up, backlog)


def _graph_ms(torch, fn, launches=1) -> float:
    """Milliseconds of one ``fn()`` as a captured CUDA graph of ``launches``
    calls replays it (CUDA events over 20 replays)."""
    fn()  # warm-up: the allocator's blocks for the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return _ms(g.replay, 20) / launches


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
    blocks = probes.sass(path)
    found = {}
    for name, (fn, _, _) in probes.KERNELS.items():
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


def _sass_mix(block: str) -> collections.Counter:
    """Thread instructions of one kernel's SASS text by pipe
    (``SASS_PIPES``; ``issue`` counts every instruction but NOP, ``mem``
    the loads and stores, ``other`` the rest: branches, exits, uniform
    datapath and special registers, which take an issue slot only).
    Counted statically: each instruction once, whatever path runs it."""
    mix = collections.Counter()
    for m in re.finditer(r"^/\*[0-9a-f]{4}\*/ (?:@!?U?P[T0-9] )?([A-Z][A-Z0-9_]*)", block, re.M):
        op = m.group(1)
        if op == "NOP":
            continue
        mix["issue"] += 1
        if re.fullmatch(r"(?:LD|ST|RED|ATOM)\w*", op):
            mix["mem"] += 1
            continue
        pipe = next((name for name, ops in SASS_PIPES if re.fullmatch(ops, op)), "other")
        mix[pipe] += 1
        if pipe == "imad":
            mix["fma"] += 1  # IMAD also takes a slot of the whole FMA pipe
    return mix


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
        ms = _ms(lambda: pt.raycast_cuda(binary, o, d, tm, any_hit, algo), 20)
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
            kernel_ms = _ms(lambda: pt.raycast4_cuda(tab, o, d, tm, any_hit, algo), 20)
            # the comparison run above was the plain walk's warm-up
            plain_ms = _ms(lambda: pt.raycast4_plain(tab, o, d, tm, any_hit, algo), 1,
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
            kernel_ms = _ms(lambda: pt.raycast4_cuda(tab, o, d, tm, any_hit, algo,
                                                            count=True), 20)
            plain_ms = _ms(lambda: pt.raycast4_plain(tab, o, d, tm, any_hit, algo,
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
            kernel_ms = _ms(lambda: kfn(tab, o, d, tm, start=st), 20)
            plain_ms = _ms(lambda: pfn(tab, o, d, tm, start=st), 1, warm_up=False)
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

    # eagerly: a spy inside a captured graph would clone nothing real
    with mock.patch.object(pt, "traverse_packed", spy), _eager():
        ttt.render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    return {k: v[len(v) // 2] for k, v in seen.items()}


def _eager():
    """Context in which ``render`` runs its launch units eagerly through
    ``render_rows`` (the eager body, by name) in the same order: the A/B
    baseline of the graphs."""
    import importlib

    render_mod = importlib.import_module("terra_tpu_torch.render")

    def unit_sum(scene, cam, opts, key, sample_offset, row0, spp_chunk, rows):
        return render_mod.render_rows(scene, cam, opts, key, sample_offset, spp_chunk, row0, rows)

    return mock.patch.object(render_mod, "_unit_sum", unit_sum)


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
            ms = _ms(lambda: kfn(t, o, d, tm, any_hit, algo), 50, backlog=True)
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
    """One render of the main path after a warm-up render of the same shape
    (which captures its launch units), with the launch counts of each
    kernel; then (``check_unsorted``) the same render with the ray sort off
    (captured anew), which must give the same film bit for bit. Returns
    (seconds, {kernel: launches}, film) of the sorted render."""
    from terra_tpu_torch import graphs
    from terra_tpu_torch.profile import kernel_launches

    ttt.render(scene, cam, opts, seed=1)  # warm-up and capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_launches.clear()
    t0 = time.perf_counter()
    film = ttt.render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_launches.copy()
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
          f"launches binary {counts['binary']} bvh4 {counts['bvh4']} threefry "
          f"{counts['threefry']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB beside the graph pool's "
          f"{graphs.units()[-1]['pool_bytes'] / 2**30:.2f} GiB, image mean {mean:.5f}, "
          f"finite {finite}, written to {out}", flush=True)
    if counts["binary"] + counts["bvh4"] <= 0 or counts["threefry"] <= 0 or not finite or \
            not mean > 0.0:
        raise AssertionError(f"{label} render failed its checks")
    if not check_unsorted:
        return seconds, counts, film
    # the captured graphs hold the sorting raycast: capture again without
    # it, and again with it after
    graphs.clear()
    with mock.patch.object(pt, "raycast", functools.partial(pt.raycast, sort_rays=False)):
        ttt.render(scene, cam, opts, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unsorted = ttt.render(scene, cam, opts, seed=0)
        torch.cuda.synchronize()
        unsorted_s = time.perf_counter() - t0
    graphs.clear()
    same = torch.equal(film.acc, unsorted.acc) and torch.equal(film.samples, unsorted.samples)
    print(f"  {label} render with the ray sort off: {unsorted_s:.3f} s (sorted: {seconds:.3f} s); "
          f"films equal bit for bit {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: the sorted and unsorted renders differ")
    return seconds, counts, film


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


def _material_twins(torch, ttt):
    """Phase 4's material, environment and debug twins: each scene rendered
    on CPU tensors and on CUDA tensors, compared under the reference tests'
    budgets. Returns the launches of the CUDA halves."""
    from terra_tpu_torch.profile import kernel_launches

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
            kernel_launches.clear()
            f = ttt.render(make_scene(device), make_cam(device), opts, seed=3)
            imgs.append(f.mean().cpu().numpy())
            if device == "cuda":
                launches.update(kernel_launches)
            print(f"phase 4: {label} twin 32x32x4spp {opts.integrator.name} on {device}: "
                  f"{time.perf_counter() - t0:.2f} s, mean {imgs[-1].mean():.5f}, launches "
                  f"binary {kernel_launches['binary']} bvh4 {kernel_launches['bvh4']}",
                  flush=True)
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
                    times[cap].append(_ms(lambda: kfn(t, o, d, tm, any_hit, algo), 50,
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
    from terra_tpu_torch.profile import kernel_launches

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
        kernel_launches.clear()
        bstep = optim.make_train_step(bcam, bopts, btarget, adam)
        bstate, bloss = bstep(optim.TrainState(optim.extract_params(bscene, ("attrs",)), None, 0),
                              bscene, bkey)
        torch.cuda.synchronize()
        launches.update(kernel_launches)
        step_l2, step_l4 = kernel_launches["binary"], kernel_launches["bvh4"]
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
    refitting every step, on eager steps (:func:`_eager_train`). Each stage
    is timed between synchronisations by wrapping optim.value_and_grad
    (forward, then backward), the loss (the forward), torch.optim.Adam.step,
    lbvh.refit_ and pack_tables_auto (the repack inside the next forward).
    Then the gradient at the final state, twice with deterministic
    algorithms and twice without, in turns.

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
    from terra_tpu_torch.profile import kernel_launches

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
    with _eager_train():
        optim.recover(start, cam, opts.replace(width=32, height=32),
                      torch.zeros((32, 32, 3), device=dev), fields=fields, steps=1,
                      learning_rate=3e-2, seed=7)  # warm-up, small
    rec = collections.defaultdict(list)

    def timed(name, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        rec[name].append((time.perf_counter() - t0) * 1e3)
        return r

    real_vg, real_refit, real_pack = optim.value_and_grad, lbvh.refit_, pt.pack_tables_auto
    real_adam = torch.optim.Adam.step

    def vg(loss_fn, params, *args):
        l4 = kernel_launches["bvh4"]
        loss, grads = timed("forward+backward", real_vg,
                            lambda *a: timed("forward", loss_fn, *a), params, *args)
        rec["bvh4 launches"].append(kernel_launches["bvh4"] - l4)
        finite = [bool(torch.isfinite(g).all()) for g in grads]
        rec["finite"].append(bool(torch.isfinite(loss)) and all(finite))
        if not all(finite):
            print(f"  non-finite gradient entries per field {sorted(params)}: "
                  f"{[int((~torch.isfinite(g)).sum()) for g in grads]}", flush=True)
        return loss, grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel_launches.clear()
    t0 = time.perf_counter()
    with _eager_train(), mock.patch.object(optim, "value_and_grad", vg), \
            mock.patch.object(lbvh, "refit_", lambda *a: timed("refit", real_refit, *a)), \
            mock.patch.object(pt, "pack_tables_auto", lambda *a: timed("pack", real_pack, *a)), \
            mock.patch.object(torch.optim.Adam, "step",
                              lambda self, closure=None: timed("adam", real_adam, self, closure)):
        recovered, losses = optim.recover(start, cam, opts, target, fields=fields, steps=4,
                                          learning_rate=3e-2, seed=7)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) / 4 * 1e3
    launches = kernel_launches.copy()
    peak = torch.cuda.max_memory_allocated()
    fwd = rec["forward"]
    bwd = [a - b for a, b in zip(rec["forward+backward"], fwd)]
    print(f"phase 6c: recover on the courtyard ({scene.geometry.num_triangles} tris, table "
          f"kind {pt.wide_mode(scene.bvh) or 'binary'}), {side}x{side}x8spp ({side * side * 8} "
          f"lanes), 2 bounces, DIRECT, fields {fields}, 4 Adam steps at 3e-2: {total:.1f} ms/step "
          f"(host clock); peak memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB held before); launches binary {launches['binary']} "
          f"bvh4 {launches['bvh4']} row_accumulate {launches['row_accumulate']} bvh_refit "
          f"{launches['bvh_refit']}", flush=True)
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
    kernel_launches.clear()
    rec2, losses2 = optim.recover(start, cam, opts, target, fields=two, steps=4,
                                  learning_rate=3e-2, seed=7)
    torch.cuda.synchronize()
    launches2 = kernel_launches["bvh4"]
    launches.update(kernel_launches)
    with torch.no_grad():
        loss_two = float(loss_fn(optim.extract_params(rec2, two), rec2, key, 0))
    print(f"  loss on the same samples (key 7, offset 0): {loss_start:.6e} at the start; after 4 "
          f"steps {loss_end:.6e} with {fields}, {loss_two:.6e} with {two} (per-step losses "
          f"{[f'{x:.4e}' for x in losses2]}, launches bvh4 {launches2})", flush=True)
    if not (all(np.isfinite(losses)) and all(rec["finite"]) and np.isfinite(loss_end)
            and loss_two < loss_start and contained and moved > 0 and same[True]
            and launches["bvh4"] > 0 and launches["row_accumulate"] > 0
            and launches["bvh_refit"] == 8):
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
    """Phase 5. Returns {kernel: {"launches", "max_abs_err", "ms", "host_ms",
    "floor_ms", "plain_ms", "bound_ms", "bound_by", "replaces", "bodies"}}:
    ``ms`` the device time (200 launches back to back behind a sleep
    backlog), ``host_ms`` the time of a ``probes.run`` call at the host's
    launch rate, ``floor_ms`` the empty kernel's device time at the
    kernel's block size; a kernel serving several bodies reports its
    slowest body's times. Every body is also held to the plain version on
    ``probes.SEEDS`` seeded inputs and on its ``probes.edge_inputs`` (the
    loop probe's trip counts), and the loop probe is also timed at 128
    trips (``ms_n128``)."""
    import importlib

    from terra_tpu_torch import probes
    from terra_tpu_torch.profile import kernel_launches

    x0 = probes.make_input("paged/probe1", "cuda")
    floors = {}  # threads -> the empty kernel's device ms
    for threads in sorted({t for _, _, t in probes.KERNELS.values()}, reverse=True):
        floors[threads] = _ms(lambda: probes.run_floor(x0, threads), 200, backlog=True)
        host = _ms(lambda: probes.run_floor(x0, threads), 200)
        print(f"phase 5: launch floor ({probes.FLOOR}: one block of {threads} threads, no work): "
              f"device {floors[threads]:.5f} ms, host rate {host:.5f} ms", flush=True)
    out = {}
    for name, (module, fn) in PROBE_ENTRIES.items():
        body = probes.BODIES[name]
        entry = getattr(importlib.import_module(f"terra_tpu_torch.scripts.{module}"), fn)
        kernel_launches.clear()
        got, ok = entry("cuda")  # the user's entry point; prints the reference's line
        torch.cuda.synchronize()
        n_launch = kernel_launches["probe"]
        x = probes.make_input(name, "cuda")
        plain = probes.run_plain(name, x)
        words = int((got.view(torch.int32) != plain.view(torch.int32)).sum())
        err = float((got.double() - plain.double()).abs().max())
        edges = probes.edge_inputs(name, "cuda")

        def differing(xs):
            nonlocal err
            got_s, plain_s = probes.launch(name, xs), probes.run_plain(name, xs)
            err = max(err, float((got_s.double() - plain_s.double()).abs().max()))
            return int((got_s.view(torch.int32) != plain_s.view(torch.int32)).sum())

        seeded = [differing(probes.seeded_input(name, s, "cuda")) for s in range(probes.SEEDS)]
        edge_words = [differing(xs) for xs in edges.values()]
        kernel_ms = _ms(lambda: probes.run(name, x), 200, backlog=True)
        times = {"ms": kernel_ms}
        if edges:
            times["ms_n128"] = _ms(lambda: probes.launch(name, edges[probes.W]), 200,
                                   backlog=True)
        host_ms = _ms(lambda: probes.run(name, x), 200)
        plain_ms = _ms(lambda: probes.run_plain(name, x), 200)
        bound_ms, bound_by = _bound(body.staged_rows * probes.W * 4 + got.numel() * 4, body.ops)
        floor_ms = floors[probes.KERNELS[body.kernel][2]]
        print(f"phase 5: {name} ({body.kernel}): OK {ok}, launches {n_launch}, words differing "
              f"from the plain version {words}"
              + f", on {len(seeded)} seeded inputs {seeded}"
              + (f", on the trip counts {list(edges)} {edge_words}" if edges else "")
              + f"; device {kernel_ms:.5f} ms"
              + (f" ({times['ms_n128']:.5f} at {probes.W} trips)" if edges else "")
              + f" (floor {floor_ms:.5f}), host rate {host_ms:.5f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound_ms * 1e6:.2f} ns ({bound_by})",
              flush=True)
        if not ok or words or any(seeded) or any(edge_words) or n_launch != 1:
            raise AssertionError(f"probe {name} failed on the card")
        k = out.setdefault(body.kernel, {"launches": 0, "max_abs_err": 0.0, "ms": 0.0,
                                         "replaces": body.replaces, "bodies": {}})
        k["launches"] += n_launch
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["bodies"][name] = {**times, "host_ms": host_ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms}
        if kernel_ms >= k["ms"]:
            k.update(ms=kernel_ms, host_ms=host_ms, floor_ms=floor_ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
    print("phase 5: redesign rank, launches x (device ms - bound) in us: " + ", ".join(
        f"{kernel} {gain * 1e3:.3f}" for kernel, gain in probes.redesign_rank(out)),
        flush=True)
    return out


def _phase1b(torch) -> dict:
    """Phase 1b. Returns {cell: {"ms", "jitter_ms", "plain_ms",
    "plain_jitter_ms", "bound_ms", "bound_by", "jitter_bound_ms", "bases",
    "lanes", "sass"}}: the kernel's device time for the cell's bounce batch
    and its jitter, a launch's share of a captured graph of 100 launches
    replayed (as the launch units run it; the wrapper's host cost is not in
    it), the plain chain's as one replay of a captured graph, and the
    bounds, the operations' priced from the instance's SASS (``sass``: its
    thread instructions by pipe). Every uniform is held to the plain chain
    word for word."""
    import terra_tpu_torch as ttt
    from terra_tpu_torch import probes
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.profile import kernel_launches
    from terra_tpu_torch.render import _streams_for

    dev = torch.device("cuda")
    gen = np.random.default_rng(20)
    key_ints = rng.key_from_seed(3000020)
    key_dev = torch.tensor(key_ints, dtype=torch.int64, device=dev)  # a unit's input words

    blocks = probes.sass(rng.kernel_path())
    mixes = {}
    for name, block in blocks.items():
        if m := re.search(r"uniforms_kernelILi(\d+)E", name):
            mixes[int(m.group(1))] = _sass_mix(block)
    if sorted(mixes) != list(range(1, 9)):
        raise AssertionError(f"threefry SASS: instances {sorted(mixes)}, 1..8 expected")

    def bound(n, nb, per_lane_bounce):
        """(ms, "bytes" or the binding pipe) of one launch over n lanes."""
        nbytes = n * (8 * (2 + per_lane_bounce) + 8 * nb)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        clocks = {pipe: mixes[nb][pipe] / rate for pipe, rate in SASS_RATES.items()}
        pipe = max(clocks, key=clocks.get)
        o = n * clocks[pipe] / SM_CLOCKS_PER_S * 1e3
        return (b, "bytes") if b >= o else (o, f"{pipe} pipe")

    for nb, mix in sorted(mixes.items()):
        print(f"  SASS uniforms_kernel<{nb}>: thread instructions a lane by pipe "
              f"{dict(sorted(mix.items()))}", flush=True)

    def graph_ms(fn, launches=1):
        return _graph_ms(torch, fn, launches)

    out = {}
    for cell, n, integ, env in THREEFRY_CELLS:
        streams = _streams_for(ttt.Integrator[integ], env)
        nb = len({s // 2 for s in streams})
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        # samples past 2^20 wrap at sample << 12; bounces per lane as the
        # persistent loop carries them
        sample = torch.as_tensor(gen.integers(0, 1 << 22, n), device=dev)
        lane_bounce = torch.as_tensor(gen.integers(0, 5, n), device=dev)
        words = 0
        kernel_launches.clear()
        for key in (key_dev, key_ints):
            for bounce in (lane_bounce, 1):
                got = rng.path_uniform_bundle(key, pixel, sample, bounce, streams)
                ref = rng.path_uniform_bundle_plain(key, pixel, sample, bounce, streams)
                words += sum(int((got[s].view(torch.int32) != ref[s].view(torch.int32)).sum())
                             for s in streams)
            got = rng.path_uniform2(key, pixel, sample, 0, 0)
            ref = rng.path_uniform2_plain(key, pixel, sample, 0, 0)
            words += sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                         for a, b in zip(got, ref))
        torch.cuda.synchronize()
        if words or kernel_launches["threefry"] != 6:
            raise AssertionError(f"threefry at {cell}: {words} words differ from the plain "
                                 f"chain, {kernel_launches['threefry']} launches (6 expected)")
        row = dict(lanes=n, bases=nb, sass=dict(mixes[nb]))
        row["ms"] = graph_ms(lambda: rng.path_uniform_bundle(
            key_dev, pixel, sample, lane_bounce, streams), 100)
        row["jitter_ms"] = graph_ms(lambda: rng.path_uniform2(key_dev, pixel, sample, 0, 0), 100)
        row["plain_ms"] = graph_ms(lambda: rng.path_uniform_bundle_plain(
            key_dev, pixel, sample, lane_bounce, streams))
        row["plain_jitter_ms"] = graph_ms(lambda: rng.path_uniform2_plain(
            key_dev, pixel, sample, 0, 0))
        row["bound_ms"], row["bound_by"] = bound(n, nb, 1)
        row["jitter_bound_ms"], _ = bound(n, 1, 0)
        print(f"phase 1b: threefry at {cell} ({n} lanes, {nb} stream pairs, {len(streams)} "
              f"streams): words differing from the plain chain 0 (bounce per lane and int, key "
              f"on the device and as ints, and the jitter pair); bundle {row['ms'] * 1e3:.2f} us "
              f"a launch in a graph (bound {row['bound_ms'] * 1e3:.2f} us, {row['bound_by']}; "
              f"plain chain as a graph replay {row['plain_ms'] * 1e3:.1f} us), jitter "
              f"{row['jitter_ms'] * 1e3:.2f} us (bound {row['jitter_bound_ms'] * 1e3:.2f} us; "
              f"plain {row['plain_jitter_ms'] * 1e3:.1f} us)", flush=True)
        out[cell] = row
    kernel_launches.clear()  # the comparisons and timings are not the main path's
    return out


def _phase1c(torch) -> dict:
    """Phase 1c. Returns {case: {"lanes", "rows", "cols", "levels", "ms",
    "sort_ms", "plain_ms", "library_ms", "bound_ms"}} for each of
    ``ACCUMULATE_CASES``: a call's device time as a captured graph of 100
    calls replays it (the sort, the zeroed table and the level launches),
    the stable sort's alone, the plain version on the card (events, eager),
    PyTorch's deterministic ``index_put_(accumulate=True)`` into zeros in a
    graph of 100, and the bound: the gradient and the int64 ids read once
    and the table written once, at 3.35 TB/s. The kernel's table is held to
    the plain version's on the CPU word for word, and to a second call."""
    from terra_tpu_torch import optim
    from terra_tpu_torch.ops import row_accumulate as ra
    from terra_tpu_torch.profile import kernel_launches

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(22)
    out = {}
    for name, n, rows, cols, kind in ACCUMULATE_CASES:
        if kind == "misses":
            ids = torch.randint(1, rows, (n,), generator=gen)
            ids[torch.rand(n, generator=gen) < ROW0_SHARE] = 0
        elif kind == "uniform":
            ids = torch.randint(0, rows, (n,), generator=gen)
        else:
            ids = torch.randperm(rows, generator=gen)[:n]
        grad = torch.randn((n, cols), generator=gen)
        grad[torch.rand((n, cols), generator=gen) < 0.1] = -0.0
        want = ra.row_accumulate_plain(grad, ids, rows)
        g, i = grad.to(dev), ids.to(dev)
        kernel_launches.clear()
        a = ra.row_accumulate(g, i, rows)
        b = ra.row_accumulate(g, i, rows)
        torch.cuda.synchronize()
        words = int((a.cpu().view(torch.int32) != want.view(torch.int32)).sum())
        repeat = torch.equal(a.view(torch.int32), b.view(torch.int32))
        levels = len(ra.level_sizes(n))
        if words or not repeat or kernel_launches["row_accumulate"] != 2 * levels:
            raise AssertionError(f"row_accumulate at {name}: {words} words differ from the plain "
                                 f"version, bits repeat {repeat}, "
                                 f"{kernel_launches['row_accumulate']} launches "
                                 f"({2 * levels} expected)")

        def library():
            return torch.zeros((rows, cols), device=dev).index_put_((i,), g, accumulate=True)

        row = dict(lanes=n, rows=rows, cols=cols, levels=levels)
        row["ms"] = _graph_ms(torch, lambda: ra.row_accumulate(g, i, rows), 100)
        row["sort_ms"] = _graph_ms(torch, lambda: torch.sort(i.to(torch.int32), stable=True), 100)
        row["plain_ms"] = _ms(lambda: ra.row_accumulate_plain(g, i, rows), 3)
        with optim.deterministic():
            row["library_ms"] = _graph_ms(torch, library, 100)
        row["bound_ms"] = (n * cols * 4 + n * 8 + rows * cols * 4) / HBM_BYTES_PER_S * 1e3
        row["library_max_rel"] = float((library() - a).abs().max() / a.abs().max())
        print(f"phase 1c: row_accumulate {name} ({n} lanes into ({rows} x {cols}), {kind}, "
              f"{levels} levels): words differing from the plain version 0, bits repeat; "
              f"{row['ms'] * 1e3:.1f} us a call in a graph (of it the sort "
              f"{row['sort_ms'] * 1e3:.1f} us; bound {row['bound_ms'] * 1e3:.1f} us, bytes); "
              f"plain {row['plain_ms']:.2f} ms; PyTorch's deterministic index_put_ "
              f"{row['library_ms'] * 1e3:.1f} us in a graph (max rel to the kernel "
              f"{row['library_max_rel']:.2e})", flush=True)
        out[name] = row
    kernel_launches.clear()  # the comparisons and timings are not the main path's
    return out


def _phase1d(torch, ttt) -> dict:
    """Phase 1d. Returns {builder: {"leaves", "internal", "leaf_size",
    "ms", "bound_ms", "host_ms"}}: a refit's device time as a captured
    graph of 100 refits replays it (both launches and the scratch), the
    bound (the slot ids, vertex ids and corners of every leaf slot, the
    topology and the parents, the children's boxes read and every box
    written, each byte once, at 3.35 TB/s) and the host refit's wall time
    (mean of 3, between synchronisations). The kernel's boxes are held to
    ``_refit_host``'s on host copies, and to a second call's bits."""
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.profile import kernel_launches

    dev = torch.device("cuda")
    geometry = ttt.scenes.courtyard(device=dev).geometry
    gen = torch.Generator().manual_seed(24)
    step = (torch.rand(geometry.positions.shape, generator=gen) * 2 - 1) * 1e-3
    moved = dataclasses.replace(geometry, positions=geometry.positions + step.to(dev))
    out = {}
    for builder in ("sah", "lbvh"):
        bvh = lbvh.build(geometry, builder=builder)
        host = [t.cpu().numpy() for t in (moved.positions, moved.tri_vidx, bvh.leaf_tri,
                                          bvh.node_left, bvh.node_right)]
        want_min, want_max = (torch.from_numpy(x) for x in lbvh._refit_host(*host))
        kernel_launches.clear()
        a, b = lbvh.refit(bvh, moved), lbvh.refit(bvh, moved)
        torch.cuda.synchronize()
        equal = torch.equal(a.node_min.cpu(), want_min) and torch.equal(a.node_max.cpu(),
                                                                        want_max)
        repeat = all(torch.equal(getattr(a, f).view(torch.int32), getattr(b, f).view(torch.int32))
                     for f in ("node_min", "node_max"))
        if not equal or not repeat or kernel_launches["bvh_refit"] != 4:
            raise AssertionError(f"bvh_refit on the {builder} tree: equal to the plain twin "
                                 f"{equal}, bits repeat {repeat}, "
                                 f"{kernel_launches['bvh_refit']} launches (4 expected)")
        ni, c, leaf = bvh.num_internal, bvh.num_leaves, bvh.leaf_size
        nbytes = (c * leaf * (4 + 3 * 4 + 9 * 4)  # slot ids, vertex ids, corners
                  + ni * (2 * 4 + 2 * 4 + 4)  # children read, parents written, counters zeroed
                  + ni * (4 + 2 * 4 + 4 + 2 * 24)  # a parent, its children, its counter, boxes
                  + (ni + c) * 24)  # every box written
        row = dict(leaves=c, internal=ni, leaf_size=leaf,
                   ms=_graph_ms(torch, lambda: lbvh.refit_(a, moved), 100),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

        def host_refit():
            pos, vidx = lbvh._host(moved)
            bmin, bmax = lbvh._refit_host(pos, vidx, bvh.leaf_tri.cpu().numpy(),
                                          bvh.node_left.cpu().numpy(),
                                          bvh.node_right.cpu().numpy())
            b.node_min.copy_(torch.as_tensor(bmin))
            b.node_max.copy_(torch.as_tensor(bmax))

        host_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_refit()
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t0)
        row["host_ms"] = float(np.mean(host_s)) * 1e3
        print(f"phase 1d: bvh_refit on the courtyard's {builder} tree ({c} leaves of {leaf}, "
              f"{ni} internal nodes): equal to the plain twin, bits repeat, 2 launches a refit; "
              f"{row['ms'] * 1e3:.1f} us a refit in a graph (bound {row['bound_ms'] * 1e3:.1f} "
              f"us, bytes); the host refit it replaced {row['host_ms']:.1f} ms "
              f"({[round(x * 1e3, 1) for x in host_s]})", flush=True)
        out[builder] = row
    kernel_launches.clear()  # the comparisons and timings are not the main path's
    return out


def _phase1e(torch, ttt) -> dict:
    """Phase 1e. Returns {"<algo>/<closest|ranged>": {"rays", "tris", "ms",
    "bound_ms", "bound_by", "grid_ms"}}: the sweep kernel at
    ``cornell.render``'s raycast shape, held to the plain grid on the card
    word for word, timed as a launch's share of a captured graph of 100
    launches, against its bound and the grid's time in a graph of 10."""
    from terra_tpu_torch import intersect
    from terra_tpu_torch.profile import kernel_launches

    dev = torch.device("cuda")
    scene = ttt.scenes.cornell_box(device=dev)
    corners = tuple(c.detach() for c in scene.geometry.corners())
    slots = intersect.pack_sweep(*corners)
    o, d = _camera_rays(torch, ttt.scenes.cornell_camera(device=dev), 512, dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    t_max = torch.rand(o.shape[0], generator=gen, device=dev) * 1000.0
    n, tris = o.shape[0], corners[0].shape[0]
    out = {}
    for algo in ("mt", "watertight"):
        for label, tm in (("closest", None), ("ranged", t_max)):
            def kernel():
                return intersect.raycast_sweep(o, d, *corners, t_max=tm, algo=algo, slots=slots)

            def grid():
                h = intersect.raycast_brute(o, d, *corners, algo=algo)
                if tm is None:
                    return h
                occ = h.t < tm
                return intersect.RayHit(t=h.t, tri=torch.where(occ, h.tri, 0), hit=occ)

            kernel_launches.clear()
            got, want = kernel(), grid()
            torch.cuda.synchronize()
            words = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                        for a, b in ((got.t, want.t), (got.tri, want.tri)))
            words += int((got.hit != want.hit).sum())
            if words or kernel_launches["sweep"] != 1:
                raise AssertionError(f"sweep {algo} {label}: {words} words differ from the grid, "
                                     f"{kernel_launches['sweep']} launches (1 expected)")
            nbytes = n * (6 * 4 + (4 if tm is not None else 0) + 9) + tris * 40
            ops = n * tris * 46 + tris * 6
            bound_ms, bound_by = _bound(nbytes, ops)
            row = dict(rays=n, tris=tris, hits=int(want.hit.sum()),
                       ms=_graph_ms(torch, kernel, 100), bound_ms=bound_ms, bound_by=bound_by,
                       grid_ms=_graph_ms(torch, grid, 10))
            print(f"phase 1e: sweep {algo} {label} ({n} rays x {tris} triangles, {row['hits']} "
                  f"hits): the grid's words, one launch; {row['ms'] * 1e3:.2f} us a launch in a "
                  f"graph of 100 (bound {bound_ms * 1e3:.2f} us, {bound_by}); the grid "
                  f"{row['grid_ms'] * 1e3:.1f} us", flush=True)
            out[f"{algo}/{label}"] = row
    kernel_launches.clear()  # the comparisons and timings are not the main path's
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


def _phase7(torch, ttt, scene, render_3b_s):
    """Phase 7: the command line at full width. Returns the launches of the
    in-process CLI runs {"binary", "bvh4"}, and 7c's render clock per pass
    (the first pass captures the render's graphs)."""
    from terra_tpu_torch import _build, cli, profile
    from terra_tpu_torch.io import image as image_mod
    from terra_tpu_torch.profile import kernel_launches

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
        before = kernel_launches.copy()
        t0 = time.perf_counter()
        film = real_render(*a, **k)
        torch.cuda.synchronize()
        ran = kernel_launches - before
        per_pass.append({"s": time.perf_counter() - t0, "binary": ran["binary"],
                         "bvh4": ran["bvh4"],
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
    kernel_launches.clear()
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
    launches = kernel_launches.copy()
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
        before = kernel_launches.copy()
        t0 = time.perf_counter()
        cwd = os.getcwd()
        try:
            os.chdir(tmp)
            rc = cli.main(["render", small, "--width", "32", "--height", "32", "--spp", "4",
                           "--bounces", "2", "--integrator", "direct", "--opt",
                           "render_jitter=0.5", "--checkpoint", ck_d, "--device", device])
        finally:
            os.chdir(cwd)
        ran = kernel_launches - before
        if device == "cuda":
            launches.update(ran)
        acc, spp = _film_npz(ck_d)
        imgs[device] = acc / np.maximum(spp, 1)[..., None]
        print(f"phase 7d: CLI on the small courtyard (grid 40, 8 columns) 32x32x4spp DIRECT "
              f"--device {device}: rc {rc}, {time.perf_counter() - t0:.2f} s, mean "
              f"{imgs[device].mean():.5f}, launches binary {ran['binary']} bvh4 "
              f"{ran['bvh4']}", flush=True)
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
    return launches, [float(c) for c in clock]


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


def _train_2(torch, optim, lbvh, step, start, key):
    """Two steps of ``step`` from phase 6c's start with a refit after
    each, in place in a copy of the start's boxes, as recover() does (so a
    graphed step captures once); returns ([(loss, params, node_min,
    node_max, ms, peak GiB)] per step)."""
    state = optim.TrainState(optim.extract_params(start, FIELDS_6C), None, 0)
    scene = dataclasses.replace(start, bvh=dataclasses.replace(
        start.bvh, node_min=start.bvh.node_min.clone(), node_max=start.bvh.node_max.clone()))
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loss = step(state, scene, key)
        lbvh.refit_(scene.bvh, dataclasses.replace(
            scene.geometry, positions=state.params["positions"].detach()))
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
    from terra_tpu_torch import graphs, optim
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import band_rows_of, gather_rows, make_mesh, render_sharded
    from terra_tpu_torch.profile import kernel_launches

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
    for (r, s), mesh in meshes.items():
        render_sharded(scene, cam, opts, mesh, seed=1)  # warm-up: captures the band graph
        seconds, launches = [], []
        for i in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            kernel_launches.clear()
            t0 = time.perf_counter()
            film = render_sharded(scene, cam, opts, mesh, seed=0)
            torch.cuda.synchronize()
            dist.barrier()
            seconds.append(time.perf_counter() - t0)
            launches.append(dict(kernel_launches))
            if i == 0:
                rows = band_rows_of(mesh, opts.height)
                acc = gather_rows(film.acc, rows, opts.height, mesh)
                samples = gather_rows(film.samples, rows, opts.height, mesh)
        res[f"{r}x{s}"] = {"seconds": seconds, "launches": launches, "row": mesh.row,
                           "sample": mesh.sample}
        if rank == 0:
            np.save(os.path.join(args.out, f"film_{r}x{s}.npy"), acc.cpu().numpy())
            np.save(os.path.join(args.out, f"samples_{r}x{s}.npy"), samples.cpu().numpy())
    mesh = meshes[(2, 2)] if args.rank_job == "shard" else meshes[(1, 1)]
    o6 = _opts_6c(ttt)
    target = torch.load(os.path.join(args.out, "target_6c.pt"), map_location=dev)
    start = _start_6c(torch, optim, scene)
    key = rng.key_from_seed(7)
    params = optim._trainable(optim.extract_params(start, FIELDS_6C))
    kernel_launches.clear()
    grads_by = {}
    for chunks in ((1, 2) if args.rank_job == "shard" else (2,)):
        grads_by[chunks] = optim.make_grad_fn_sharded(cam, o6, target, mesh, grad_chunks=chunks)(
            params, start, key, 0)
        if rank == 0 and args.rank_job == "shard":
            loss, grads = grads_by[chunks]
            torch.save({"loss": float(loss), **{k: g.cpu() for k, g in grads.items()}},
                       os.path.join(args.out, f"grads_{chunks}.pt"))
    step = optim.make_train_step_sharded(cam, o6, target,
                                         functools.partial(torch.optim.Adam, lr=3e-2), mesh,
                                         grad_chunks=2)
    steps = _train_2(torch, optim, lbvh, step, start, key)
    train_launches = dict(kernel_launches)
    # 10d: the same bodies run uncaptured, op by op (launches not counted)
    with _eager_units():
        loss_e, grads_e = optim.make_grad_fn_sharded(cam, o6, target, mesh, grad_chunks=2)(
            params, start, key, 0)
        steps_e = _train_2(torch, optim, lbvh, optim.make_train_step_sharded(
            cam, o6, target, functools.partial(torch.optim.Adam, lr=3e-2), mesh, grad_chunks=2),
            start, key)
    loss_g, grads_g = grads_by[2]
    res["10d"] = {"grad_bits": [_same_bits(loss_g, loss_e)]
                  + [_same_bits(grads_g[k], grads_e[k]) for k in sorted(grads_g)],
                  "param_bits": [_same_bits(a[1][k], b[1][k]) for a, b in zip(steps, steps_e)
                                 for k in FIELDS_6C],
                  "losses": [x[0] for x in steps], "eager_losses": [x[0] for x in steps_e],
                  "ms": [x[4] for x in steps], "eager_ms": [x[4] for x in steps_e],
                  "units": graphs.units()}
    res["train"] = {"losses": [x[0] for x in steps], "ms": [x[4] for x in steps],
                    "peak_gib": [x[5] for x in steps]}
    res["train_launches"] = train_launches
    torch.save([{**{k: v.cpu() for k, v in x[1].items()}, "node_min": x[2].cpu(),
                 "node_max": x[3].cpu()} for x in steps],
               os.path.join(args.out, f"params_{args.rank_job}_rank{rank}.pt"))
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
        per_rank = [sum(x.get("bvh4", 0) for x in rk[label]["launches"]) for rk in rows]
        for rk in rows:
            for x in rk[label]["launches"]:
                launches.update(x)
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
    params = [torch.load(os.path.join(out, f"params_shard_rank{i}.pt")) for i in range(4)]
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
        launches.update(rk["train_launches"])
    print(f"phase 8b: phase 6c's gradient at mesh (2, 2) (384x384x8spp, fields {FIELDS_6C}): loss "
          f"{g2['loss']:.6e} vs unsharded {float(loss0):.6e} (rel {loss_rel:.2e}); grad_chunks 2 "
          f"vs unsharded, max |d| / largest entry per field "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }; grad_chunks 2 vs 1 "
          f"{ {k: f'{v:.2e}' for k, v in rel12.items()} }", flush=True)
    for i in range(2):
        print(f"  Adam step {i} (grad_chunks 2, a refit): loss {losses[i]:.6e}, the unsharded "
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
          f"{[rk['train_launches'].get('bvh4', 0) for rk in ranks]}; phase 8a-b "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    launches.update(nccl["train_launches"])
    for label, rks in (("4 gloo ranks at mesh (2, 2)", ranks), ("1 NCCL rank at (1, 1)", [nccl])):
        d = [rk["10d"] for rk in rks]
        grad_ok = all(all(x["grad_bits"]) for x in d)
        param_ok = all(all(x["param_bits"]) for x in d)
        loss_ok = all(x["losses"] == x["eager_losses"] for x in d)
        print(f"phase 10d: the sharded step on {label}, grad_chunks 2 (graphed; eager = the "
              f"same bodies uncaptured): gradients bit-equal to the eager sharded step's "
              f"{grad_ok}; after 2 Adam steps with a refit, parameters bit-equal to "
              f"eager's {param_ok}, losses equal {loss_ok}; ms/step per rank graphed "
              f"{[[round(x, 1) for x in y['ms']] for y in d]} against eager "
              f"{[[round(x, 1) for x in y['eager_ms']] for y in d]} (step 0 captures)",
              flush=True)
        ok &= grad_ok and param_ok and loss_ok
        results[f"10d/{label}"] = {"ms": [x["ms"] for x in d],
                                   "eager_ms": [x["eager_ms"] for x in d]}
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
        kernel_ms = _ms(lambda: pt.raycast4_cuda(tables, o, d), 20)
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


# --- phase 9: the launch units as CUDA graphs --------------------------------

def _render_once(torch, ttt, render_mod, scene, cam, opts, seed, film=None, eager=False):
    """One ``render`` (eager through ``render_rows`` or through the graphs),
    timed on the host clock ending in a synchronisation. Returns (film,
    seconds, loop trips, {kernel: launches}, peak allocated bytes)."""
    import contextlib

    from terra_tpu_torch.profile import kernel_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    render_mod.trips = 0
    kernel_launches.clear()
    t0 = time.perf_counter()
    with _eager() if eager else contextlib.nullcontext():
        film = ttt.render(scene, cam, opts, seed=seed, film=film)
    torch.cuda.synchronize()
    return (film, time.perf_counter() - t0, render_mod.trips, kernel_launches.copy(),
            torch.cuda.max_memory_allocated())


def _short(kernel: str) -> str:
    """A kernel's name without namespaces."""
    return re.sub(r"\(anonymous namespace\)::|\b\w+::|^void ", "", kernel)


def _graph_time(torch, ttt, scene, cam, opts, kernels: bool) -> dict:
    """Where one graphed render's time goes (its units already captured):
    the program's hot spans under ``profile.tracing()``, the host seconds
    of every graph replay (``terra.unit.replay.<stage>``) and flag read
    (``terra.unit.flag_read``), beside the host clock (the rest is the
    film adds, the input writes and the host's own work); then
    (``kernels``) the same render under ``torch.profiler`` (CUDA activity),
    its kernels' device time summed by name."""
    from terra_tpu_torch import profile

    def read(targets):
        return {k: (s.sum, s.n) for k, s in targets.items()
                if k.startswith("terra.unit.replay.") or k == "terra.unit.flag_read"}

    torch.cuda.synchronize()
    before = read(profile.profiler.targets)
    with profile.tracing() as registry:
        t0 = time.perf_counter()
        ttt.render(scene, cam, opts, seed=0)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = {k: ((v[0] - before.get(k, (0.0, 0))[0]) * 1e3, v[1] - before.get(k, (0.0, 0))[1])
             for k, v in read(registry.targets).items()}
    out = dict(host_ms=host_ms, stage_ms={k.rsplit(".", 1)[-1]: v[0] for k, v in spans.items()},
               replays={k.rsplit(".", 1)[-1]: v[1] for k, v in spans.items()})
    if not kernels:
        return out
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ttt.render(scene, cam, opts, seed=0)
        torch.cuda.synchronize()
    rows = sorted(((_short(e.key), e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return dict(out, kernel_ms=sum(r[1] for r in rows), kernel_count=sum(r[2] for r in rows),
                top=rows[:10])


def _tensors(obj) -> list:
    """Every tensor in ``obj`` (tensors, tuples, lists, dataclasses)."""
    if hasattr(obj, "data_ptr"):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _tensor_words(torch, a, b) -> int:
    """Differing elements of two tensors, floats compared by their bits."""
    if a.dtype in (torch.float32, torch.int32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _stage_ab(torch, scene, cam, opts) -> dict:
    """Phase 3m's stage breakdown: ``profile.stage_breakdown`` with its
    stages captured (``graphs.staged_unit``, as it runs) and eagerly
    (``staged_unit`` patched to hand back the body), both the least of 3
    after one more (CUDA events); each captured stage's outputs, replayed,
    against the eager stage's, word for word; each unit's warm-up, capture
    and pool."""
    from terra_tpu_torch import graphs, profile

    kept = {}
    real = graphs.staged_unit

    def keeping(eager):
        def make(body):
            kept[(eager, body.stages[0])] = unit = body if eager else real(body)
            return unit
        return make

    secs = {}
    for eager in (False, True):
        with mock.patch.object(graphs, "staged_unit", keeping(eager)):
            secs[eager] = profile.stage_breakdown(scene, cam, opts, probe_lanes=1 << 18)
    words = {}
    for name in secs[False]:
        g = _tensors(kept[(False, name)].replay(name))
        e = _tensors(kept[(True, name)].run(name))
        torch.cuda.synchronize()
        words[name] = sum(_tensor_words(torch, x, y) for x, y in zip(g, e)) + \
            abs(len(g) - len(e))
    units = {name: kept[(False, name)].describe() for name in secs[False]}
    print("  stage breakdown (1M scene, 2^18 camera lanes, least of 3 after one more, CUDA "
          "events), graphed vs eager: " + ", ".join(
              f"{k} {secs[False][k] * 1e3:.3f} ms vs {secs[True][k] * 1e3:.3f} ms "
              f"({words[k]} words differ; warm-up {units[k]['warmup_s']:.3f} s, capture "
              f"{units[k]['capture_s']:.3f} s, pool {units[k]['pool_bytes'] / 2**20:.1f} MiB)"
              for k in secs[False]), flush=True)
    if any(words.values()) or not all(0 < v < float("inf") for v in secs[False].values()):
        raise AssertionError(f"a captured stage disagrees with the eager one: {words}")
    return dict(graphed_s=secs[False], eager_s=secs[True], words=words, units=units)


def _bucket_ab(torch, pt, compact_bench, scene, cam, dev) -> dict:
    """Phase 3c's fine-bucket case: ``raycast_compact`` at M = 128 on 2^20
    dir3-sorted camera rays of ``scene`` with tail buckets (1, 8, 64, 512,
    4096), whose rounds of at most n/512 active rays fit
    ``compact.GRAPH_SWEEP`` and replay units (captured by the first call
    into the run's one pool, none by a later call), against
    ``raycast_compact_eager`` in turns (E G G E E G, medians of 3, host
    clock ending in a synchronise); hits equal word for word, BVH4
    launches per call equal."""
    from terra_tpu_torch import graphs
    from terra_tpu_torch.accel import compact, traverse

    o, d = _camera_rays(torch, cam, 1024, dev)
    order = traverse.sort_order(scene.bvh, o, d, "dir3")
    o, d = o[order].contiguous(), d[order].contiguous()
    tables = pt.pack_tables_auto(scene.bvh, *scene.geometry.corners())
    fr = compact.build_frontier(scene.bvh, 128)
    buckets = (1, 8, 64, 512, 4096)
    fns = {"eager": functools.partial(compact.raycast_compact_eager, scene.bvh, tables, fr, o, d),
           "graphed": functools.partial(compact.raycast_compact, scene.bvh, tables, fr, o, d,
                                        tail_buckets=buckets)}
    first, again = {}, {}
    fns["graphed"](stats=first)
    words = compact_bench._words(fns["graphed"](stats=again), fns["eager"]())
    launches = {k: compact_bench._launches4(f) for k, f in fns.items()}
    secs = compact_bench._turns(fns, dev)
    med = {k: sorted(v)[1] for k, v in secs.items()}
    units = [u.describe() for u in again["units"].values() if isinstance(u, graphs.StagedUnit)]
    pool = sum(u["pool_bytes"] for u in units)
    print(f"  tail buckets {buckets}, M=128: lanes per tail round {again['buckets']} (active "
          f"{again['active']}); captures {first['captures']} (a later call {again['captures']}),"
          f" replays per call {again['replays']}, pool {pool / 2**20:.1f} MiB; in turns (E G G E "
          f"E G, medians of 3) eager {med['eager']:.4f} s, raycast_compact "
          f"{med['graphed']:.4f} s; BVH4 launches per call {launches}; hits {words} words "
          f"differ", flush=True)
    if words or not first["captures"] or again["captures"] or not again["replays"] or \
            launches["graphed"] != launches["eager"]:
        raise AssertionError("the compact walk's units disagree with the eager walk")
    return dict(median_s=med, turns_s=secs, buckets=again["buckets"], active=again["active"],
                captures=first["captures"], replays=again["replays"], pool_bytes=pool)


def _ray_zero_gate(torch, ttt, pt, dev) -> collections.Counter:
    """tests/test_torch_compact.py's ray-0 case on the card: 600 rays of
    the 3000-triangle random scene (seed 5) against frontiers of 4 leaves,
    the ray with the most pairs entered before its closest hit moved to
    ray 0, through ``raycast_compact`` with tail buckets (1, 8, 64), every
    stage a replayed unit. Ray 0's hit must be the classic walk's word for
    word, every hit the classic walk's (hit masks, t within 1e-5, >= 99%
    same triangle), the last tail rounds padded, and the hits equal to the
    eager call's word for word. Returns the graphed call's launches."""
    from terra_tpu_torch import intersect
    from terra_tpu_torch.accel import compact
    from terra_tpu_torch.profile import kernel_launches

    sc = ttt.scenes.random_triangles(3000, seed=5, accelerator=ttt.Accelerator.BVH, device=dev)
    tables = pt.pack_tables_wide(sc.bvh, *sc.geometry.corners())
    fr = compact.build_frontier(sc.bvh, 4)
    r = np.random.default_rng(81)
    o = r.uniform(-2, 2, (600, 3)).astype(np.float32)
    d = r.normal(size=(600, 3)).astype(np.float32)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d / np.linalg.norm(
        d, axis=-1, keepdims=True), device=dev)
    ref_t, ref_i = pt.traverse_packed(tables, o, d)
    keys = compact._entry_keys(fr, o, d)
    before = ((keys != compact.KEY_INF) & (keys.view(torch.float32) < ref_t[:, None])).sum(1)
    first = int(torch.argmax(torch.where(ref_t < intersect.T_FAR, before, 0)))
    perm = torch.cat([torch.tensor([first], device=dev),
                      torch.arange(600, device=dev)[torch.arange(600, device=dev) != first]])
    o, d = o[perm].contiguous(), d[perm].contiguous()
    ref_t, ref_i = ref_t[perm], ref_i[perm]
    stats = {}
    compact.raycast_compact(sc.bvh, tables, fr, o, d, stats=stats)  # captures
    kernel_launches.clear()
    got = compact.raycast_compact(sc.bvh, tables, fr, o, d, stats=stats)
    torch.cuda.synchronize()
    launches = kernel_launches.copy()
    eager = compact.raycast_compact_eager(sc.bvh, tables, fr, o, d)
    hit = ref_t < intersect.T_FAR
    words = _tensor_words(torch, got.t, eager.t) + _tensor_words(torch, got.tri, eager.tri)
    zero = bool(got.hit[0]) and _tensor_words(torch, got.t[:1], ref_t[:1]) == 0 and \
        int(got.tri[0]) == int(ref_i[0])
    same = float((got.tri[hit] == ref_i[hit]).float().mean())
    close = bool(torch.allclose(got.t[hit], ref_t[hit], rtol=1e-5, atol=0.0))
    mism = int((got.hit != hit).sum())
    padded = stats["buckets"][-1] > stats["active"][-1]
    print(f"  ray 0 under tail buckets (1, 8, 64), graphed: {int(before[first])} pairs before "
          f"its hit, rounds {stats['rounds']}, active {stats['active']}, buckets "
          f"{stats['buckets']}, replays {stats['replays']}; ray 0 equal to the classic walk "
          f"{zero}; hit-mask mismatches {mism}, t close {close}, same-tri {same:.6f}; vs eager "
          f"{words} words differ; BVH4 launches {launches['bvh4']}", flush=True)
    replayed = stats["replays"] == stats["rounds"] - 1  # the head and every tail round
    if not (zero and close and same > 0.99 and mism == 0 and words == 0 and padded
            and replayed and stats["captures"] == 0 and int(before[first]) >= 5):
        raise AssertionError("the graphed compact walk lost ray 0 or disagrees")
    return launches


def _words(torch, a, b) -> int:
    """Differing 32-bit words of two films (accumulator and sample counts)."""
    return int((a.acc.view(torch.int32) != b.acc.view(torch.int32)).sum()) + \
        int((a.samples != b.samples).sum())


def _phase9(torch, ttt, pt, cells, cli_passes):
    """Phase 9: the launch units as CUDA graphs (``graphs.py``). 9a, per
    cell: the graphed ``render`` against the eager one (``render_rows`` in
    the same order; 0 differing words), a second seed at a later sample
    offset replayed on the same graph, trips and BVH4 launches per render;
    on 3b ``render_band`` replayed at three first rows against
    ``render_rows``, a second courtyard (attributes halved) and the same one
    changed in place, each its own image, and a host read planted in the
    loop body, which must make the render raise. 9b, per cell: eager and
    graphed renders in turns (E G G E E G), host clock ending in a
    synchronisation, medians of 3; warm-up and capture seconds, replays,
    trips, peak memory of each and the graph pool's bytes; where a graphed
    render's time goes (``_graph_time``); 7c's CLI passes through the
    graphs. Returns the main path's launches and the numbers by cell."""
    import importlib

    from terra_tpu_torch import graphs
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.profile import kernel_launches

    render_mod = importlib.import_module("terra_tpu_torch.render")
    t_phase = time.perf_counter()
    launches = collections.Counter()
    failed = []
    results = {}

    def run(scene, cam, opts, seed, film=None, eager=False):
        out = _render_once(torch, ttt, render_mod, scene, cam, opts, seed, film, eager)
        if not eager:
            launches.update(out[3])
        return out

    for label, scene, cam, opts in cells:
        graphs.clear()
        # 9a. films, trips and launches, eager against graphed
        fe, _, _, _, _ = run(scene, cam, opts, 0, eager=True)
        fg, first_s, _, _, _ = run(scene, cam, opts, 0)  # warm-up, capture, replay
        # trips and launches of a render that only replays
        fe7, _, trips_e, l_e, _ = run(scene, cam, opts, 7, film=fe, eager=True)
        fg7, _, trips_g, l_g, _ = run(scene, cam, opts, 7, film=fg)
        unit = graphs.units()[-1]
        w0, w7 = _words(torch, fe, fg), _words(torch, fe7, fg7)
        per_trip = unit["launches"].get("step", {}).get("bvh4", 0) / max(unit["trips_per_step"], 1)
        l_ok = l_g["bvh4"] - l_e["bvh4"] == (trips_g - trips_e) * per_trip and \
            l_g["binary"] == l_e["binary"]
        n_units = len(graphs.units())
        print(f"phase 9a: {label}: graphed film vs eager (render_rows order) {w0} words differ; "
              f"seed 7 resumed at sample offset {opts.samples_per_pixel} on the same graph "
              f"{w7} words; units captured {n_units}; per render of seed 7: trips eager "
              f"{trips_e} graph {trips_g} "
              f"(blocks of {unit['trips_per_step']}, bound "
              f"{unit['trips_per_step'] * unit['max_steps']}); launches per render eager "
              f"{dict(l_e)} graph {dict(l_g)} (bvh4 per trip {per_trip:g}); graph stages launch "
              f"{unit['launches']}", flush=True)
        if w0 or w7 or not l_ok or n_units != 1 or trips_g < trips_e:
            failed.append(f"{label}: films, trips or launches")
        # 9b. time in turns, E G G E E G
        secs = {"eager": [], "graph": []}
        peak = {}
        for kind in ("eager", "graph", "graph", "eager", "eager", "graph"):
            _, sec, _, _, pk = run(scene, cam, opts, 0, eager=kind == "eager")
            secs[kind].append(sec)
            peak[kind] = max(peak.get(kind, 0), pk)
        unit = graphs.units()[-1]
        med = {k: float(np.median(v)) for k, v in secs.items()}
        print(f"phase 9b: {label} {opts.width}x{opts.height}x{opts.samples_per_pixel}spp: render "
              f"eager {med['eager']:.4f} s, graph {med['graph']:.4f} s (medians of 3; turns "
              f"eager {[round(x, 4) for x in secs['eager']]}, graph "
              f"{[round(x, 4) for x in secs['graph']]}), eager / graph "
              f"{med['eager'] / med['graph']:.2f}; first graphed render {first_s:.3f} s (warm-up "
              f"{unit['warmup_s']:.3f} s, capture {unit['capture_s']:.3f} s); replays "
              f"{unit['replays']}; trips eager {trips_e} graph {trips_g}; peak memory eager "
              f"{peak['eager'] / 2**30:.3f} GiB, graph {peak['graph'] / 2**30:.3f} GiB beside its "
              f"pool of {unit['pool_bytes'] / 2**30:.3f} GiB", flush=True)
        # the profiler's kernel breakdown on 3b only: its post-processing
        # of the larger cells' traces would cost tens of seconds
        bd = _graph_time(torch, ttt, scene, cam, opts, kernels=label == "3b")
        inside = sum(bd["stage_ms"].values())
        print(f"phase 9b: {label} where a graphed render's time goes: host clock "
              f"{bd['host_ms']:.2f} ms; in replays and flag reads {inside:.2f} ms (host spans: "
              + ", ".join(f"{k} {v:.2f} ms over {bd['replays'][k]}"
                          for k, v in bd["stage_ms"].items())
              + f"), outside them {bd['host_ms'] - inside:.2f} ms", flush=True)
        if "top" in bd:
            print(f"  the profiler: {bd['kernel_count']} kernels, {bd['kernel_ms']:.2f} ms of "
                  f"kernel time (busy share of the host clock {bd['kernel_ms'] / bd['host_ms']:.3f}"
                  f"); by name:", flush=True)
            for name, ms, count in bd["top"]:
                print(f"    {ms:8.3f} ms  x{count:<6d} {name[:120]}", flush=True)
        results[label] = dict(eager_s=med["eager"], graph_s=med["graph"], turns=secs,
                              first_s=first_s, warmup_s=unit["warmup_s"],
                              capture_s=unit["capture_s"], replays=unit["replays"],
                              trips_eager=trips_e, trips_graph=trips_g, peak_eager=peak["eager"],
                              peak_graph=peak["graph"], pool_bytes=unit["pool_bytes"],
                              launches_eager=l_e, launches_graph=l_g)
        if label != "3b":
            continue
        # render_band at three first rows on one graph, a tensor key
        dev = scene.device
        rows = opts.height // 6
        key = rng.key_from_seed(3)
        key_t = torch.tensor(key, dtype=torch.int64, device=dev)
        for row0 in (0, opts.height // 2, opts.height - rows):
            kernel_launches.clear()
            band = render_mod.render_band(scene, cam, opts, key_t,
                                          torch.tensor(8, device=dev),
                                          torch.tensor(row0, device=dev),
                                          opts.samples_per_pixel, rows)
            launches.update(kernel_launches)
            ref = render_mod.render_rows(scene, cam, opts, key, 8, opts.samples_per_pixel, row0,
                                         rows)
            w = int((band.view(torch.int32) != ref.view(torch.int32)).sum())
            band_unit = graphs.units()[-1]
            print(f"phase 9a: 3b render_band rows [{row0}, {row0 + rows}) at offset 8, key of "
                  f"seed 3 (tensors): {w} words differ from render_rows; band graph replays "
                  f"{band_unit['replays']}", flush=True)
            if w:
                failed.append(f"3b band at {row0}")
        if band_unit["replays"] != 3:
            failed.append("3b bands did not share one graph")
        # a second courtyard, then the same one changed in place
        half = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, attrs=scene.materials.attrs * 0.5))
        for what in ("second scene (attrs halved)", "the second scene changed in place"):
            if what.startswith("the second"):
                half.materials.attrs.mul_(0.5)
            f2e, _, _, _, _ = run(half, cam, opts, 0, eager=True)
            f2g, _, _, _, _ = run(half, cam, opts, 0)
            w2, w_first = _words(torch, f2e, f2g), _words(torch, f2g, fg)
            print(f"phase 9a: 3b {what}: graphed vs eager {w2} words differ; words differing "
                  f"from the first courtyard's film {w_first}; units {len(graphs.units())}",
                  flush=True)
            if w2 or not w_first:
                failed.append(f"3b {what}")
        # a host read planted in the loop body must make the render raise
        real_trip = render_mod._persistent_trip

        def syncing_trip(*a):
            out = real_trip(*a)
            bool(out["finished"].any())
            return out

        graphs.clear()
        small = opts.replace(width=32, height=32)
        with mock.patch.object(render_mod, "_persistent_trip", syncing_trip):
            try:
                ttt.render(scene, cam, small, seed=0)
                raised = "nothing"
            except RuntimeError as e:
                raised = str(e).splitlines()[0][:160]
        print(f"phase 9a: 3b with a host read in the loop body: render raised: {raised}; units "
              f"kept {len(graphs.units())}", flush=True)
        if "synchroniz" not in raised or graphs.units():
            failed.append("a host read in the body did not raise")
        graphs.clear()
    if cli_passes:
        print(f"phase 9b: 7c's CLI passes through the graphs (3b's settings, the profiler's "
              f"render clock): {[round(c, 4) for c in cli_passes]} s (pass 1 captures)",
              flush=True)
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s; every capture's warm-up ran under "
          f"torch.cuda.set_sync_debug_mode('error')", flush=True)
    if failed:
        raise AssertionError(f"phase 9 failed: {failed}")
    return launches, results


# --- phase 10: the training units as CUDA graphs -----------------------------

def _eager_step(optim, cam, opts, target, optimizer=None, spp=None):
    """``make_train_step``'s eager counterpart: ``optim.value_and_grad`` of
    ``make_loss_fn``, then the optimiser's step, every op dispatched from
    the host (the training path before training units)."""
    from terra_tpu_torch.checkpoint import tree_leaves

    spp = spp or opts.samples_per_pixel
    loss_fn = optim.make_loss_fn(cam, opts, target, spp)

    def step(state, scene, key):
        params, opt = optim._start(state, optimizer)
        loss, grads = optim.value_and_grad(loss_fn, params, scene, key, state.step * spp)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        opt.step()
        return optim.TrainState(params, opt, state.step + 1), loss

    return step


def _eager_train():
    """``recover`` on eager steps: ``make_train_step`` replaced by
    :func:`_eager_step` for the block."""
    from terra_tpu_torch import optim

    return mock.patch.object(optim, "make_train_step",
                             lambda cam, opts, target, optimizer, spp=None:
                             _eager_step(optim, cam, opts, target, optimizer, spp))


def _eager_units():
    """The sharded steps' bodies run on the card uncaptured, op by op, for
    the block (``graphs.train_unit`` hands back the body)."""
    from terra_tpu_torch import graphs

    return mock.patch.object(graphs, "train_unit",
                             lambda owners, key, make_body, moving=(), watch=(): make_body())


def _turns(torch, fns: dict, states: dict, scene, key, n: int = 20) -> tuple:
    """Steps in turns E G G E E G, ``n`` a turn: ms/step by CUDA events and
    by the host clock ending in a synchronisation. Returns (event ms, host
    ms, each a dict of lists by kind)."""
    ev, host = collections.defaultdict(list), collections.defaultdict(list)
    for kind in ("eager", "graph", "graph", "eager", "eager", "graph"):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        st = states[kind]
        for _ in range(n):
            st, _ = fns[kind](st, scene, key)
        b.record()
        torch.cuda.synchronize()
        host[kind].append((time.perf_counter() - t0) / n * 1e3)
        ev[kind].append(a.elapsed_time(b) / n)
        states[kind] = st
    return dict(ev), dict(host)


def _phase10ab(torch, ttt, dev):
    """Phases 10a and 10b: config 4's graphed step. 10a, by brute force:
    the first step's loss and gradient against ``value_and_grad`` at the
    same state and offset (bit for bit), 20 more steps on each side with
    the same Adam (parameters bit for bit, else max rel within 1e-6), and
    ms/step graphed against eager in turns (E G G E E G, 20 steps a turn,
    medians of 3). 10b, on SAH and LBVH trees: BVH4 launches of one replay
    against one eager step's, the albedo gradient of the graphed step
    against brute force (1e-3) and a central difference (0.05), and two
    replays from the same parameters and offset bit for bit. Returns
    (launches of the main path, results)."""
    from terra_tpu_torch import graphs, optim
    from terra_tpu_torch.profile import kernel_launches

    adam = functools.partial(torch.optim.Adam, lr=3e-2)
    launches = collections.Counter()
    failed = []
    graphs.clear()
    scene, cam, opts, target, key = _config4(torch, ttt, dev)
    p0 = optim.extract_params(scene, ("attrs",))
    step = optim.make_train_step(cam, opts, target, adam)
    kernel_launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg, loss_g = step(optim.TrainState(p0, None, 0), scene, key)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches.update(kernel_launches)
    grad_g = sg.params["attrs"].grad.clone()
    loss_e, (grad_e,) = optim.value_and_grad(optim.make_loss_fn(cam, opts, target),
                                             optim._trainable(p0), scene, key, 0)
    bits1 = _same_bits(loss_g, loss_e) and _same_bits(grad_g, grad_e)
    estep = _eager_step(optim, cam, opts, target, adam)
    se, _ = estep(optim.TrainState(p0, None, 0), scene, key)
    for _ in range(20):
        sg, _ = step(sg, scene, key)
        se, _ = estep(se, scene, key)
    pg, pe = sg.params["attrs"].detach(), se.params["attrs"].detach()
    bits20 = _same_bits(pg, pe)
    rel20 = float((pg - pe).abs().max() / pe.abs().max())
    ev, host = _turns(torch, {"eager": estep, "graph": step}, {"eager": se, "graph": sg}, scene,
                      key)
    unit = graphs.units()[-1]
    med = {k: float(np.median(v)) for k, v in ev.items()}
    med_host = {k: float(np.median(v)) for k, v in host.items()}
    print(f"phase 10a: config 4 (brute force, 32x32x8spp, Adam 3e-2 on attrs) graphed step: "
          f"first step's loss and gradient bit-equal to value_and_grad {bits1}; after 21 steps "
          f"each the parameters bit-equal to the eager step's {bits20} (max rel {rel20:.3e}, "
          f"gate 1e-6); {med['graph']:.3f} ms/step graphed against {med['eager']:.3f} eager "
          f"(CUDA events, medians of 3 turns of 20: graph {[round(x, 3) for x in ev['graph']]}, "
          f"eager {[round(x, 3) for x in ev['eager']]}), eager / graph "
          f"{med['eager'] / med['graph']:.2f}; host clock {med_host['graph']:.3f} against "
          f"{med_host['eager']:.3f} ms/step; first step {first_s:.3f} s (warm-up "
          f"{unit['warmup_s']:.3f} s, capture {unit['capture_s']:.3f} s); pool "
          f"{unit['pool_bytes'] / 2**20:.1f} MiB; replays {unit['replays']}; stages "
          f"{list(unit['launches'])}", flush=True)
    if not bits1 or not (bits20 or rel20 <= 1e-6):
        failed.append("10a bits")
    out = {"10a": {"graph_ms": med["graph"], "eager_ms": med["eager"], "turns": ev,
                   "host_ms": med_host, "first_s": first_s, "warmup_s": unit["warmup_s"],
                   "capture_s": unit["capture_s"], "pool_bytes": unit["pool_bytes"],
                   "bits_first": bits1, "bits_20": bits20, "rel_20": rel20}}
    _, (g_brute,) = _grad(torch, optim, scene, cam, opts, target, key)
    for builder in ("sah", "lbvh"):
        bscene, bcam, bopts, btarget, bkey = _config4(torch, ttt, dev, ttt.Accelerator.BVH,
                                                      builder)
        bp0 = optim.extract_params(bscene, ("attrs",))
        bstep = optim.make_train_step(bcam, bopts, btarget, adam)
        kernel_launches.clear()
        st, _ = bstep(optim.TrainState(bp0, None, 0), bscene, bkey)  # warm-up, capture, replay
        torch.cuda.synchronize()
        launches.update(kernel_launches)
        g1 = st.params["attrs"].grad.clone()
        ga, gb = g1[0, 0].double(), g_brute[0, 0].double()
        rel = float((ga - gb).abs().max() / gb.abs().max())
        kernel_launches.clear()
        st, _ = bstep(st, bscene, bkey)  # a replay
        torch.cuda.synchronize()
        l_replay = (kernel_launches["binary"], kernel_launches["bvh4"])
        launches.update(kernel_launches)
        kernel_launches.clear()
        optim.value_and_grad(optim.make_loss_fn(bcam, bopts, btarget),
                             optim._trainable(bp0), bscene, bkey, 8)
        torch.cuda.synchronize()
        l_eager = (kernel_launches["binary"], kernel_launches["bvh4"])
        # a replay from the first step's parameters and offset again
        with torch.no_grad():
            st.params["attrs"].copy_(bp0["attrs"])
        kernel_launches.clear()
        st, _ = bstep(optim.TrainState(st.params, st.opt_state, 0), bscene, bkey)
        launches.update(kernel_launches)
        replay_bits = _same_bits(st.params["attrs"].grad, g1)

        def f(x):
            attrs = bscene.materials.attrs.clone()
            attrs[0, 0, :] = x
            with torch.no_grad():
                img = optim.render_mean_image(optim.inject_params(bscene, {"attrs": attrs}),
                                              bcam, bopts, bkey, 0, 8)
            return float(torch.mean((img - 0.5 * btarget) ** 2))

        attrs = bscene.materials.attrs.clone()
        attrs[0, 0, :] = 0.73
        kernel_launches.clear()
        fst, _ = optim.make_train_step(bcam, bopts, 0.5 * btarget, adam)(
            optim.TrainState({"attrs": attrs}, None, 0), bscene, bkey)
        torch.cuda.synchronize()
        launches.update(kernel_launches)
        g = float(fst.params["attrs"].grad[0, 0].sum())
        fd = (f(0.73 + 1e-2) - f(0.73 - 1e-2)) / 2e-2
        fd_rel = abs(g - fd) / max(abs(fd), 1e-3)
        print(f"phase 10b: config 4 on a BVH scene ({builder}): launches of one replay "
              f"(binary, bvh4) {l_replay}, of one eager value_and_grad {l_eager}; albedo "
              f"gradient of the graphed step {ga.cpu().numpy()} vs brute force "
              f"{gb.cpu().numpy()}: max rel {rel:.3e} (gate 1e-3); d loss / d albedo {g:.6e} vs "
              f"central difference {fd:.6e}: rel {fd_rel:.3e} (gate 0.05); two replays from "
              f"the same parameters and offset give the same gradient bits {replay_bits}",
              flush=True)
        if l_replay != l_eager or l_replay[1] <= 0 or rel > 1e-3 or fd_rel > 0.05 or \
                not replay_bits:
            failed.append(f"10b {builder}")
        out[f"10b/{builder}"] = {"launches_replay": l_replay, "launches_eager": l_eager,
                                 "rel_vs_brute": rel, "fd_rel": fd_rel,
                                 "replay_bits": replay_bits}
    graphs.clear()
    if failed:
        raise AssertionError(f"phase 10a/10b failed: {failed}")
    return launches, out


def _phase10c(torch, ttt, pt, scene, cam, eager, side=384):
    """Phase 10c: phase 6c's ``recover`` (the courtyard at 3b's size, Adam
    steps at 3e-2 on attrs, textures and positions, a refit each step)
    through the graphed step, for 5 steps: 6c's 4 and one whose
    backward replays under the profiler. Gates: one capture over the run;
    the first 4 losses bit-equal to 6c's eager run step by step (else the
    first differing step and max rel, within the twin budget 2e-3); the tables
    the last replay packed, and the BVH4 kernel's hits on its first batch
    of rays (kept from the capture: their memory stays theirs, so they hold
    the last replay's values), equal to tables freshly packed from a
    fresh refit to the positions of the step before and the kernel's hits
    on them. Timing: ms/step (host clock ending in a synchronisation), the
    graphs' stages by CUDA events, the refit; peak memory, pool bytes.
    Returns (launches of the main path, results)."""
    from terra_tpu_torch import graphs, optim
    from terra_tpu_torch.accel import lbvh
    from terra_tpu_torch.ops import rng
    from terra_tpu_torch.profile import kernel_launches

    opts = _opts_6c(ttt).replace(width=side, height=side)
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, opts, rng.key_from_seed(7), 0, 8)
    start = _start_6c(torch, optim, scene)
    graphs.clear()
    captures, seen, refits, stage_ev, step_ms, refit_ms, profiled = [], {}, [], [], [], [], []
    real_init, real_replay = graphs.TrainUnit.__init__, graphs.TrainUnit.replay
    real_tp, real_refit, real_mts = pt.traverse_packed, lbvh.refit_, optim.make_train_step

    def init(self, body, device):
        real_init(self, body, device)
        captures.append(self)  # its numbers outlive the run's optimiser

    def replay(self, stage):
        if stage == "backward" and sum(e[0] == stage for e in stage_ev) == 4:
            # the fifth step's backward under the profiler, outside the timings
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = real_replay(self, stage)
                torch.cuda.synchronize()
            profiled.extend(sorted(
                ((_short(e.key), e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages() if e.self_device_time_total > 0),
                key=lambda r: -r[1]))
            return out
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_replay(self, stage)
        b.record()
        stage_ev.append((stage, a, b))
        return out

    def spy(tables, o, d, t_max=None, any_hit=False, algo="mt", count_steps=False, start=None):
        out = real_tp(tables, o, d, t_max, any_hit, algo, count_steps, start)
        if not seen and torch.cuda.is_current_stream_capturing():
            seen.update(tables=tables, o=o, d=d, t_max=t_max, any_hit=any_hit, algo=algo,
                        out=out)
        return out

    def refit_(bvh, geometry):
        refits.append(geometry.positions.detach().clone())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real_refit(bvh, geometry)
        torch.cuda.synchronize()
        refit_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    def make_train_step(*a, **k):
        step = real_mts(*a, **k)

        def timed(*sa):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = step(*sa)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return r

        return timed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_launches.clear()
    with mock.patch.object(graphs.TrainUnit, "__init__", init), \
            mock.patch.object(graphs.TrainUnit, "replay", replay), \
            mock.patch.object(pt, "traverse_packed", spy), \
            mock.patch.object(lbvh, "refit_", refit_), \
            mock.patch.object(optim, "make_train_step", make_train_step):
        recovered, losses = optim.recover(start, cam, opts, target, fields=FIELDS_6C, steps=5,
                                          learning_rate=3e-2, seed=7)
        torch.cuda.synchronize()
    unit = captures[0].describe()
    step_ms, refit_ms = step_ms[:4], refit_ms[:4]
    launches = kernel_launches.copy()
    peak = torch.cuda.max_memory_allocated()
    by_step = collections.defaultdict(list)
    for stage, a, b in stage_ev:
        by_step[stage].append(a.elapsed_time(b))
    per_stage = {k: float(np.mean(v)) for k, v in by_step.items()}
    # the last forward read the positions and boxes of the refit after step 4
    geom = dataclasses.replace(start.geometry, positions=refits[3])
    fresh = pt.pack_tables_auto(lbvh.refit(start.bvh, geom),
                                *[c.detach() for c in geom.corners()])
    tables_equal = all(
        (torch.equal(getattr(seen["tables"], f.name), getattr(fresh, f.name))
         if isinstance(getattr(fresh, f.name), torch.Tensor)
         else getattr(seen["tables"], f.name) == getattr(fresh, f.name))
        for f in dataclasses.fields(fresh))
    t_new, i_new = real_tp(fresh, seen["o"], seen["d"], seen["t_max"], seen["any_hit"],
                           seen["algo"])
    hits_equal = _same_bits(t_new, seen["out"][0]) and torch.equal(i_new, seen["out"][1])
    moved = not torch.equal(fresh.slots, pt.pack_tables_auto(
        start.bvh, *[c.detach() for c in start.geometry.corners()]).slots)
    same_steps = [a == b for a, b in zip(losses[:4], eager["losses"])]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[:4], eager["losses"]))
    first_diff = same_steps.index(False) if not all(same_steps) else None
    print(f"phase 10c: recover on the courtyard through the graphed step ({side}x{side}x8spp, "
          f"fields {FIELDS_6C}, 5 Adam steps, a refit a step): captures {len(captures)} "
          f"({[u.label for u in captures]}); losses {[f'{x:.6e}' for x in losses]}, the first 4 "
          f"bit-equal to 6c's eager run step by step {same_steps} (first differing step "
          f"{first_diff}, max rel {rel:.3e}); "
          f"the last replay's tables equal a fresh pack of a fresh refit {tables_equal}; BVH4 "
          f"hits on its first batch ({seen['o'].shape[0]} rays) equal the fresh tables' "
          f"{hits_equal}; those tables differ from the start's {moved}", flush=True)
    print(f"  ms/step (host clock) {[round(x, 1) for x in step_ms]} (step 0 warms up and "
          f"captures: warm-up {unit['warmup_s']:.3f} s, capture {unit['capture_s']:.3f} s); "
          f"inside the graphs per step (CUDA events, mean over the replays timed) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in per_stage.items())
          + f"; refit {[round(x, 1) for x in refit_ms]} ms; 6c's eager step "
          f"{eager['ms_per_step']:.1f} ms (forward {np.mean(eager['forward_ms']):.1f}, "
          f"backward {np.mean(eager['backward_ms']):.1f}, Adam {np.mean(eager['adam_ms']):.2f} ms "
          f"a step); peak memory {peak / 2**30:.2f} GiB beside a pool of "
          f"{unit['pool_bytes'] / 2**30:.2f} GiB (6c eager peak {eager['peak_gib']:.2f} GiB); "
          f"launches binary {launches['binary']} bvh4 {launches['bvh4']} row_accumulate "
          f"{launches['row_accumulate']}; stage launches {unit['launches']}", flush=True)
    busy = sum(r[1] for r in profiled)
    print(f"  the fifth step's backward under the profiler: {sum(r[2] for r in profiled)} "
          f"kernels, {busy:.1f} ms of kernel time; by name:", flush=True)
    for name, ms, count in profiled[:12]:
        print(f"    {ms:8.2f} ms  x{count:<6d} {name[:120]}", flush=True)
    # a replay records no op shapes: the attribution by table takes an eager
    # backward at the recovered state (same ops, same kernels)
    from terra_tpu_torch.scripts import backward_profile

    by_shape = backward_profile.profile_backward(
        optim.make_loss_fn(cam, opts, target),
        optim._trainable(optim.extract_params(recovered, FIELDS_6C)), recovered,
        rng.key_from_seed(7), 0)
    print(f"  an eager backward at the recovered state: {by_shape['backward_ms']:.1f} ms (host "
          f"clock)", flush=True)
    backward_profile.print_profile(by_shape, indent="    ")
    ok = len(captures) == 1 and tables_equal and hits_equal and moved and \
        (all(same_steps) or rel <= 2e-3) and all(np.isfinite(losses)) and \
        launches["row_accumulate"] > 0 and unit["launches"]["backward"].get("row_accumulate", 0) > 0
    if not ok:
        raise AssertionError("phase 10c failed a gate")
    captures.clear()
    graphs.clear()
    return launches, {"losses": losses, "bit_equal_steps": same_steps, "max_rel": rel,
                      "step_ms": step_ms, "stage_ms": dict(per_stage),
                      "stage_ms_by_step": dict(by_step), "refit_ms": refit_ms,
                      "peak_gib": peak / 2**30, "pool_bytes": unit["pool_bytes"],
                      "warmup_s": unit["warmup_s"], "capture_s": unit["capture_s"],
                      "backward_kernels": profiled[:12], "by_shape": by_shape}


def _phase10e(torch, ttt, dev):
    """Phase 10e: a host read planted in the loss (``float`` of the forward
    stage's output) must make the capture of config 4's step raise, naming
    the stage; no unit is kept and nothing falls back."""
    from terra_tpu_torch import graphs, optim

    scene, cam, opts, target, key = _config4(torch, ttt, dev)
    real = optim._StepBody._run

    def reading(self, stage):
        out = real(self, stage)
        if stage == "forward":
            float(out)
        return out

    graphs.clear()
    with mock.patch.object(optim._StepBody, "_run", reading):
        try:
            optim.make_train_step(cam, opts, target, functools.partial(torch.optim.Adam, lr=3e-2))(
                optim.TrainState(optim.extract_params(scene, ("attrs",)), None, 0), scene, key)
            raised = "nothing"
        except RuntimeError as e:
            raised = str(e).splitlines()[0][:200]
    print(f"phase 10e: config 4's step with a host read in the loss: raised: {raised}; units "
          f"kept {len(graphs.units())}", flush=True)
    if "synchroniz" not in raised or "'forward'" not in raised or graphs.units():
        raise AssertionError("a host read in the loss did not make the capture raise")
    return raised


def _phase10f(torch, ttt, scene, cam):
    """Phase 10f: the small-table fetches by one-hot product
    (``ops/onehot.py``). The TF32 gate: with ``allow_tf32`` set and
    ``set_float32_matmul_precision("high")``, ``surface.fetch_rows`` and
    ``distributions._oh_pick`` on the courtyard's material (4 x 29) and
    light (4 x 30) tables and a random 512 x 26 table, at 6c's lanes (ids
    in range, seeded), equal the plain gather word for word (its -0.0 read
    as +0.0, ``table[idx] + 0.0``, the product's one difference), and the
    gradients of sum(w * fetch) equal those taken with the flags off; the
    unguarded product under the same flags is counted beside them (the
    words TF32 would move); the flags are restored after. Each fetch and
    its backward timed beside the gather and its index accumulate (CUDA
    events, deterministic mode). The reproducibility gate: phase 6c's
    graphed step from its start, twice from the same state (the update
    replay skipped, so the parameters stay): gradients bit-equal to each
    other and to ``value_and_grad``'s at that state. Returns (launches of
    the main path, results)."""
    import warnings

    from terra_tpu_torch import graphs, optim, surface
    from terra_tpu_torch.ops import distributions, onehot, rng
    from terra_tpu_torch.profile import kernel_launches

    dev = scene.geometry.positions.device
    n = 384 * 384 * 8
    gen = torch.Generator(device=dev).manual_seed(5)
    shade = surface.build_shade_tables(scene)
    tables = {"material": shade.mat.detach(), "light": shade.light.detach(),
              "random 512x26": torch.randn(512, 26, device=dev, generator=gen)}
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    rows, ok = {}, True
    for label, table in tables.items():
        idx = torch.randint(0, table.shape[0], (n,), device=dev, generator=gen)
        w = torch.randn(n, table.shape[1], device=dev, generator=gen)
        plain = table[idx] + 0.0

        def grad(fetch):
            t = table.clone().requires_grad_(True)
            with optim.deterministic():
                (g,) = torch.autograd.grad(torch.sum(w * fetch(t, idx)), [t])
            return g

        fetches = {"fetch_rows": surface.fetch_rows, "_oh_pick": distributions._oh_pick}
        grads_off = {k: grad(f) for k, f in fetches.items()}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            oh = onehot.one_hot(idx, table.shape[0])
            unguarded = _tensor_words(torch, oh @ table, plain)
            words = {k: _tensor_words(torch, f(table, idx), plain) for k, f in fetches.items()}
            grad_words = {k: _tensor_words(torch, grad(f), grads_off[k]) for k, f in fetches.items()}
            flags_on = (torch.backends.cuda.matmul.allow_tf32,
                        torch.get_float32_matmul_precision())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.set_float32_matmul_precision(prev[1])
        g = torch.randn(n, table.shape[1], device=dev, generator=gen)

        def product_backward():
            with onehot.full_f32():
                return oh.mT @ g

        with optim.deterministic():
            times = {
                "product": _ms(lambda: surface.fetch_rows(table, idx), 20),
                "gather": _ms(lambda: table[idx], 20),
                "product backward": _ms(product_backward, 20),
                "index accumulate": _ms(lambda: torch.zeros_like(table).index_put_(
                    (idx,), g, accumulate=True), 5),
            }
        rows[label] = {"words": words, "grad_words": grad_words, "unguarded_words": unguarded,
                       "ms": times}
        ok &= not any(words.values()) and not any(grad_words.values())
        print(f"phase 10f: {label} table {tuple(table.shape)}, {n} lanes, flags on "
              f"{flags_on}: words differing from the plain gather {words}, gradient words "
              f"differing from the flags-off gradient {grad_words}; the unguarded product "
              f"under the flags {unguarded} words; ms (CUDA events) "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    restored = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision()) == prev
    # two graphed steps from the same state, and value_and_grad there
    opts = _opts_6c(ttt)
    key = rng.key_from_seed(7)
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, opts, key, 0, 8)
    start = _start_6c(torch, optim, scene)
    grads, real = [], graphs.TrainUnit.replay

    def replay(self, stage):
        if stage == "update":
            return None
        out = real(self, stage)
        if stage == "backward":
            grads.append([x.detach().clone() for x in out])
        return out

    graphs.clear()
    step = optim.make_train_step(cam, opts, target, functools.partial(torch.optim.Adam, lr=3e-2))
    kernel_launches.clear()
    with mock.patch.object(graphs.TrainUnit, "replay", replay), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s1, loss1 = step(optim.TrainState(optim.extract_params(start, FIELDS_6C), None, 0),
                         start, key)
        _, loss2 = step(optim.TrainState(s1.params, s1.opt_state, 0), start, key)
        torch.cuda.synchronize()
        launches = kernel_launches.copy()
        loss_e, grads_e = optim.value_and_grad(
            optim.make_loss_fn(cam, opts, target),
            optim._trainable(optim.extract_params(start, FIELDS_6C)), start, key, 0)
    captured = len(graphs.units())
    same = [all(_same_bits(a, b) for a, b in zip(grads[0], other)) for other in (grads[1], grads_e)]
    same_loss = _same_bits(loss1, loss2) and _same_bits(loss1, loss_e)
    notes = sorted({str(w.message).split(".")[0][:160] for w in caught})
    print(f"phase 10f: the flags restored {restored}; phase 6c's graphed step twice from its "
          f"start (CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}): units "
          f"{captured}, losses {float(loss1):.6e} {float(loss2):.6e}, gradients bit-equal to each "
          f"other {same[0]}, to value_and_grad's {same[1]}, losses equal {same_loss}; launches "
          f"binary {launches['binary']} bvh4 {launches['bvh4']}; warnings {notes}", flush=True)
    graphs.clear()
    if not (ok and restored and all(same) and same_loss and captured == 1):
        raise AssertionError("phase 10f failed a gate")
    return launches, {"tables": rows, "bit_equal": same, "warnings": notes}


def _fetch_ab(torch, ttt, cells, dev):
    """Phase 10f's A/B: each cell's graphed render, and config 4's graphed
    step (``_config4``), with the one-hot fetches and with them patched to
    the gathers the port used before (``fetch_rows``, ``_oh_pick``,
    ``_oh_at``), in turns (P G G P), each turn captured anew. A render:
    host-clock median of 3, the kernel time of one more under the
    profiler, its unit's pool bytes and one render's peak allocation above
    what the process held before it; films must be equal word for word.
    The step: host-clock median of 10 after the capturing one, pool bytes
    and one step's peak above the base. Returns {cell: {variant: [row per
    turn]}}."""
    from terra_tpu_torch import graphs, lights, optim, surface
    from terra_tpu_torch.ops import distributions

    def gather(table, idx):
        return table[idx.long()]

    def at(rows, idx):
        return torch.take_along_dim(rows, idx.long()[..., None], -1)[..., 0]

    def timed(fn):
        """(seconds, result, peak bytes above the base) of ``fn()``."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, r, torch.cuda.max_memory_allocated() - base

    gathers = {(surface, "fetch_rows"): gather, (lights, "fetch_rows"): gather,
               (distributions, "_oh_pick"): gather, (distributions, "_oh_at"): at}
    c4 = _config4(torch, ttt, dev)
    labels = [c[0] for c in cells] + ["config 4 step"]
    out = {label: {"product": [], "gather": []} for label in labels}
    films = {}
    for turn in ("product", "gather", "gather", "product"):
        graphs.clear()
        with contextlib.ExitStack() as stack:
            if turn == "gather":
                for (mod, name), fn in gathers.items():
                    stack.enter_context(mock.patch.object(mod, name, fn))
            for label, scene, cam, opts in cells:
                def render():
                    return ttt.render(scene, cam, opts, seed=0)

                films[(label, turn)] = render().acc.clone()  # captures
                secs = float(np.median([timed(render)[0] for _ in range(3)]))
                peak = timed(render)[2]
                pool = graphs.units()[-1]["pool_bytes"]
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    render()
                    torch.cuda.synchronize()
                busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
                out[label][turn].append({"s": secs, "kernel_ms": busy, "pool_bytes": pool,
                                         "peak_bytes": peak})
            scene4, cam4, opts4, target4, key4 = c4
            step = optim.make_train_step(cam4, opts4, target4,
                                         functools.partial(torch.optim.Adam, lr=3e-2))
            state = step(optim.TrainState(optim.extract_params(scene4, ("attrs",)), None, 0),
                         scene4, key4)[0]
            ms = [timed(lambda: step(state, scene4, key4))[0] * 1e3 for _ in range(10)]
            peak = timed(lambda: step(state, scene4, key4))[2]
            out["config 4 step"][turn].append({"ms": float(np.median(ms)), "peak_bytes": peak,
                                               "pool_bytes": graphs.units()[-1]["pool_bytes"]})
    graphs.clear()
    mib = 2**20
    for label in labels:
        rows = {v: [", ".join(f"{k} {x / mib:.1f} MiB" if k.endswith("bytes") else f"{k} {x:.4f}"
                              for k, x in r.items()) for r in out[label][v]] for v in out[label]}
        w = _tensor_words(torch, films[(label, "product")], films[(label, "gather")]) \
            if (label, "product") in films else 0
        print(f"phase 10f: {label} graphed, one-hot fetches against gathers in turns (P G G P): "
              f"product {rows['product']}; gather {rows['gather']}"
              + ("" if label == "config 4 step" else f"; films differ in {w} words"), flush=True)
        if w:
            raise AssertionError(f"phase 10f: the {label} film depends on the fetch")
    return out


TWIN_TABLES = {
    "binary": lambda pt: pt.pack_tables,
    "f32": lambda pt: lambda bvh, *c: pt.pack_tables_wide(bvh, *c, box_enc="f32"),
    "bf16": lambda pt: lambda bvh, *c: pt.pack_tables_wide(bvh, *c, box_enc="bf16"),
    "paged4": lambda pt: lambda bvh, *c: pt.pack_tables_paged(bvh, *c, resident_cap=4),
}


# --- phase 11: the port's bench.py ------------------------------------------

BENCH_METRICS = ("cornell_fwd_mrays_per_chip", "cornell_ggx_mis_mrays", "courtyard_bvh_mrays",
                 "courtyard_incoherent_mrays", "courtyard_bounce_mrays", "courtyard_render_mrays",
                 "mega_bvh_mrays", "inverse_step_ms")
BENCH_GATES = ("kernel gate ok", "wide-kernel gate ok")


def _phase11(timeout: float = 900.0) -> tuple:
    """Phase 11: ``python -m terra_tpu_torch.bench`` in a subprocess, its
    lines printed. It must exit 0 with one line of each metric, each value
    finite and positive, no error line, and both kernel gates' OK lines on
    its standard error. Returns (launches {"binary", "bvh4"} summed over
    the lines, {metric: line}, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "terra_tpu_torch.bench"], cwd=root,
                          env=_cli_env(os.path.expanduser("~")), capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        print(f"  bench: {line}", flush=True)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    for line in lines:
        print(f"  {json.dumps(line)}", flush=True)
    metrics = {x["metric"]: x for x in lines if x["unit"] != "error"}
    errors = [x for x in lines if x["unit"] == "error"]
    gates = [g for g in BENCH_GATES if any(x.strip().startswith(g)
                                           for x in proc.stderr.splitlines())]
    bad = [m for m, x in metrics.items() if not (np.isfinite(x["value"]) and x["value"] > 0)]
    print(f"phase 11: python -m terra_tpu_torch.bench exited {proc.returncode} after "
          f"{seconds:.1f} s; {len(metrics)} metric lines, {len(errors)} error lines, gates ok "
          f"{gates}", flush=True)
    if proc.returncode != 0 or errors or sorted(metrics) != sorted(BENCH_METRICS) or bad or \
            len(lines) != len(BENCH_METRICS) or list(gates) != list(BENCH_GATES):
        raise AssertionError(f"phase 11: the bench failed (exit {proc.returncode}, errors "
                             f"{errors}, metrics {sorted(metrics)}, not finite and positive "
                             f"{bad}, gates {gates})")
    launches = collections.Counter()
    for x in metrics.values():
        launches.update(binary=x["launches"]["bvh_traverse"], bvh4=x["launches"]["bvh4_traverse"])
    return launches, metrics, seconds


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")

    from terra_tpu_torch.profile import card, kernel_launches

    # 0. the card
    smi = card()
    print(smi, flush=True)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import terra_tpu_torch as ttt  # sets CUBLAS_WORKSPACE_CONFIG before any cuBLAS call
    print(f"phase 0: CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}",
          flush=True)
    from terra_tpu_torch import _build, graphs, intersect, native, probes
    from terra_tpu_torch.accel import lbvh, traverse
    from terra_tpu_torch.accel import pallas_traverse as pt
    from terra_tpu_torch.ops import rng, row_accumulate
    from terra_tpu_torch.scripts import compact_bench

    # 1. builds, all started together
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # the traversal kernels also with a 64-entry stack, for phase 2c's A/B
    with ThreadPoolExecutor(8) as ex:
        futs = {name: ex.submit(timed, fn) for name, fn in
                (("bvh_traverse", pt.load_kernel), ("bvh4_traverse", pt.load_kernel4),
                 ("bvh_traverse cap 64", functools.partial(pt.load_kernel, 64)),
                 ("bvh4_traverse cap 64", functools.partial(pt.load_kernel4, 64)),
                 ("pattern_probes", probes.load_kernel), ("threefry", rng.load_kernel),
                 ("row_accumulate", row_accumulate.load_kernel),
                 ("bvh_refit", lbvh.load_kernel), ("sweep", intersect.load_kernel),
                 ("terra_native", native.load))}
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
            ("pattern_probes", probes.kernel_path(), "one per site"),
            ("threefry", rng.kernel_path(), "stream pairs a launch"),
            ("row_accumulate", row_accumulate.kernel_path(), "one level a launch"),
            ("bvh_refit", lbvh.kernel_path(), "parents, then the walk up"),
            ("sweep", intersect.kernel_path(), "ALGO, HAS_TMAX"))}
    footprint64 = {
        name: _print_footprints(f"{name} (cap 64)", _build.build_log(path(64)), "64-entry stack")
        for name, path in (("bvh_traverse", pt.kernel_path), ("bvh4_traverse", pt.kernel4_path))}
    _sass_check(probes, probes.kernel_path())

    # 1b. the threefry kernel at the benchmark cells' bounce batches
    threefry_rows = _phase1b(torch)

    # 1c. the row-accumulate kernel at the training cell's tables
    accumulate_rows = _phase1c(torch)

    # 1d. the refit kernel on the courtyard's trees
    refit_rows = _phase1d(torch, ttt)

    # 1e. the sweep kernel at the Cornell pass's raycast
    sweep_rows = _phase1e(torch, ttt)

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
        kernel_ms = _ms(lambda: pt.raycast_cuda(tables, o, d, tm, any_hit, algo), 20)
        plain_ms = _ms(lambda: pt.raycast_plain(tables, o, d, tm, any_hit, algo), 1)
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
    render_3b_s, counts, film_3b = _render(torch, ttt, pt, scene, cam, opts, "courtyard")
    main_launches.update(counts)

    # 3m. the 1M-triangle path (config 3m): dir3-sorted rays, as the bench
    print(f"phase 3m: config 3m, wide_mode {pt.wide_mode(mega.bvh)}", flush=True)
    packed = pt.pack_tables_wide(mega.bvh, *mega.geometry.corners(), box_enc="bf16")
    o_u, d_u = _camera_rays(torch, cam, 1024, dev)
    sort_ms = _ms(lambda: traverse.sort_order(mega.bvh, o_u, d_u, "dir3"), 20)
    order = traverse.sort_order(mega.bvh, o_u, d_u, "dir3")
    o_m, d_m = o_u[order].contiguous(), d_u[order].contiguous()
    kernel_launches.clear()
    bt, bi = pt.traverse_packed(packed, o_m, d_m)
    torch.cuda.synchronize()
    main_launches.update(kernel_launches)
    tp_ms = _ms(lambda: pt.traverse_packed(packed, o_m, d_m), 20)
    c = pt.count_decode(pt.traverse_packed(packed, o_m, d_m, count_steps=True)[2])
    hits = int((bt < intersect.T_FAR).sum())
    print(f"  dir3 sort of 2^20 camera rays (keys + stable argsort): {sort_ms:.3f} ms", flush=True)
    print(f"  traverse_packed bf16, 2^20 camera rays (dir3-sorted): {tp_ms:.3f} ms "
          f"({o_m.shape[0] / tp_ms / 1e3:.1f} Mrays/s), hits {hits}; counters: iters "
          f"{int(c['iters'].sum())} pops {int(c['pops'].sum())} leaf tests "
          f"{int(c['leaves'].sum())} paged {int(c['paged'].sum())}", flush=True)
    ut, ui = pt.traverse_packed(packed, o_u, d_u)
    tu_ms = _ms(lambda: pt.traverse_packed(packed, o_u, d_u), 20)
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
    _, counts, _ = _render(torch, ttt, pt, mega, cam, opts, "courtyard_1m")
    main_launches.update(counts)
    if pt.wide_mode(mega.bvh) is not None and counts["bvh4"] <= 0:
        raise AssertionError("the 1M render did not launch the BVH4 kernel")
    _stage_ab(torch, mega, cam, opts)

    # 3g. the full-material render at bench config 2's width (bench.py:202-219,
    # spp cut from 256 to 16), then the courtyard under a constant sky
    print("phase 3g: config 3g (Cornell box, Phong walls, glass block)", flush=True)
    _, counts, _ = _render(torch, ttt, pt, g_scene, g_cam, g_opts, "cornell_3g",
                           check_unsorted=False)
    main_launches.update(counts)
    sky = dataclasses.replace(scene, env_value=torch.tensor([0.5, 0.6, 0.8], device=dev))
    s_opts = opts.replace(integrator=ttt.Integrator.DIRECT_MIS, env_on_miss=True, env_nee=True)
    _, counts, _ = _render(torch, ttt, pt, sky, cam, s_opts, "courtyard_sky",
                           check_unsorted=False)
    main_launches.update(counts)

    # 3c. the compacted two-phase traversal (compact_bench's workload)
    print("phase 3c: compact_bench --M 128 256 (1M courtyard, 2^20 dir3-sorted camera rays)",
          flush=True)
    kernel_launches.clear()
    bench = compact_bench.main(["--M", "128", "256"])
    main_launches.update(kernel_launches)
    for m, row in bench["M"].items():
        print(f"  M={m}: F={row['F']}, rounds {row['rounds']}, compact {row['compact_s']:.4f} s "
              f"vs classic {bench['classic_s']:.4f} s (host clock, least of 3), hit-mask "
              f"mismatches {row['hit_mismatch']}, same-tri {row['same_tri']:.6f}; in turns "
              f"(E G G E E G, medians of 3) eager {row['eager_median_s']:.4f} s, graphed "
              f"{row['graphed_median_s']:.4f} s; phase 1 {row['phase1_s']:.4f} s; captures "
              f"{row['captures']} (a later call {row['captures_again']}), replays per call "
              f"{row['replays_per_call']}, warm-up {row['warmup_s']:.3f} s, capture "
              f"{row['capture_s']:.3f} s, pool {row['pool_bytes'] / 2**20:.1f} MiB, lanes "
              f"per tail round {row['buckets']}, BVH4 launches per call graphed "
              f"{row['launches_graphed']} eager {row['launches_eager']}, graphed hits vs eager "
              f"{row['eager_words']} words differ", flush=True)
    _bucket_ab(torch, pt, compact_bench, mega, cam, dev)
    gate_launches = _ray_zero_gate(torch, ttt, pt, dev)  # a gate, not the main path
    print(f"  the ray-0 gate's launches (not counted as the main path's): "
          f"{dict(gate_launches)}", flush=True)
    graphs.clear()  # the compaction's pools (several GiB) go before phase 4

    # 4. twins: cpu tensors (plain) vs cuda tensors (kernel), per table kind
    kw = dict(grid=40, columns=8)
    topts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=4, bounces=2,
                              integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    small = {device: ttt.scenes.courtyard(**kw, device=device) for device in ("cpu", "cuda")}
    for kind, packer in TWIN_TABLES.items():
        imgs = []
        graphs.clear()  # contexts and graphs hold the tables of the packer they saw
        with mock.patch.object(pt, "pack_tables_auto", packer(pt)):
            for device in ("cpu", "cuda"):
                t0 = time.perf_counter()
                kernel_launches.clear()
                f = ttt.render(small[device], ttt.scenes.courtyard_camera(device=device), topts,
                               seed=3)
                imgs.append(f.mean().cpu().numpy())
                if device == "cuda":
                    main_launches.update(kernel_launches)
                print(f"phase 4: {kind} tables, small courtyard "
                      f"({small[device].geometry.num_triangles} tris) 32x32x4spp DIRECT on "
                      f"{device}: {time.perf_counter() - t0:.2f} s, mean {imgs[-1].mean():.5f}, "
                      f"launches binary {kernel_launches['binary']} bvh4 "
                      f"{kernel_launches['bvh4']}", flush=True)
        graphs.clear()
        _twin_match(imgs[1], imgs[0])
    main_launches.update(_material_twins(torch, ttt))

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
    launches7, cli_passes = _phase7(torch, ttt, scene, render_3b_s)
    main_launches.update(launches7)

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

    # 9. the launch units as CUDA graphs: graphed renders against eager ones
    launches9, _ = _phase9(torch, ttt, pt, [("3b", scene, cam, opts), ("3m", mega, cam, opts),
                                            ("3g", g_scene, g_cam, g_opts),
                                            ("sky", sky, cam, s_opts)], cli_passes)
    main_launches.update(launches9)

    # 10. the training units as CUDA graphs: config 4's graphed step against
    # eager (10a, 10b), the courtyard recover (10c), a planted host read
    # (10e); the sharded step (10d) ran in phase 8's ranks
    t10 = time.perf_counter()
    launches10, train10 = _phase10ab(torch, ttt, dev)
    main_launches.update(launches10)
    launches10c, train10["10c"] = _phase10c(torch, ttt, pt, scene, cam, inverse["6c"])
    main_launches.update(launches10c)
    _phase10e(torch, ttt, dev)
    launches10f, train10["10f"] = _phase10f(torch, ttt, scene, cam)
    main_launches.update(launches10f)
    train10["10f"]["ab"] = _fetch_ab(torch, ttt, [("3b", scene, cam, opts),
                                                   ("sky", sky, cam, s_opts),
                                                   ("3g", g_scene, g_cam, g_opts)], dev)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s; every capture's warm-up ran under "
          f"torch.cuda.set_sync_debug_mode('error') and deterministic algorithms", flush=True)

    # 11. the port's bench.py, every config, in a process of its own (this
    # process's graph pools and cached blocks go first)
    graphs.clear()
    torch.cuda.empty_cache()
    launches11, bench11, _ = _phase11()
    main_launches.update(launches11)

    print(f"main-path launches: {dict(main_launches)}; probes "
          f"{ {k: v['launches'] for k, v in probe_rows.items()} }", flush=True)
    if any(main_launches[k] <= 0
           for k in ("binary", "bvh4", "threefry", "row_accumulate", "bvh_refit", "sweep")) or \
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
         "bench_launches": {m: x["launches"]["bvh_traverse"] for m, x in bench11.items()},
         "modes": {**{f"{label}/start_links": g["binary"] for label, g in starts.items()},
                   **{f"{label}/camera": v for label, v in binary_camera.items()}}},
        {"name": "bvh4_traverse", "route": "cuda",
         "source": "terra_tpu_torch/csrc/bvh4_traverse.cu",
         "replaces": "terra_tpu/accel/pallas_traverse.py:81",
         "launches": main_launches["bvh4"], "max_abs_err": max_err4,
         "ms": m4["ms"], "plain_ms": m4["plain_ms"], "bound_ms": m4["bound_ms"],
         "bound_by": m4["bound_by"],
         "library_ms": None, "library": walks, **main_path("bvh4_traverse"),
         "bench_launches": {m: x["launches"]["bvh4_traverse"] for m, x in bench11.items()},
         "train_replay_launches": {b: train10[f"10b/{b}"]["launches_replay"][1]
                                   for b in ("sah", "lbvh")},
         "modes": {f"{label}/{mode}": v for label, g in gate4.items() for mode, v in g.items()}},
    ]
    tf = threefry_rows["courtyard.render"]
    kernels.append({"name": "threefry", "route": "cuda",
                    "source": "terra_tpu_torch/csrc/threefry.cu", "replaces": None,
                    "launches": main_launches["threefry"], "max_abs_err": 0.0, "ms": tf["ms"],
                    "plain_ms": tf["plain_ms"], "bound_ms": tf["bound_ms"],
                    "bound_by": tf["bound_by"], "library_ms": None,
                    "library": "no single PyTorch call computes Threefry-2x32",
                    "cells": threefry_rows})
    tri = accumulate_rows["triangles"]
    kernels.append({"name": "row_accumulate", "route": "cuda",
                    "source": "terra_tpu_torch/csrc/row_accumulate.cu", "replaces": None,
                    "launches": main_launches["row_accumulate"], "max_abs_err": 0.0,
                    "ms": tri["ms"], "plain_ms": tri["plain_ms"], "bound_ms": tri["bound_ms"],
                    "bound_by": "bytes", "library_ms": tri["library_ms"],
                    "library": "torch.Tensor.index_put_(accumulate=True), deterministic",
                    "cases": accumulate_rows})
    sah = refit_rows["sah"]
    kernels.append({"name": "bvh_refit", "route": "cuda",
                    "source": "terra_tpu_torch/csrc/bvh_refit.cu", "replaces": None,
                    "launches": main_launches["bvh_refit"], "max_abs_err": 0.0,
                    "ms": sah["ms"], "plain_ms": sah["host_ms"], "bound_ms": sah["bound_ms"],
                    "bound_by": "bytes", "library_ms": None,
                    "library": "no single PyTorch call refits a tree", "trees": refit_rows})
    mt = sweep_rows["mt/closest"]
    kernels.append({"name": "sweep", "route": "cuda",
                    "source": "terra_tpu_torch/csrc/sweep.cu", "replaces": None,
                    "launches": main_launches["sweep"], "max_abs_err": 0.0,
                    "ms": mt["ms"], "plain_ms": mt["grid_ms"], "bound_ms": mt["bound_ms"],
                    "bound_by": mt["bound_by"], "library_ms": None,
                    "library": "no single PyTorch call finds a closest hit", "cases": sweep_rows})
    for name, row in probe_rows.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "terra_tpu_torch/csrc/pattern_probes.cu",
                        "library_ms": None,
                        "library": "no single PyTorch call computes a probe body",
                        **row})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--rank-job" in sys.argv:
        _rank_job(sys.argv[1:])
    else:
        main()
