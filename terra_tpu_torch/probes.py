"""The pattern probes: hand-written CUDA kernels and their plain PyTorch versions.

The reference's probe scripts (``scripts/smem_dma_probe.py``,
``scripts/rowmask_patterns_probe.py``, ``scripts/paged_patterns_probe.py``)
each run tiny Pallas kernels that asked whether Mosaic compiles the
patterns of the paged traversal and the row-masked leaf test: an async
copy into scratch waited on a semaphore (also inside a data-dependent
loop), scalar reads of the staged words, row reductions, row-activity
bits and per-row masked stores. ``csrc/pattern_probes.cu`` asks the same
of Hopper with one kernel per ``pallas_call`` site: a TMA bulk copy into
shared memory completed on an mbarrier, warp reductions, warp votes and
predicated row stores (the source note says how each pattern maps). The
copy-in-a-loop and paged kernels are one warp that streams rows or pages
through a ring of two shared buffers, one mbarrier each, issuing the next
copy inside the loop before the current piece is read and reusing a
buffer behind ``__syncwarp`` and the async-proxy fence. The row-mask and
mask-plane kernels give warp r output row r: its own copy of the row on
its own barrier, its own ballot for the row bit, each output word stored
once. ``hbm_to_smem`` and the i32 loop are one warp and one copy, no
block barrier; the i32 loop's lanes each sum at most four of the staged
words its trip count selects, and a warp reduction adds them. On the H100
every kernel takes 2.0-2.9 us a launch on the device against an empty
kernel's 1.6-1.9 (PERF.md section 6).

Each of the eleven probe bodies has a wrapper here (:data:`BODIES` names
them) and a plain PyTorch version of the same function. A wrapper takes the
plain version for a CPU tensor; for a CUDA tensor it launches the kernel
on the current stream, raises if the launch fails, and never falls back.
:data:`launches` counts kernel launches. Every value involved is an
integer below 2^24 (or 1e9 plus one), exact in f32, so kernel and plain
version agree word for word, on the reference's inputs (:func:`make_input`),
on :data:`SEEDS` seeded random ones (:func:`seeded_input`) and, for the
loop probe, on its trip-count edges (:func:`edge_inputs`).
:func:`run_floor` launches an empty kernel of a probe's launch shape, the
floor its device time is read against; :func:`redesign_rank` orders
kernels by what a redesign could save on the path that launched them;
:func:`sass` reads a built library's machine code.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ._build import build_shared, nvcc

__all__ = ["BODIES", "KERNELS", "Body", "run", "run_plain", "run_floor", "launch", "make_input",
           "seeded_input", "edge_inputs", "load_kernel", "load_library", "kernel_path",
           "redesign_rank", "sass", "parse_sass", "launches", "ROWS", "W", "SEEDS", "LOOP",
           "LOOP_EDGES"]

ROWS, W = 8, 128  # the (8, 128) output block of every probe
SEEDS = 8  # seeded inputs each body is held to (seeds 0 .. SEEDS - 1)
LOOP = "smem_dma/hbm_to_smem_i32_loop"  # the body whose trip count is read from its input
LOOP_EDGES = (-1, 0, 1, 31, 32, 33, 127, 128, 129, 130)  # trip counts of edge_inputs
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "pattern_probes.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Number of probe-kernel launches made through the wrappers.
launches = 0


# ------------------------------------------------------------ plain versions

def _full(value):
    return value.expand(ROWS, W).contiguous()


def _hbm_to_smem_plain(x):
    scr = x[2:4].clone()
    return _full(scr[0, 0] + scr[1, 1] + scr[0, W - 1])


def _i32_loop_plain(x):
    scr = x[0:4].clone()
    acc = x.new_zeros(())
    for i in range(min(int(scr[0, 0]), W)):
        acc = acc + scr[i % 4, i]
    return _full(acc)


def _dma_in_while_plain(x):
    acc = x.new_zeros(())
    for i in range(4):
        scr = x[i:i + 1].clone()
        acc = acc + scr[0, 0]
    return _full(acc)


def _row_store(out, bits, rows):
    """out[r] = rows[r] where bit r of ``bits`` is set (the pl.when stores)."""
    for r in range(ROWS):
        if (bits >> r) & 1:
            out[r] = rows[r]
    return out


def _rowmask_plain(probe: int):
    def body(x):
        scr = x[0:ROWS].clone()
        out = x.new_zeros((ROWS, W))
        if probe == 1:
            return _row_store(out, 0b10100110, scr * 2.0)
        if probe == 2:
            for r in range(ROWS):
                col = scr[:, r:r + 1]
                out[r] = torch.amin(col * scr[r][None, :] + col, dim=0)
            return out
        rowany = (scr > 700.0).any(dim=1)
        bits = sum(int(rowany[r]) << r for r in range(ROWS))
        return _row_store(out, bits, x.new_ones((ROWS, W)))
    return body


def _rowmask_planes_plain(x):
    plane = x[0:ROWS].clone()
    masks = [torch.where(plane > 600.0 + 100.0 * s, plane, 1e9) for s in range(3)]
    out = x.new_zeros((ROWS, W))
    for m in masks:
        rowany = (m < 1e9).any(dim=1)
        out = torch.where(rowany[:, None], out + m, out)
    return out


def _paged_plain(probe: int):
    def body(x):
        acc = x.new_zeros(())
        stack = x.new_zeros((8,), dtype=torch.int32)
        for i in range(3):
            scr = x[4 * i:4 * i + 4].clone()
            if probe == 1:
                s = torch.amin(scr[1])
            elif probe == 2:
                s = scr[1, 3]
            elif probe == 3:
                s = torch.amin(scr[2])
            else:
                link = torch.amin(scr[2]).to(torch.int32)
                push = bool(link > 4)
                if push:
                    stack[i] = link
                s = (stack[i] if push else stack.new_zeros(())).to(torch.float32)
            acc = acc + s
        return _full(acc)
    return body


# ------------------------------------------------------------------ table

@dataclass(frozen=True)
class Body:
    """One probe body: the kernel that runs it, the body number passed to
    kernels that serve several bodies, the input the reference builds
    (dtype, rows, and "arange" or "row_ids"), the TPU kernel it replaces,
    its plain version, and the work it needs: input rows staged and
    arithmetic operations (for the card's least time)."""

    kernel: str
    probe: int
    dtype: torch.dtype
    rows: int
    replaces: str
    plain: Callable
    staged_rows: int
    ops: int
    fill: str = "arange"


# kernel name -> (C launcher, whether it takes a body number, threads of its one block)
KERNELS = {
    "probe_hbm_to_smem": ("terra_probe_hbm_to_smem", False, 32),
    "probe_hbm_to_smem_i32_loop": ("terra_probe_hbm_to_smem_i32_loop", False, 32),
    "probe_smem_dma_in_while": ("terra_probe_smem_dma_in_while", False, 32),
    "rowmask_patterns": ("terra_probe_rowmask", True, 256),
    "rowmask_mask_planes": ("terra_probe_rowmask_planes", False, 256),
    "paged_patterns": ("terra_probe_paged", True, 32),
}

_F32, _I32 = torch.float32, torch.int32
_BLOCK = ROWS * W
BODIES = {
    "smem_dma/hbm_to_smem": Body("probe_hbm_to_smem", 0, _F32, 64,
                                 "scripts/smem_dma_probe.py:22", _hbm_to_smem_plain, 2, 2),
    "smem_dma/hbm_to_smem_i32_loop": Body("probe_hbm_to_smem_i32_loop", 0, _I32, 8,
                                          "scripts/smem_dma_probe.py:50", _i32_loop_plain, 4,
                                          10),
    "smem_dma/smem_dma_in_while": Body("probe_smem_dma_in_while", 0, _F32, 8,
                                       "scripts/smem_dma_probe.py:93", _dma_in_while_plain, 4,
                                       4),
    "rowmask/probe1": Body("rowmask_patterns", 1, _F32, 16, "scripts/rowmask_patterns_probe.py:31",
                           _rowmask_plain(1), 8, _BLOCK),
    "rowmask/probe2": Body("rowmask_patterns", 2, _F32, 16, "scripts/rowmask_patterns_probe.py:31",
                           _rowmask_plain(2), 8, 3 * ROWS * _BLOCK),
    "rowmask/probe3": Body("rowmask_patterns", 3, _F32, 16, "scripts/rowmask_patterns_probe.py:31",
                           _rowmask_plain(3), 8, 2 * _BLOCK),
    "rowmask/probe4": Body("rowmask_mask_planes", 0, _F32, 16,
                           "scripts/rowmask_patterns_probe.py:123", _rowmask_planes_plain, 8,
                           9 * _BLOCK),
    **{f"paged/probe{p}": Body("paged_patterns", p, _F32, 16,
                               "scripts/paged_patterns_probe.py:24", _paged_plain(p), 12,
                               3 * (W if p != 2 else 1) + 3, "row_ids" if p > 2 else "arange")
       for p in (1, 2, 3, 4)},
}


def make_input(name: str, device="cuda") -> torch.Tensor:
    """The input the reference builds for body ``name``: an arange of its
    shape (i32 with x[0, 0] = 5 for the loop probe), or each row's index
    in every lane."""
    body = BODIES[name]
    if body.fill == "row_ids":
        return torch.arange(body.rows, dtype=body.dtype, device=device)[:, None].repeat(1, W)
    x = torch.arange(body.rows * W, dtype=body.dtype, device=device).reshape(body.rows, W)
    if body.dtype == torch.int32:
        x[0, 0] = 5
    return x


def seeded_input(name: str, seed: int, device="cuda") -> torch.Tensor:
    """A random input for body ``name`` from ``numpy.random.default_rng(seed)``,
    integer-valued so that every product and sum the body takes is exact in
    f32 (below 2^24), whatever the order: rowmask probe 2 in (-2^11, 2^11);
    rowmask probe 3 at most 700 but for 1-4 lanes above it in half the rows;
    rowmask probe 4's rows reaching into each mask plane's threshold; paged
    probe 4 with page links (row minima) of at most 4 and above 4 in every
    input; the loop probe's trip count 0..130; else below 2^22."""
    body = BODIES[name]
    rng = np.random.default_rng(seed)
    shape = (body.rows, W)
    if name == "rowmask/probe2":
        x = rng.integers(-2**11, 2**11, shape)
    elif name == "rowmask/probe3":
        x = rng.integers(0, 701, shape)
        for r in np.flatnonzero(rng.permutation(ROWS) < ROWS // 2):
            lanes = rng.choice(W, rng.integers(1, 5), replace=False)
            x[r, lanes] = rng.integers(701, 1400, lanes.size)
    elif name == "rowmask/probe4":
        x = rng.integers(0, 600, shape)
        for r in range(ROWS):
            lanes = rng.choice(W, rng.integers(0, 4), replace=False)
            x[r, lanes] = rng.integers(550, 900, lanes.size)
    elif name == "paged/probe4":
        x = rng.integers(0, 2**16, shape)
        links = rng.permutation([rng.integers(-3, 5), rng.integers(5, 2**16),
                                 rng.integers(-3, 2**16)])
        for i, link in enumerate(links):
            x[4 * i + 2] = link + rng.integers(0, 64, W)
            x[4 * i + 2, rng.integers(W)] = link
    else:
        x = rng.integers(0, 2**22, shape)
        if body.dtype == torch.int32:
            x[0, 0] = rng.integers(0, W + 3)
    return torch.as_tensor(x.astype(np.int32 if body.dtype == torch.int32 else np.float32),
                           device=device)


def edge_inputs(name: str, device="cuda") -> dict:
    """{n: seed 0's input with x[0, 0] = n} for n in :data:`LOOP_EDGES` if
    ``name`` is the loop probe, else {}. Those trip counts are the edges of
    the kernel's split of the loop over a warp's lanes (none, one, 31-33,
    127-128 words) and of the port's rule past the row's 128 words, where
    the reference reads out of bounds: the loop stops at 128 trips."""
    if name != LOOP:
        return {}
    base = seeded_input(name, 0, device)
    edges = {n: base.clone() for n in LOOP_EDGES}
    for n, x in edges.items():
        x[0, 0] = n
    return edges


# ------------------------------------------------------------------ kernels

# The launch floor: an empty kernel launched with a probe's block size.
FLOOR = "terra_probe_empty"


def kernel_path() -> str:
    """Path of the built probe library (builds it if needed)."""
    return build_shared([nvcc(), *NVCC_FLAGS], [SRC], "pattern_probes")


def load_library(path: str) -> ctypes.CDLL:
    """Load a built probe library and declare its launchers."""
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    for fn, numbered, _ in [*KERNELS.values(), (FLOOR, True, None)]:
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [p, p, ctypes.c_int, p] if numbered else [p, p, p]
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/pattern_probes.cu`` (once per source/flag hash) and load it."""
    return load_library(kernel_path())


def _check(body: Body, x: torch.Tensor):
    if x.dtype != body.dtype or tuple(x.shape) != (body.rows, W):
        raise ValueError(f"{body.kernel} takes a ({body.rows}, {W}) {body.dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def run_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of body ``name``, on ``x``'s device."""
    body = BODIES[name]
    _check(body, x)
    return body.plain(x)


def _launch(lib: ctypes.CDLL, fn: str, arg, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty((ROWS, W), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), out.data_ptr(), *(() if arg is None else (arg,)), stream)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    return out


def launch(name: str, x: torch.Tensor, lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Body ``name``'s kernel from ``lib`` (default: :func:`load_kernel`) on
    the CUDA tensor ``x``, not counted in :data:`launches` (for A/Bs of
    other builds)."""
    body = BODIES[name]
    _check(body, x)
    if x.device.type != "cuda":
        raise ValueError(f"{body.kernel} kernel runs on cuda tensors, got {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{body.kernel} needs a contiguous, 16-byte-aligned input (the bulk "
                         f"copy's rule)")
    fn, numbered, _ = KERNELS[body.kernel]
    return _launch(lib or load_kernel(), fn, body.probe if numbered else None, x)


def run(name: str, x: torch.Tensor) -> torch.Tensor:
    """Body ``name`` of :data:`BODIES` on ``x``: the plain version for a
    CPU tensor, the kernel for a CUDA tensor. Returns the (8, 128) output
    in ``x``'s dtype."""
    global launches
    body = BODIES[name]
    _check(body, x)
    if x.device.type == "cpu":
        return body.plain(x)
    out = launch(name, x)
    launches += 1
    return out


def run_floor(x: torch.Tensor, threads: int = 256,
              lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """The empty kernel (one block of ``threads``, a probe kernel's block
    size in :data:`KERNELS`; no work) launched on ``x``'s card as
    :func:`run` launches a probe, output allocated and left unwritten: the
    launch floor. Not counted in :data:`launches`."""
    if threads not in {t for _, _, t in KERNELS.values()}:
        raise ValueError(f"the launch floor takes a probe kernel's block size, got {threads}")
    if x.device.type != "cuda":
        raise ValueError(f"the launch floor runs on cuda tensors, got {x.device}")
    return _launch(lib or load_kernel(), FLOOR, threads, x)


def redesign_rank(rows: dict) -> list:
    """[(kernel, launches x (ms - bound_ms)), ...] from ``{kernel:
    {"launches", "ms", "bound_ms"}}``, largest first: the device time a
    redesign could save on the run that launched them. A kernel at or below
    its bound has nothing to save and is left out."""
    gain = {k: r["launches"] * (r["ms"] - r["bound_ms"]) for k, r in rows.items()}
    return sorted(((k, g) for k, g in gain.items() if g > 0), key=lambda kg: -kg[1])


def sass(path: str) -> dict:
    """{kernel: its SASS text} of a built library (``cuobjdump -sass``), as
    :func:`parse_sass` gives it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return parse_sass(subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(text: str) -> dict:
    """{kernel: its SASS text} of a ``cuobjdump -sass`` dump, each line's
    runs of spaces collapsed to one: the dump pads every kernel's columns
    to the widest instruction in the whole library, so a kernel's text
    would otherwise change with its neighbours."""
    return {b.split()[0]: "\n".join(" ".join(ln.split()) for ln in b.splitlines())
            for b in re.split(r"\n\s*Function : ", text)[1:]}
