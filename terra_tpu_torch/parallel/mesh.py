"""Rows x samples sharding of the render wavefront over ``torch.distributed``
ranks (port of ``terra_tpu/parallel/mesh.py``).

The reference shards the pixel rows and the sample axis over a
``jax.sharding.Mesh`` with ``shard_map`` and sums the partial accumulators
with ``psum``. Here each rank is one process with one device:

  * 'rows'    — rank (ri, si) renders the row band ``ri`` of the frame;
  * 'samples' — and the sample slice ``si`` of each pixel's samples; the
    partial sums of a band are all-reduced over the ranks that share it.

:class:`Mesh` is the layout seen from one rank: its coordinates and one
process group for each axis reduction that involves it. Every rank creates
every group, in the same order, as ``dist.new_group`` requires. The scene
is replicated; the RNG is counter-based and keyed by global pixel and
sample ids, so the image is the single-process image for every layout:
bit for bit when only rows are sharded (no sum changes order), within
f32 reassociation of the sample sums otherwise. Only ``all_reduce``,
``broadcast`` and ``barrier`` are used: the collectives that ``gloo``
supports on CUDA tensors (several ranks on one card) and ``nccl`` on every
device.

A rank's results stay banded: :func:`render_sharded` returns the film of
the rank's rows, as the reference's film stays row-sharded.
:func:`gather_rows` assembles the whole frame where a caller needs it (a
checkpoint, an image, a test).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..film import Film
from ..ops import rng as rng_mod
from ..render import _rows_per_launch, render_rows
from ..scene import Camera, RenderOptions, Scene

__all__ = ["Mesh", "make_mesh", "local_device", "render_sharded", "render_chunk_sharded",
           "render_band_sharded", "gather_rows", "band_rows_of", "shard_sizes"]


def local_device(device: str = "cuda", local_rank: Optional[int] = None) -> torch.device:
    """This process's device: ``cuda:(local_rank % device_count)`` or the
    CPU for ``device="cpu"``. ``local_rank`` defaults to ``LOCAL_RANK``,
    then to the rank."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"no distributed rendering on device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' (with the gloo backend) to run on the CPU")
    if local_rank is None:
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the ('rows', 'samples') layout.

    shape  : {"rows": R, "samples": S}, R * S ranks, rank = ri * S + si
    row    : ri, the rank's row band
    sample : si, the rank's sample slice
    device : the device this rank renders on
    groups : the process group that sums over each axis, keyed by the axis
             summed as ``psum`` names it: "samples" holds the S ranks of
             this row band, "rows" the R ranks of this sample slice, "all"
             every rank of the layout (None where the group is the whole
             world or the axis has one rank)
    """

    shape: Dict[str, int]
    row: int
    sample: int
    device: torch.device
    groups: Dict[str, Optional[object]]

    def all_reduce(self, x: torch.Tensor, axes=("rows", "samples")) -> torch.Tensor:
        """Sum ``x`` in place over the ranks along ``axes`` (one axis name
        or both, as ``psum`` takes them); returns ``x``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if math.prod(self.shape[a] for a in axes) == 1:
            return x
        group = self.groups["all" if len(axes) == 2 else axes[0]]
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x


def make_mesh(shape: Optional[Tuple[int, int]] = None, device: str = "cuda",
              ranks: Optional[int] = None) -> Optional[Mesh]:
    """The ('rows', 'samples') layout over the first ``ranks`` ranks of the
    process group (default: all of them; ``distributed.initialize``
    first), by default all on 'rows'. Every rank of the group must call it
    with the same arguments, in the same order as its other group
    creations; a rank outside the layout gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "terra_tpu_torch.parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n = world if ranks is None else ranks
    rows, samples = shape if shape is not None else (n, 1)
    if rows * samples != n or n > world:
        raise ValueError(f"mesh {(rows, samples)} != {n} ranks (of {world})")
    rank = dist.get_rank()
    ri, si = divmod(rank, samples)
    # the whole layout, then the S ranks of each row band (summing over
    # 'samples'), then the R ranks of each sample slice (summing over
    # 'rows'), created by every rank in this order; None is the world
    everyone = dist.new_group(list(range(n))) if n < world else None
    groups: Dict[str, Optional[object]] = {"all": everyone, "rows": None, "samples": None}
    for axis, lines, members in (
            ("samples", rows, lambda line: [line * samples + s for s in range(samples)]),
            ("rows", samples, lambda line: [r * samples + line for r in range(rows)])):
        if len(members(0)) == 1:
            continue
        if len(members(0)) == n:
            groups[axis] = everyone
            continue
        for line in range(lines):
            group = dist.new_group(members(line))
            if line == (ri if axis == "samples" else si):
                groups[axis] = group
    if rank >= n:
        return None
    return Mesh(shape={"rows": rows, "samples": samples}, row=ri, sample=si,
                device=local_device(device), groups=groups)


def _render_rows_bounded(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset: int,
                         spp: int, row0: int, rows: int):
    """``render_rows`` in sub-bands of at most MAX_WAVEFRONT_LANES lanes: a
    pixel's sum does not depend on the rows beside it, so the result is
    the one-call result bit for bit."""
    step = _rows_per_launch(opts, spp)
    if step >= rows:
        return render_rows(scene, cam, opts, key, sample_offset, spp, row0, rows)
    return torch.cat([render_rows(scene, cam, opts, key, sample_offset, spp, row0 + b,
                                  min(step, rows - b)) for b in range(0, rows, step)])


def shard_sizes(mesh: Mesh, band_rows: int, spp_chunk: int) -> Tuple[int, int]:
    """(rows per row shard, samples per sample shard), as the reference
    asserts them."""
    n_rows, n_samp = mesh.shape["rows"], mesh.shape["samples"]
    if band_rows % n_rows:
        raise ValueError(f"height {band_rows} must divide over {n_rows} row shards")
    if spp_chunk % n_samp:
        raise ValueError(f"spp chunk {spp_chunk} must divide over {n_samp} sample shards")
    return band_rows // n_rows, spp_chunk // n_samp


@torch.no_grad()
def render_band_sharded(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset: int,
                        band0: int, spp_chunk: int, band_rows: int, mesh: Mesh):
    """This rank's rows of the band [band0, band0 + band_rows) for
    ``spp_chunk`` samples from ``sample_offset``: the (band_rows / R, W, 3)
    radiance sum of rows ``band0 + ri * band_rows / R`` on, summed over the
    rank's sample group. Bounds the live wavefront of very large frames."""
    rows_per, spp_shard = shard_sizes(mesh, band_rows, spp_chunk)
    acc = _render_rows_bounded(scene, cam, opts, key, int(sample_offset) + mesh.sample * spp_shard,
                               spp_shard, int(band0) + mesh.row * rows_per, rows_per)
    return mesh.all_reduce(acc, "samples")


def render_chunk_sharded(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset: int,
                         spp_chunk: int, mesh: Mesh):
    """Sharded ``render_chunk``: this rank's row band (H / R, W, 3) of the
    radiance sum of ``spp_chunk`` samples."""
    return render_band_sharded(scene, cam, opts, key, sample_offset, 0, spp_chunk, opts.height,
                               mesh)


def band_rows_of(mesh: Mesh, height: int, band_rows: int = 0) -> torch.Tensor:
    """The frame rows a rank holds when the frame is rendered in bands of
    ``band_rows`` (0: one band), in the order its results stack."""
    band_rows = band_rows or height
    rows_per, _ = shard_sizes(mesh, band_rows, mesh.shape["samples"])
    if height % band_rows:
        raise ValueError(f"height {height} is not a whole number of {band_rows}-row bands")
    return torch.cat([torch.arange(rows_per) + b0 + mesh.row * rows_per
                      for b0 in range(0, height, band_rows)])


def gather_rows(part: torch.Tensor, rows: torch.Tensor, height: int, mesh: Mesh) -> torch.Tensor:
    """The whole frame on every rank from each rank's ``part`` (its frame
    rows ``rows``, as :func:`band_rows_of` gives them): the sample slice 0
    of each row band writes its rows into zeros and one all-reduce over
    every rank adds them up, which leaves every value as it was."""
    full = torch.zeros((height,) + tuple(part.shape[1:]), dtype=part.dtype, device=part.device)
    if mesh.sample == 0:
        full[rows.to(part.device)] = part
    return mesh.all_reduce(full)


def render_sharded(scene: Scene, cam: Camera, opts: RenderOptions, mesh: Mesh, seed: int = 0,
                   film: Optional[Film] = None) -> Film:
    """Progressive sharded render: adds ``opts.samples_per_pixel`` samples
    to the film of this rank's row band (H / R rows from ri * H / R) and
    returns it. ``film`` may be a band film or a whole-frame one (a
    resumed checkpoint), of which the rank takes its band. Gather the
    frame with ``gather_rows(film.acc, band_rows_of(mesh, H), H, mesh)``."""
    rows_per, _ = shard_sizes(mesh, opts.height, mesh.shape["samples"])
    r0 = mesh.row * rows_per
    if film is None:
        film = Film.create(opts.width, rows_per, mesh.device)
    elif film.acc.shape[0] == opts.height and rows_per != opts.height:
        film = Film(acc=film.acc[r0:r0 + rows_per], samples=film.samples[r0:r0 + rows_per])
    film = Film(acc=film.acc.to(mesh.device), samples=film.samples.to(mesh.device))
    key = rng_mod.key_from_seed(seed)
    spp = opts.samples_per_pixel
    chunk = min(opts.samples_per_launch or spp, spp)
    base = int(film.samples[0, 0])
    done = 0
    while done < spp:
        cur = min(chunk, spp - done)
        acc = render_chunk_sharded(scene, cam, opts, key, base + done, cur, mesh)
        film = Film(acc=film.acc + acc, samples=film.samples + cur)
        done += cur
    return film

