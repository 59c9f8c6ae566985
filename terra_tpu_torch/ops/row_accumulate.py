"""Row gathers whose backward is a deterministic segmented sum.

The training path fetches rows of large tables by index: the triangle
table (``onehot.pick`` above ``MAX_ROWS`` rows), the texture atlas
(``textures._read``), the positions (``scene.Geometry.corners``) and the
lights' corners (``surface.build_shade_tables``). The backward of
``table[idx]`` adds each lane's gradient row into the row it named.
PyTorch's deterministic index accumulate sums each row's lanes one after
another in one warp, and a row named by many lanes (triangle 0, which
every lane that missed gathers) becomes a long serial chain.

:func:`gather` is :class:`RowGather`, whose forward is ``table[idx]``, the
same indexing op, and whose backward is :func:`row_accumulate`. Where
autograd does not record, or no input requires grad, the Function records
no node, so paths without a gradient launch what they launched before.
:func:`row_accumulate` sorts the ids once (stable) and sums each
row's run in fixed tiles of :data:`TILE` sorted positions, a segmented
Hillis-Steele scan in each column of a tile; a run that a tile boundary
cuts is carried, as a partial sum, to the next level (two slots a tile)
and summed there by the same scan, until one tile holds a level. No
atomics: the bits repeat from call to call. A row no lane names reads
+0.0, and a run's sum is added to +0.0, as a scatter-add into zeros.

For a CUDA tensor the levels are the hand-written kernel
``csrc/row_accumulate.cu`` (built at the first CUDA backward, one launch a
level, counted as ``"row_accumulate"`` in ``profile.kernel_launches``); for a CPU tensor they are
:func:`row_accumulate_plain`, the same levels as PyTorch ops, which gives
the kernel's words. A CUDA call the kernel does not take raises; there is
no fallback. The CUDA wrapper allocates its output and scratch with
``torch.zeros`` / ``torch.empty`` at sizes fixed by the shapes and reads
nothing back, so a CUDA graph can capture it. Ids must lie in
``[0, rows)``: the plain version raises on others, the CUDA path leaves
them unchecked (a check would read the ids back) and the kernel writes no
row for them, so their gradient is dropped.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch
from torch.autograd.function import once_differentiable

from .._build import build_shared, nvcc
from ..profile import kernel_launches
from .rng import NVCC_FLAGS

__all__ = ["gather", "RowGather", "row_accumulate", "row_accumulate_plain", "level_sizes",
           "load_kernel", "kernel_path", "TILE"]

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                          "row_accumulate.cu")
# Sorted positions a tile holds (the kernel's block; a power of two).
TILE = 256
_STEPS = TILE.bit_length() - 1
# Key of a position past the ids and of a slot that carries nothing on.
_NONE = -1


def gather(table, idx):
    """``table[idx]`` through :class:`RowGather`."""
    return RowGather.apply(table, idx)


class RowGather(torch.autograd.Function):
    """``table[idx]`` whose backward is :func:`row_accumulate`. The node
    keeps the table's shape as ``table_shape``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = tuple(table.shape)
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return row_accumulate(grad, idx, ctx.table_shape[0]).reshape(ctx.table_shape), None


def level_sizes(n: int) -> list:
    """Positions at each level of an accumulate over ``n`` ids: ``n``, then
    two slots for each tile of the level below, until one tile holds it."""
    sizes = [n]
    while sizes[-1] > TILE:
        sizes.append(2 * -(-sizes[-1] // TILE))
    return sizes


def _flat(grad, idx, rows: int):
    """(n, cols) rows of ``grad`` (shaped ``idx.shape + row``) and the
    output's shape."""
    n = idx.numel()
    if tuple(grad.shape[:idx.dim()]) != tuple(idx.shape):
        raise ValueError(f"row_accumulate: gradient {tuple(grad.shape)} does not start with the "
                         f"ids' shape {tuple(idx.shape)}")
    tail = tuple(grad.shape[idx.dim():])
    return grad.reshape(n, -1), (rows, *tail)


def _level_plain(keys, vals, rows: int, out):
    """One level on the CPU: the kernel's scan and writes; returns the next
    level's (keys, vals), or None when the level is one tile."""
    n, cols = vals.shape
    tiles = -(-n // TILE)
    pad = tiles * TILE - n
    k = torch.cat([keys, keys.new_full((pad,), _NONE)]).view(tiles, TILE)
    x = torch.cat([vals, vals.new_zeros((pad, cols))]).view(tiles, TILE, cols)
    for s in range(_STEPS):
        d = 1 << s
        same = (k[:, d:] == k[:, :-d])[..., None]
        x = torch.cat([x[:, :d], torch.where(same, x[:, :-d] + x[:, d:], x[:, d:])], dim=1)
    none = keys.new_full((1,), _NONE)
    before = torch.cat([none, k[:-1, -1]])[:, None]  # the key before each tile
    after = torch.cat([k[1:, 0], none])[:, None]  # and after it
    first, last = k[:, :1], k[:, -1:]
    end = torch.cat([k[:, 1:] != k[:, :-1], torch.ones_like(first, dtype=torch.bool)], dim=1)
    at_last = torch.zeros_like(end)
    at_last[:, -1] = True
    cut = ((k == first) & (before == k)) | (at_last & (after == k))
    write = end & (k >= 0) & (k < rows) & ~cut
    out[k[write].long()] = x[write] + 0.0
    if tiles == 1:
        return None
    first_end = (end & (k == first)).int().argmax(dim=1)
    head_cut = (first >= 0) & ((before == first) | ((first_end[:, None] == TILE - 1) &
                                                    (after == first)))
    single = first == last
    tail_cut = ~single & (last >= 0) & (after == last)
    head_key = torch.where(head_cut, first, _NONE)
    tail_key = torch.where(single, head_key, torch.where(tail_cut, last, _NONE))
    head = torch.where(head_cut, x[torch.arange(tiles), first_end], 0.0)
    tail = torch.where(tail_cut, x[:, -1], 0.0)
    return (torch.cat([head_key, tail_key], dim=1).reshape(-1),
            torch.stack([head, tail], dim=1).reshape(-1, cols))


def _sorted_ids(idx):
    """The ids as sorted int32 keys and the lanes' permutation (stable)."""
    return torch.sort(idx.reshape(-1).to(torch.int32), stable=True)


def row_accumulate_plain(grad, idx, rows: int):
    """The gradient of a (rows, ...) table under ``table[idx]``: row r the
    sum of the rows of ``grad`` (``idx.shape + row``) whose id is r, in the
    kernel's order (the same levels, tiles and scan, as PyTorch ops)."""
    vals, shape = _flat(grad, idx, rows)
    out = vals.new_zeros((rows, vals.shape[1]))
    if vals.numel() == 0:
        return out.reshape(shape)
    keys, perm = _sorted_ids(idx)
    if keys[0] < 0 or keys[-1] >= rows:
        raise ValueError(f"row_accumulate: ids in [{int(keys[0])}, {int(keys[-1])}] outside "
                         f"[0, {rows})")
    vals = vals[perm]
    while (nxt := _level_plain(keys, vals, rows, out)) is not None:
        keys, vals = nxt
    return out.reshape(shape)


def kernel_path() -> str:
    """Path of the built row-accumulate kernel library (builds it if needed)."""
    return build_shared([nvcc(), *NVCC_FLAGS], [KERNEL_SRC], "row_accumulate")


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/row_accumulate.cu`` (once per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.terra_row_accumulate_level.restype = ctypes.c_int
    lib.terra_row_accumulate_level.argtypes = [p, p, p, i64, ctypes.c_int, i64, p, p, p, p]
    lib.terra_row_accumulate_tile.restype = ctypes.c_int
    lib.terra_row_accumulate_tile.argtypes = []
    if lib.terra_row_accumulate_tile() != TILE:
        raise RuntimeError(f"row_accumulate: the kernel's tile is "
                           f"{lib.terra_row_accumulate_tile()}, the plain version's {TILE}")
    return lib


def _row_accumulate_cuda(grad, idx, rows: int):
    """The levels as kernel launches on the current stream. Ids outside
    ``[0, rows)`` are not checked; the kernel writes no row for them."""
    dev = grad.device
    if not grad.is_cuda or grad.dtype != torch.float32:
        raise ValueError(f"the row-accumulate kernel takes a float32 CUDA gradient; got "
                         f"{grad.dtype} on {dev}")
    if idx.device != dev or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the row-accumulate kernel takes int32 or int64 ids on {dev}; got "
                         f"{idx.dtype} on {idx.device}")
    if not 0 < rows < 2**31:
        raise ValueError(f"the row-accumulate kernel takes 1 to 2^31 - 1 rows; got {rows}")
    vals, shape = _flat(grad, idx, rows)
    vals = vals.contiguous()
    n, cols = vals.shape
    out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
    if n == 0 or cols == 0:
        return out.reshape(shape)
    keys, perm = _sorted_ids(idx)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = level_sizes(n)
    for size, nxt in zip(sizes, sizes[1:] + [None]):
        nk = None if nxt is None else torch.empty((nxt,), dtype=torch.int32, device=dev)
        nv = None if nxt is None else torch.empty((nxt, cols), dtype=torch.float32, device=dev)
        rc = lib.terra_row_accumulate_level(
            keys.data_ptr(), None if perm is None else perm.data_ptr(), vals.data_ptr(), size,
            cols, rows, out.data_ptr(), None if nk is None else nk.data_ptr(),
            None if nv is None else nv.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"row_accumulate launch failed: cudaError {rc}")
        kernel_launches["row_accumulate"] += 1
        keys, perm, vals = nk, None, nv
    return out.reshape(shape)


def row_accumulate(grad, idx, rows: int):
    """:func:`row_accumulate_plain`'s sums: the kernel for a CUDA gradient,
    the plain version for a CPU one."""
    if grad.device.type == "cpu":
        return row_accumulate_plain(grad, idx, rows)
    return _row_accumulate_cuda(grad, idx, rows)
