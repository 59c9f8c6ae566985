"""Fetches from small tables by one-hot product, as the reference takes them
(``terra_tpu/surface.py:122-136``, ``terra_tpu/ops/distributions.py:66-91``).

A lane's row of a table of at most :data:`MAX_ROWS` rows is the product of
its one-hot row with the table: one nonzero term per output, so the sum
adds zeros and copies the value. Two differences from a gather follow,
both the reference's: a fetched -0.0 comes back +0.0, and an id out of
range gives a zero row (no device assert, no host read, so the product is
capture-safe). A non-finite entry of the table spreads to every lane
through 0 * inf, as in the reference. Its backward is a product too: a (rows x N) by (N x cols)
matrix product in place of an index accumulate that adds each row's
lanes one after another.

The product runs in full f32 whatever the process has set for float32
matrix products (``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``): TF32 or bf16 would round the
table's mantissas, as the TPU's default precision did in the reference
before it asked for HIGHEST. :func:`full_f32` sets the flags to IEEE
around each product, forward and backward, and restores them after, so a
caller who wants TF32 elsewhere keeps it; raising instead would refuse
every render of such a caller. The flags are host state read when a
product is launched, so this holds inside a CUDA graph capture too.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["MAX_ROWS", "full_f32", "one_hot", "pick", "product"]

MAX_ROWS = 512


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products in IEEE f32 (no TF32, no bf16) for the block,
    the CUDA and CPU (mkldnn) flags restored after. It sets PyTorch's
    per-backend ``fp32_precision`` flags, which the legacy ones
    (``allow_tf32``, ``set_float32_matmul_precision``) also set; reading the
    legacy ones raises once both kinds were set."""
    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p


def one_hot(idx, n: int, dtype=torch.float32):
    """``jax.nn.one_hot``'s definition: ``idx == arange(n)`` cast to
    ``dtype``; an id outside [0, n) gives a zero row. (``F.one_hot``
    scatters and asserts on the device instead.)"""
    return (idx[..., None] == torch.arange(n, device=idx.device, dtype=idx.dtype)).to(dtype)


class _Product(torch.autograd.Function):
    """``onehot @ table`` with both products in full f32."""

    @staticmethod
    def forward(ctx, onehot, table):
        ctx.save_for_backward(onehot)
        with full_f32():
            return onehot @ table

    @staticmethod
    def backward(ctx, grad):
        (onehot,) = ctx.saved_tensors
        with full_f32():
            return None, onehot.mT @ grad


def product(onehot, table):
    """(N, rows) one-hot rows times a (rows, cols) table. A one-row table is
    a broadcast multiply, XLA's own form of a dot over one term (so the
    sign of a zero is the reference's)."""
    if table.shape[0] == 1:
        return onehot * table
    return _Product.apply(onehot, table)


def pick(table, idx, dtype=None):
    """``table[idx]``, one (rows, cols) row per id: by one-hot product (in
    ``dtype``, default the table's) when the table has at most
    :data:`MAX_ROWS` rows, else by an index gather (ids must be in range)."""
    rows = table.shape[0]
    if rows > MAX_ROWS:
        return table[idx.long()]
    return product(one_hot(idx, rows, dtype or table.dtype), table)
