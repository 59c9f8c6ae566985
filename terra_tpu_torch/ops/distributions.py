"""Discrete 1D/2D distributions: CDF build and inverse-CDF sampling (port of
``terra_tpu/ops/distributions.py``).

The build is a ``cumsum``; sampling is a ``searchsorted`` over the whole
wavefront (a bucket count along a row). Table entries are fetched as the
reference fetches them: a row of a table of at most ``_ONEHOT_MAX`` rows
by a one-hot product in full f32 (:func:`_oh_pick`, ``ops/onehot.py``),
an entry of a lane's own row by a one-hot multiply-reduce
(:func:`_oh_at`); larger tables by gathers.

``torch.cumsum`` and XLA's CPU cumulative sum add in different orders, so
the two packages' CDFs agree to a few f32 ulps, not bit for bit; from the
same tables the sampled indices are equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import onehot

__all__ = ["Distribution1D", "Distribution2D", "build_1d", "sample_1d", "build_2d", "sample_2d"]


@dataclass
class Distribution1D:
    """f: (..., n) weights; cdf: (..., n) normalised inclusive cumsum;
    integral: (...)."""

    f: torch.Tensor
    cdf: torch.Tensor
    integral: torch.Tensor


@dataclass
class Distribution2D:
    """Per-row conditionals ((ny, nx) leaves) and the marginal over rows."""

    conditionals: Distribution1D
    marginal: Distribution1D


def build_1d(f) -> Distribution1D:
    """Batched over leading axes."""
    f = torch.as_tensor(f, dtype=torch.float32)
    c = torch.cumsum(f, dim=-1)
    integral = c[..., -1]
    safe = torch.clamp(integral, min=1e-20)
    return Distribution1D(f=f, cdf=c / safe[..., None], integral=integral)


# the most columns a lane's row read by one-hot multiply-reduce has
_ONEHOT_MAX = onehot.MAX_ROWS


def _oh_pick(table, idx):
    """``table[idx]`` for (N,) ``idx``: by one-hot product when the table
    has at most ``_ONEHOT_MAX`` rows (an id out of range gives 0).
    ``table``: (n,) or (n, k); returns (N,) or (N, k)."""
    out = onehot.pick(table if table.ndim == 2 else table[:, None], idx, torch.float32)
    return out if table.ndim == 2 else out[..., 0]


def _oh_at(rows, idx):
    """``rows[lane, idx[lane]]`` for (N, n) ``rows``: a one-hot
    multiply-reduce when n is at most ``_ONEHOT_MAX``. Over one column the
    reduce is the product itself, as XLA simplifies it (the sign of a
    zero is the reference's)."""
    n = rows.shape[-1]
    if n > _ONEHOT_MAX:
        return torch.take_along_dim(rows, idx.long()[..., None], -1)[..., 0]
    picked = rows * onehot.one_hot(idx, n, rows.dtype)
    return picked[..., 0] if n == 1 else torch.sum(picked, dim=-1)


def sample_1d(dist: Distribution1D, e):
    """Inverse CDF with in-bucket interpolation. Returns (x in [0, 1), pdf,
    idx)."""
    n = dist.cdf.shape[-1]
    idx = torch.clamp(torch.searchsorted(dist.cdf, e, right=True), 0, n - 1)
    prev_cdf = torch.cat([torch.zeros_like(dist.cdf[:1]), dist.cdf[:-1]])
    picked = _oh_pick(torch.stack([dist.cdf, prev_cdf, dist.f], dim=1), idx)
    curr, prev, f_at = picked[..., 0], picked[..., 1], picked[..., 2]
    frac = (e - prev) / torch.clamp(curr - prev, min=1e-12)
    x = (idx.to(torch.float32) + frac) / n
    pdf = f_at / torch.clamp(dist.integral, min=1e-20)
    return x, pdf, idx


def build_2d(f) -> Distribution2D:
    """f: (ny, nx) weights -> marginal x conditional product distribution."""
    conditionals = build_1d(f)
    return Distribution2D(conditionals=conditionals, marginal=build_1d(conditionals.integral))


def sample_2d(dist: Distribution2D, e1, e2):
    """Row from the marginal by ``e1``, column from that row's conditional
    by ``e2`` (the count of CDF entries below ``e2``, as the reference
    counts). Returns ((u, v), pdf), u along x and v along y, in [0, 1)."""
    v, pdf_y, row = sample_1d(dist.marginal, e1)
    cond = dist.conditionals
    cdf = _oh_pick(cond.cdf, row)  # (N, nx)
    fr = _oh_pick(cond.f, row)
    integ = _oh_pick(cond.integral, row)
    n = cdf.shape[-1]
    idx = torch.clamp((cdf < e2[..., None]).sum(dim=-1), 0, n - 1)
    prev = torch.where(idx > 0, _oh_at(cdf, torch.clamp(idx - 1, min=0)), 0.0)
    curr = _oh_at(cdf, idx)
    frac = (e2 - prev) / torch.clamp(curr - prev, min=1e-12)
    u = (idx.to(torch.float32) + frac) / n
    pdf_x = _oh_at(fr, idx) / torch.clamp(integ, min=1e-20)
    return (u, v), pdf_y * pdf_x
