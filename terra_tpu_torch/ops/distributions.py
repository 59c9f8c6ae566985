"""Discrete 1D/2D distributions: CDF build and inverse-CDF sampling (port of
``terra_tpu/ops/distributions.py``).

The build is a ``cumsum``; sampling is a ``searchsorted`` over the whole
wavefront. The JAX package fetches table entries by one-hot matrix
products at HIGHEST precision for the TPU's matrix unit; the port fetches
them with plain gathers (TF32 would quantize a matrix-product fetch on
Hopper, as it would ``surface.fetch_rows``).

``torch.cumsum`` and XLA's CPU cumulative sum add in different orders, so
the two packages' CDFs agree to a few f32 ulps, not bit for bit; from the
same tables the sampled indices are equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def sample_1d(dist: Distribution1D, e):
    """Inverse CDF with in-bucket interpolation. Returns (x in [0, 1), pdf,
    idx)."""
    n = dist.cdf.shape[-1]
    idx = torch.clamp(torch.searchsorted(dist.cdf, e, right=True), 0, n - 1)
    curr = dist.cdf[idx]
    prev = torch.where(idx > 0, dist.cdf[torch.clamp(idx - 1, min=0)], 0.0)
    frac = (e - prev) / torch.clamp(curr - prev, min=1e-12)
    x = (idx.to(torch.float32) + frac) / n
    pdf = dist.f[idx] / torch.clamp(dist.integral, min=1e-20)
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
    n = cond.cdf.shape[-1]
    cdf = cond.cdf[row]  # (N, nx)
    idx = torch.clamp((cdf < e2[..., None]).sum(dim=-1), 0, n - 1)
    prev = torch.where(idx > 0, cdf.gather(-1, torch.clamp(idx - 1, min=0)[..., None])[..., 0],
                       0.0)
    curr = cdf.gather(-1, idx[..., None])[..., 0]
    frac = (e2 - prev) / torch.clamp(curr - prev, min=1e-12)
    u = (idx.to(torch.float32) + frac) / n
    pdf_x = cond.f[row, idx] / torch.clamp(cond.integral[row], min=1e-20)
    return (u, v), pdf_y * pdf_x
