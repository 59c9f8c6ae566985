"""Environment lighting: radiance lookup and importance sampling (port of
``terra_tpu/envmap.py``).

:func:`build_distribution` resamples the environment onto a fixed
GRID_H x GRID_W lat-long proposal grid (luminance x sin(theta), plus a
floor so the pdf is positive everywhere), :func:`sample` draws directions
from it and :func:`pdf` evaluates the solid-angle density of any
direction, for next-event estimation of the environment with MIS against
the BSDF strategy. The mapping is :func:`textures.sample_latlong`'s, so
sampled directions, their radiance and their pdf agree. The pdf fetches
its grid entry in the reference's two stages: the row by one-hot product,
the column by one-hot multiply-reduce (``distributions._oh_pick``,
``_oh_at``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import textures as textures_mod
from .ops import distributions, math3
from .scene import Scene

__all__ = ["radiance", "build_distribution", "sample", "pdf", "GRID_H", "GRID_W"]

GRID_H = 64
GRID_W = 128
PI = float(np.float32(np.pi))
TWO_PI2 = float(np.float32(2.0 * np.pi * np.pi))
FLOOR_FRAC = 1e-2  # proposal floor as a fraction of the mean weight


def radiance(scene: Scene, d):
    """Environment radiance along ``d``: the lat-long texture when
    ``scene.env_tex`` >= 0, else the constant env color."""
    if scene.textures.num_textures == 0 or scene.env_tex < 0:
        return scene.env_value.expand(d.shape)
    tex_id = torch.full(d.shape[:-1], scene.env_tex, dtype=torch.int64, device=d.device)
    return textures_mod.sample_latlong(scene.textures, tex_id, d)


def _grid_dirs(device):
    """Directions at the proposal-grid cell centres, (GRID_H, GRID_W, 3)."""
    v = (torch.arange(GRID_H, dtype=torch.float32, device=device) + 0.5) / GRID_H
    u = (torch.arange(GRID_W, dtype=torch.float32, device=device) + 0.5) / GRID_W
    theta = v * PI
    phi = u * (2.0 * PI) - PI
    sin_t = torch.sin(theta)[:, None]
    dx = sin_t * torch.cos(phi)[None, :]
    dz = sin_t * torch.sin(phi)[None, :]
    dy = torch.cos(theta)[:, None].expand(GRID_H, GRID_W)
    return torch.stack([dx, dy, dz], dim=-1)


def build_distribution(scene: Scene) -> distributions.Distribution2D:
    """Proposal over the lat-long grid: luminance x sin(theta) + floor (the
    sin(theta) area element keeps the poles from being oversampled)."""
    dev = scene.env_value.device
    rad = radiance(scene, _grid_dirs(dev).reshape(-1, 3)).reshape(GRID_H, GRID_W, 3)
    lum = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2]
    theta = ((torch.arange(GRID_H, dtype=torch.float32, device=dev) + 0.5) / GRID_H) * PI
    sin_t = torch.sin(theta)[:, None]
    f = lum * sin_t
    floor = torch.clamp(f.mean(), min=1e-12) * FLOOR_FRAC
    return distributions.build_2d(f + floor * sin_t)


def sample(dist: distributions.Distribution2D, e1, e2):
    """Draw a direction from the proposal. Returns (wi, pdf_solid_angle):
    d(omega) = 2 pi^2 sin(theta) du dv, and a bucket's probability is a
    (u, v) density times the grid size."""
    (u, v), p_bucket = distributions.sample_2d(dist, e1, e2)
    theta = v * PI
    phi = u * (2.0 * PI) - PI
    sin_t = torch.sin(theta)
    wi = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)], dim=-1)
    density_uv = p_bucket * float(GRID_W * GRID_H)
    return wi, density_uv / torch.clamp(TWO_PI2 * sin_t, min=1e-6)


def pdf(dist: distributions.Distribution2D, wi):
    """Solid-angle pdf of any direction under the proposal."""
    d = math3.normalize(wi)
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0]) + PI
    u = phi / (2.0 * PI)
    v = theta / PI
    col = torch.clamp((u * GRID_W).to(torch.int64), 0, GRID_W - 1)
    row = torch.clamp((v * GRID_H).to(torch.int64), 0, GRID_H - 1)
    total = torch.clamp(dist.marginal.integral, min=1e-20)
    f_at = distributions._oh_at(distributions._oh_pick(dist.conditionals.f, row), col)
    density_uv = f_at * float(GRID_W * GRID_H) / total
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    return density_uv / (TWO_PI2 * sin_t)
