"""Batched pinhole camera ray generation (port of ``terra_tpu/camera.py``).
Left-handed, Y-up, the camera looks down +Z in camera space."""
from __future__ import annotations

import numpy as np
import torch

from .ops import math3
from .scene import Camera

__all__ = ["camera_basis", "generate_rays"]

DEG2RAD = 0.0174533  # the reference's constant


def camera_basis(camera: Camera):
    """World-space (x, y, z) camera axes: z = normalize(dir),
    x = normalize(up x z), y = z x x."""
    zaxis = math3.normalize(camera.direction)
    xaxis = math3.normalize(math3.cross(camera.up, zaxis))
    return xaxis, math3.cross(zaxis, xaxis), zaxis


def generate_rays(camera: Camera, width: int, height: int, px, py, jitter, r1, r2):
    """Primary rays for lane tensors of pixel columns ``px`` and rows
    ``py``; ``r1``/``r2`` are the jitter uniforms. Returns (origins,
    normalized directions), each (N, 3) f32."""
    jitter = float(jitter)
    dx = -jitter + 2.0 * r1 * jitter
    dy = -jitter + 2.0 * r2 * jitter
    ndc_x = (px.to(torch.float32) + 0.5 + dx) / float(width)
    ndc_y = (py.to(torch.float32) + 0.5 + dy) / float(height)
    screen_x = 2.0 * ndc_x - 1.0
    screen_y = 1.0 - 2.0 * ndc_y
    # the aspect rounded to f32 on the host, a kernel argument (no copy to
    # the device, so the function can run inside a captured CUDA graph)
    aspect = float(np.float32(width / height))
    tan_half_fov = torch.tan(camera.fov_deg * DEG2RAD / 2.0)
    frustum_x = screen_x * aspect * tan_half_fov
    frustum_y = screen_y * tan_half_fov
    local = math3.normalize(torch.stack([frustum_x, frustum_y, torch.ones_like(frustum_x)], dim=-1))
    xaxis, yaxis, zaxis = camera_basis(camera)
    directions = local[..., 0:1] * xaxis + local[..., 1:2] * yaxis + local[..., 2:3] * zaxis
    return camera.position.expand(directions.shape), directions
