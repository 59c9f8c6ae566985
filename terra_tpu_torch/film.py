"""Film accumulation buffers and tonemapping (port of ``terra_tpu/film.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .scene import Tonemap

__all__ = ["Film", "tonemap", "develop"]


@dataclass
class Film:
    """acc (H, W, 3) f32 radiance sum; samples (H, W) i32 sample counts."""

    acc: torch.Tensor
    samples: torch.Tensor

    @staticmethod
    def create(width: int, height: int, device) -> "Film":
        return Film(acc=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
                    samples=torch.zeros((height, width), dtype=torch.int32, device=device))

    def clear(self) -> "Film":
        return Film(acc=torch.zeros_like(self.acc), samples=torch.zeros_like(self.samples))

    def mean(self) -> torch.Tensor:
        """Progressive estimate acc / samples."""
        return self.acc / torch.clamp(self.samples, min=1).to(torch.float32)[..., None]


def _uncharted2_curve(x):
    A, B, C, D, E, F = 0.15, 0.5, 0.1, 0.2, 0.02, 0.3
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap(color, operator: Tonemap, exposure: float = 1.0, gamma: float = 2.2):
    """Exposure, then the tonemap operator on linear (..., 3) color."""
    color = color * exposure
    inv_gamma = 1.0 / gamma
    operator = Tonemap(int(operator))
    if operator == Tonemap.NONE:
        return color
    if operator == Tonemap.LINEAR:
        return torch.pow(torch.clamp(color, min=0.0), inv_gamma)
    if operator == Tonemap.REINHARD:
        return torch.pow(torch.clamp(color / (1.0 + color), min=0.0), inv_gamma)
    if operator == Tonemap.FILMIC:
        x = torch.clamp(color - 0.004, min=0.0)
        return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    white_scale = 1.0 / _uncharted2_curve(torch.tensor(11.2, dtype=torch.float32))
    c = _uncharted2_curve(color * 2.0) * white_scale.to(color.device)
    return torch.pow(torch.clamp(c, min=0.0), inv_gamma)


def develop(film: Film, operator: Tonemap = Tonemap.NONE, exposure: float = 1.0,
            gamma: float = 2.2):
    """Film -> display image: mean, exposure, tonemap."""
    return tonemap(film.mean(), operator, exposure, gamma)
