"""Vectorized 3D vector math over stacked ``(..., 3)`` tensors.

PyTorch port of ``terra_tpu/ops/math3.py``: the same batched helpers, the
same operation order (so results agree with the JAX package up to the
rounding of each backend's elementwise kernels). Left-handed, Y-up.
"""
from __future__ import annotations

import torch

__all__ = [
    "dot", "cross", "length", "sqlen", "normalize", "lerp", "luminance",
    "reflect", "max3", "build_basis", "to_local", "to_world", "safe_sqrt",
]

EPS = 1e-4


def dot(a, b):
    """Batched dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Batched cross product, expanded by components."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def sqlen(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(sqlen(a))


def normalize(a, eps: float = 1e-20):
    """Safe normalize; ``eps`` guards the zero vector."""
    return a * torch.reciprocal(torch.sqrt(torch.clamp(sqlen(a), min=eps)))[..., None]


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, grad * 0.5 / y, 0.0)


def safe_sqrt(x):
    """``torch.sqrt`` (the same bits) whose gradient is 0 where the root is
    0, not inf. The samplers' ``sqrt(max(1 - c^2, 0))`` rounds to exactly 0
    for a sample within ~1e-6 of the pole, and there the plain derivative,
    in ``jax.grad`` as in torch, is inf: one such lane in a million made a
    whole roughness gradient inf."""
    return _SafeSqrt.apply(x)


def lerp(a, b, t):
    return a + (b - a) * t


def luminance(c):
    """Rec.601 weights."""
    return 0.212655 * c[..., 0] + 0.715158 * c[..., 1] + 0.072187 * c[..., 2]


def reflect(wo, n):
    """``2 (wo . n) n - wo``."""
    return 2.0 * dot(wo, n)[..., None] * n - wo


def max3(c):
    return torch.amax(c, dim=-1)


def build_basis(n):
    """Orthonormal (tangent, bitangent) with local +Y the normal and
    ``cross(n, tangent) == bitangent`` (Hughes-Moller, normalized)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    cond = torch.abs(nx) > torch.abs(ny)
    inv_a = torch.reciprocal(torch.sqrt(torch.where(cond, nx * nx + nz * nz, ny * ny + nz * nz)))
    zero = torch.zeros_like(nz)
    tx = torch.where(cond, nz * inv_a, zero)
    ty = torch.where(cond, zero, -nz * inv_a)
    tz = torch.where(cond, -nx * inv_a, ny * inv_a)
    tangent = torch.stack([tx, ty, tz], dim=-1)
    return tangent, cross(n, tangent)


def to_world(local, tangent, normal, bitangent):
    """Local (x=tangent, y=normal, z=bitangent) to world."""
    return local[..., 0:1] * tangent + local[..., 1:2] * normal + local[..., 2:3] * bitangent


def to_local(world, tangent, normal, bitangent):
    return torch.stack([dot(world, tangent), dot(world, normal), dot(world, bitangent)], dim=-1)
