"""BSDF sample / pdf / eval with masked dispatch (port of ``terra_tpu/bsdf.py``).

Every lobe the scene uses (``MaterialTable.types_present``) is evaluated
wavefront-wide and each lane selects its material's result by mask. This
slice ports the lobes of its scenes: DIFFUSE (cosine-weighted Lambert) and
GGX (Cook-Torrance with Smith G and Schlick Fresnel, mixed with a diffuse
lobe). A scene that uses PHONG, MIRROR, DISNEY or GLASS raises
``NotImplementedError`` (ROADMAP queue A, bsdf.py).
"""
from __future__ import annotations

import math

import torch

from .ops import math3
from .scene import ATTR, BSDFType
from .surface import Surface

__all__ = ["sample", "pdf", "eval_f", "continuation_factors", "delta_mask",
           "DELTA_TYPES", "PORTED_TYPES"]

DELTA_TYPES = (3, 5)  # MIRROR, GLASS
PORTED_TYPES = (BSDFType.DIFFUSE, BSDFType.GGX)
PI = math.pi
INV_PI = 1.0 / math.pi


def _check(present):
    missing = [BSDFType(t).name for t in present if t not in PORTED_TYPES]
    if missing:
        raise NotImplementedError(
            f"BSDF lobes {missing} are not ported yet (ROADMAP queue A, bsdf.py); "
            f"ported: {[t.name for t in PORTED_TYPES]}")


def _cosine_hemisphere(surface: Surface, e1, e2):
    r = torch.sqrt(e1)
    theta = 2.0 * PI * e2
    local = torch.stack([r * torch.cos(theta), torch.sqrt(torch.clamp(1.0 - e1, min=0.0)),
                         r * torch.sin(theta)], dim=-1)
    wi = math3.to_world(local, surface.tangent, surface.normal, surface.bitangent)
    return math3.normalize(wi)


def _diffuse_pdf(surface: Surface, wi):
    return torch.clamp(math3.dot(surface.normal, wi), min=0.0) * INV_PI


def _diffuse_eval(surface: Surface, wi, wo):
    return surface.attrs[..., ATTR.DIFFUSE_ALBEDO, :] * INV_PI


def _schlick_weight(cos_theta):
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _ggx_params(surface: Surface):
    rough = torch.clamp(surface.attrs[..., ATTR.GGX_ROUGHNESS, 0], 1e-3, 1.0)
    metal = torch.clamp(surface.attrs[..., ATTR.GGX_METALNESS, 0], 0.0, 1.0)
    albedo = surface.attrs[..., ATTR.GGX_ALBEDO, :]
    return albedo, rough, metal, rough * rough


def _ggx_D(noh, alpha):
    a2 = alpha * alpha
    den = noh * noh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * den * den, min=1e-8)


def _smith_g1(nov, alpha):
    a2 = alpha * alpha
    return 2.0 * nov / torch.clamp(nov + torch.sqrt(a2 + (1.0 - a2) * nov * nov), min=1e-8)


def _ggx_F0(surface: Surface, albedo, metal):
    ior = surface.ior
    f = (1.0 - ior) / (1.0 + ior)
    f0 = (f * f)[..., None] * torch.ones_like(albedo)
    return math3.lerp(f0, albedo, metal[..., None])


def _ggx_pick_diffuse(metal):
    return torch.clamp(1.0 - metal * 0.5 - 0.25, 0.05, 0.95)


def _ggx_sample(surface: Surface, e1, e2, e3, wo):
    """Diffuse with probability pd, else a GGX half-vector reflection."""
    _, _, metal, alpha = _ggx_params(surface)
    take_diffuse = e3 < _ggx_pick_diffuse(metal)
    wi_d = _cosine_hemisphere(surface, e1, e2)
    tan_theta = alpha * torch.sqrt(e1) / torch.sqrt(torch.clamp(1.0 - e1, min=1e-8))
    cos_theta = torch.reciprocal(torch.sqrt(1.0 + tan_theta * tan_theta))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * e2
    local_h = torch.stack([sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1)
    h = math3.normalize(math3.to_world(local_h, surface.tangent, surface.normal, surface.bitangent))
    wi_s = math3.normalize(math3.reflect(wo, h))
    return torch.where(take_diffuse[..., None], wi_d, wi_s)


def _ggx_pdf(surface: Surface, wi, wo):
    _, _, metal, alpha = _ggx_params(surface)
    pd = _ggx_pick_diffuse(metal)
    h = math3.normalize(wi + wo)
    noh = torch.clamp(math3.dot(surface.normal, h), min=0.0)
    hov = torch.clamp(math3.dot(h, wo), min=1e-6)
    spec_pdf = _ggx_D(noh, alpha) * noh / (4.0 * hov)
    return pd * _diffuse_pdf(surface, wi) + (1.0 - pd) * spec_pdf


def _ggx_eval(surface: Surface, wi, wo):
    albedo, _, metal, alpha = _ggx_params(surface)
    n = surface.normal
    nol = torch.clamp(math3.dot(n, wi), min=1e-6)
    nov = torch.clamp(math3.dot(n, wo), min=1e-6)
    h = math3.normalize(wi + wo)
    noh = torch.clamp(math3.dot(n, h), min=0.0)
    loh = torch.clamp(math3.dot(wi, h), min=0.0)
    f0 = _ggx_F0(surface, albedo, metal)
    F = f0 + (1.0 - f0) * _schlick_weight(loh)[..., None]
    D = _ggx_D(noh, alpha)
    G = _smith_g1(nol, alpha) * _smith_g1(nov, alpha)
    spec = F * (D * G / (4.0 * nol * nov))[..., None]
    diff = albedo * INV_PI * (1.0 - metal)[..., None] * (1.0 - F)
    return spec + diff


def delta_mask(surface: Surface, present):
    """Per-lane mask of delta lobes, or None when the scene has none."""
    _check(present)
    return None


def _select(bsdf_type, results: dict, present):
    present = tuple(present)
    out = results[present[0]]
    for ty in present[1:]:
        r = results[ty]
        mask = bsdf_type == ty
        if r.dim() > mask.dim():
            mask = mask[..., None]
        out = torch.where(mask, r, out)
    return out


def sample(surface: Surface, e0, e1, e2, wo, present):
    """Importance sample. Returns (wi, aux); aux (the Phong lobe pick in
    the reference) is 0 for the ported lobes."""
    _check(present)
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _cosine_hemisphere(surface, e0, e1)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_sample(surface, e0, e1, e2, wo)
    wi = _select(surface.bsdf_type, results, present)
    return wi, torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)


def pdf(surface: Surface, wi, wo, aux, present):
    _check(present)
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_pdf(surface, wi)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_pdf(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def eval_f(surface: Surface, wi, wo, present):
    """f(wi, wo), (N, 3)."""
    _check(present)
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_eval(surface, wi, wo)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_eval(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def continuation_factors(surface: Surface, wi, present):
    """(cos factor, offset sign) of the path continuation; the sign is None
    without transmissive lobes (none is ported)."""
    _check(present)
    return math3.dot(surface.normal, wi), None
