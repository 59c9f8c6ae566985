"""BSDF sample / pdf / eval with masked dispatch (port of ``terra_tpu/bsdf.py``).

Every lobe the scene uses (``MaterialTable.types_present``) is evaluated
wavefront-wide and each lane selects its material's result by mask:

  DIFFUSE  cosine-weighted Lambert;
  PHONG    kd/ks energy split and a lobe roulette; the lobe pick rides from
           :func:`sample` to :func:`pdf` as the explicit ``aux`` value;
  GGX      Cook-Torrance (Smith G, Schlick Fresnel) mixed with a diffuse lobe;
  MIRROR   perfect specular delta lobe;
  DISNEY   the principled eval, a three-lobe mixture sampler (cosine
           diffuse / GTR2-aniso specular / GTR1 clearcoat) and its pdf;
  GLASS    dielectric delta lobes: Fresnel (Schlick) roulette between
           reflection and refraction, total internal reflection, and the
           transmitted continuation (``continuation_factors``).

Same formulas and operation order as the reference; results agree up to
the rounding of each backend's elementwise kernels (pow, sin, cos). The
samplers' ``sqrt(max(1 - c^2, 0))`` take ``math3.safe_sqrt``: the same
values, and a gradient of 0 where a sample at the lobe's pole rounds the
root to 0, where the reference's gradient is inf.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import math3
from .scene import ATTR, BSDFType
from .surface import Surface

__all__ = ["sample", "pdf", "eval_f", "continuation_factors", "delta_mask",
           "DELTA_TYPES", "NUM_BSDF_TYPES", "ALL_TYPES"]

NUM_BSDF_TYPES = 6
ALL_TYPES = tuple(range(NUM_BSDF_TYPES))
# Delta lobes: their "pdf" is not a density, so NEE and the MIS BSDF
# strategy skip delta lanes and the continuation picks up the next hit's
# emissive instead (the specular-bounce flag, ``emit_ok``).
DELTA_TYPES = (3, 5)  # MIRROR, GLASS
PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
EPS = 1e-4


def _cosine_hemisphere(surface: Surface, e1, e2):
    r = torch.sqrt(e1)
    theta = 2.0 * PI * e2
    local = torch.stack([r * torch.cos(theta), torch.sqrt(torch.clamp(1.0 - e1, min=0.0)),
                         r * torch.sin(theta)], dim=-1)
    wi = math3.to_world(local, surface.tangent, surface.normal, surface.bitangent)
    return math3.normalize(wi)


def _unit_world(local, t, n, b):
    return math3.normalize(math3.to_world(local, t, n, b))


# ------------------------------------------------------------------ diffuse

def _diffuse_pdf(surface: Surface, wi):
    return torch.clamp(math3.dot(surface.normal, wi), min=0.0) * INV_PI


def _diffuse_eval(surface: Surface, wi, wo):
    return surface.attrs[..., ATTR.DIFFUSE_ALBEDO, :] * INV_PI


# -------------------------------------------------------------------- phong

def _phong_kd_ks(surface: Surface):
    albedo = surface.attrs[..., ATTR.PHONG_ALBEDO, :]
    spec = surface.attrs[..., ATTR.PHONG_SPECULAR_COLOR, :]
    diffuse = torch.clamp(albedo.sum(dim=-1), min=EPS)
    specular = spec.sum(dim=-1)
    kd_a = 0.5 * diffuse / torch.clamp(specular, min=EPS)
    ks_b = 0.5 * specular / diffuse
    kd = torch.where(specular > diffuse, kd_a, 1.0 - ks_b)
    return kd, 1.0 - kd


def _phong_sample(surface: Surface, e1, e2, e3, wo):
    """Returns (wi, lobe): lobe +1 diffuse, -1 specular."""
    kd, _ = _phong_kd_ks(surface)
    take_diffuse = e3 < kd
    wi_d = _cosine_hemisphere(surface, e1, e2)
    wr = math3.reflect(wo, surface.normal)
    t, b = math3.build_basis(wr)
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    phi = 2.0 * PI * e1
    cos_theta = torch.pow(torch.clamp(1.0 - e2, min=0.0), 1.0 / (n_exp + 1.0))
    sin_theta = math3.safe_sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = torch.stack([sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)],
                        dim=-1)
    wi_s = _unit_world(local, t, wr, b)
    wi = torch.where(take_diffuse[..., None], wi_d, wi_s)
    return wi, torch.where(take_diffuse, 1.0, -1.0)


def _phong_cos_alpha(surface: Surface, wi, wo):
    wr = math3.reflect(wo, surface.normal)
    return torch.clamp(math3.dot(wi, wr), min=0.0)


def _phong_pdf(surface: Surface, wi, wo, lobe):
    """pdf of the picked lobe (the reference's semantics)."""
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    spec_pdf = (n_exp + 1.0) / (2.0 * PI) * torch.pow(_phong_cos_alpha(surface, wi, wo), n_exp)
    return torch.where(lobe > 0.0, _diffuse_pdf(surface, wi), spec_pdf)


def _phong_eval(surface: Surface, wi, wo):
    kd, ks = _phong_kd_ks(surface)
    albedo = surface.attrs[..., ATTR.PHONG_ALBEDO, :]
    spec = surface.attrs[..., ATTR.PHONG_SPECULAR_COLOR, :]
    n_exp = surface.attrs[..., ATTR.PHONG_SPECULAR_INTENSITY, 0]
    cos_alpha = _phong_cos_alpha(surface, wi, wo)
    diffuse_term = albedo * (kd * INV_PI)[..., None]
    spec_term = spec * (ks * torch.pow(cos_alpha, n_exp) * (n_exp + 2.0) / (2.0 * PI))[..., None]
    return diffuse_term + spec_term


# ---------------------------------------------------------------------- ggx

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
    sin_theta = math3.safe_sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * e2
    local_h = torch.stack([sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)],
                          dim=-1)
    h = _unit_world(local_h, surface.tangent, surface.normal, surface.bitangent)
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


# ------------------------------------------------------------------- disney

def _disney_params(surface: Surface):
    """Slots: base_color; [specular, specular_tint]; [sheen, sheen_tint];
    [clearcoat, clearcoat_gloss]; [metalness, roughness]; [anisotropic,
    subsurface]."""
    a = surface.attrs
    return (a[..., 0, :], a[..., 1, 0], a[..., 1, 1], a[..., 2, 0], a[..., 2, 1], a[..., 3, 0],
            a[..., 3, 1], a[..., 4, 0], a[..., 4, 1], a[..., 5, 0], a[..., 5, 1])


def _gtr1(ndoth, a):
    """Computed with positive factors for a < 1 (both a2 - 1 and log(a2)
    are negative there), so the epsilon guard cannot flip the sign."""
    a2 = torch.clamp(a * a, min=1e-6)
    t = torch.clamp(1.0 + (a2 - 1.0) * ndoth * ndoth, min=1e-8)
    val = (1.0 - a2) / torch.clamp(PI * (-torch.log(a2)) * t, min=1e-8)
    return torch.where(a >= 1.0, torch.full_like(ndoth, INV_PI), val)


def _gtr2_aniso(ndoth, hdx, hdy, ax, ay):
    x = hdx / ax
    y = hdy / ay
    s = x * x + y * y + ndoth * ndoth
    return 1.0 / torch.clamp(PI * ax * ay * s * s, min=1e-8)


def _smith_ggx_aniso(ndotv, vdx, vdy, ax, ay):
    x = vdx * ax
    y = vdy * ay
    return 1.0 / torch.clamp(ndotv + torch.sqrt(x * x + y * y + ndotv * ndotv), min=1e-8)


def _smith_ggx(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / torch.clamp(ndotv + torch.sqrt(a + b - a * b), min=1e-8)


def _disney_eval(surface: Surface, wi, wo):
    (base_color, specular, specular_tint, sheen_p, sheen_tint, clearcoat, clearcoat_gloss,
     metalness, roughness, anisotropic, subsurface) = _disney_params(surface)
    n = surface.normal
    ndotl = math3.dot(n, wi)
    ndotv = math3.dot(n, wo)
    behind = (ndotl < 0.0) | (ndotv < 0.0)
    ndotl = torch.clamp(ndotl, min=1e-6)
    ndotv = torch.clamp(ndotv, min=1e-6)
    h = math3.normalize(wi + wo)
    ndoth = math3.dot(n, h)
    ldoth = math3.dot(wi, h)
    lum = 0.3 * base_color[..., 0] + 0.6 * base_color[..., 1] + 1.0 * base_color[..., 2]
    tint = torch.where((lum > 0.0)[..., None],
                       base_color / torch.clamp(lum, min=1e-8)[..., None], 1.0)
    ones = torch.ones_like(base_color)
    spec0 = math3.lerp(ones, tint, specular_tint[..., None]) * (specular * 0.8)[..., None]
    spec0 = math3.lerp(spec0, base_color, metalness[..., None])
    sheen_c = math3.lerp(ones, tint, sheen_tint[..., None])
    fl = _schlick_weight(ndotl)
    fv = _schlick_weight(ndotv)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = math3.lerp(1.0, fd90, fl) * math3.lerp(1.0, fd90, fv)
    fss90 = ldoth * ldoth * roughness
    fss = math3.lerp(1.0, fss90, fl) * math3.lerp(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / (ndotl * ndotv) - 0.5) + 0.5)
    aspect = torch.sqrt(torch.clamp(1.0 - anisotropic * 0.9, min=1e-4))
    ax = torch.clamp(roughness * roughness / aspect, min=1e-3)
    ay = torch.clamp(roughness * roughness * aspect, min=1e-3)
    X, Y = surface.tangent, surface.bitangent
    ds = _gtr2_aniso(ndoth, math3.dot(h, X), math3.dot(h, Y), ax, ay)
    fh = _schlick_weight(ldoth)
    fs = math3.lerp(spec0, torch.ones_like(spec0), fh[..., None])
    gs = _smith_ggx_aniso(ndotl, math3.dot(wi, X), math3.dot(wi, Y), ax, ay)
    gs = gs * _smith_ggx_aniso(ndotv, math3.dot(wo, X), math3.dot(wo, Y), ax, ay)
    sheen = sheen_c * (fh * sheen_p)[..., None]
    dr = _gtr1(ndoth, math3.lerp(0.1, 0.001, clearcoat_gloss))
    fr = math3.lerp(0.04, 1.0, fh)
    gr = _smith_ggx(ndotl, 0.25) * _smith_ggx(ndotv, 0.25)
    result_a = base_color * (INV_PI * math3.lerp(fd, ss, subsurface))[..., None]
    result_a = (result_a + sheen) * (1.0 - metalness)[..., None]
    result_b = fs * (gs * ds)[..., None]
    result_c = (0.25 * clearcoat * gr * fr * dr)[..., None] * torch.ones_like(result_b)
    return torch.where(behind[..., None], 0.0, result_a + result_b + result_c)


def _disney_lobe_probs(surface: Surface):
    """Pick probabilities (diffuse, GTR2 specular, GTR1 clearcoat)."""
    a = surface.attrs
    metalness = torch.clamp(a[..., 4, 0], 0.0, 1.0)
    clearcoat = torch.clamp(a[..., 3, 0], 0.0, 1.0)
    p_clear = 0.25 * clearcoat / (1.0 + clearcoat)
    p_spec_inner = math3.lerp(0.5, 1.0, metalness)
    return ((1.0 - p_clear) * (1.0 - p_spec_inner), (1.0 - p_clear) * p_spec_inner, p_clear)


def _disney_alphas(surface: Surface):
    a = surface.attrs
    roughness = torch.clamp(a[..., 4, 1], 0.0, 1.0)
    anisotropic = torch.clamp(a[..., 5, 0], 0.0, 1.0)
    clearcoat_gloss = torch.clamp(a[..., 3, 1], 0.0, 1.0)
    aspect = torch.sqrt(torch.clamp(1.0 - anisotropic * 0.9, min=1e-4))
    ax = torch.clamp(roughness * roughness / aspect, min=1e-3)
    ay = torch.clamp(roughness * roughness * aspect, min=1e-3)
    return ax, ay, math3.lerp(0.1, 0.001, clearcoat_gloss)


def _disney_sample(surface: Surface, e0, e1, e2, wo):
    """e2 picks the lobe, (e0, e1) drive it. GTR2-aniso half vector
    h ~ sqrt(e0 / (1 - e0)) (ax cos(phi) X + ay sin(phi) Z) + N; GTR1
    cos^2(theta) = (1 - a2^(1 - e0)) / (1 - a2)."""
    p_diff, p_spec, _ = _disney_lobe_probs(surface)
    ax, ay, a_clear = _disney_alphas(surface)
    n, tx, bz = surface.normal, surface.tangent, surface.bitangent
    wi_d = _cosine_hemisphere(surface, e0, e1)
    phi = 2.0 * PI * e1
    tanv = torch.sqrt(e0 / torch.clamp(1.0 - e0, min=1e-7))
    hx = tanv * ax * torch.cos(phi)
    hz = tanv * ay * torch.sin(phi)
    h_spec = math3.normalize(tx * hx[..., None] + n + bz * hz[..., None])
    wi_s = math3.normalize(math3.reflect(wo, h_spec))
    a2 = a_clear * a_clear
    cos2 = (1.0 - torch.pow(a2, 1.0 - e0)) / torch.clamp(1.0 - a2, min=1e-7)
    cos_t = math3.safe_sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = math3.safe_sqrt(torch.clamp(1.0 - cos2, min=0.0))
    local_h = torch.stack([sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi)], dim=-1)
    wi_c = math3.normalize(math3.reflect(wo, _unit_world(local_h, tx, n, bz)))
    return torch.where((e2 < p_diff)[..., None], wi_d,
                       torch.where((e2 < p_diff + p_spec)[..., None], wi_s, wi_c))


def _disney_pdf(surface: Surface, wi, wo):
    """Mixture pdf of any direction (the MIS light strategy needs it);
    pdf_h -> pdf_wi Jacobian 1 / (4 h.wo)."""
    p_diff, p_spec, p_clear = _disney_lobe_probs(surface)
    ax, ay, a_clear = _disney_alphas(surface)
    n = surface.normal
    h = math3.normalize(wi + wo)
    noh = torch.clamp(math3.dot(n, h), min=1e-6)
    how = torch.clamp(math3.dot(h, wo), min=1e-6)
    ds = _gtr2_aniso(noh, math3.dot(h, surface.tangent), math3.dot(h, surface.bitangent), ax, ay)
    dr = _gtr1(noh, a_clear)
    pdf_spec = ds * noh / (4.0 * how)
    pdf_clear = dr * noh / (4.0 * how)
    return p_diff * _diffuse_pdf(surface, wi) + p_spec * pdf_spec + p_clear * pdf_clear


# ------------------------------------------------------------------- mirror

def _aligned(wi, w):
    return math3.dot(wi, w) > (1.0 - 1e-5)


def _mirror_sample(surface: Surface, wo):
    return math3.normalize(math3.reflect(wo, surface.normal))


def _mirror_pdf(surface: Surface, wi, wo):
    """1 on the reflection ray, 0 elsewhere (NEE and MIS directions)."""
    return torch.where(_aligned(wi, math3.reflect(wo, surface.normal)), 1.0, 0.0)


def _mirror_eval(surface: Surface, wi, wo):
    """color / NoL on the reflection ray, so eval * NoL / pdf = color."""
    color = surface.attrs[..., ATTR.MIRROR_COLOR, :]
    aligned = _aligned(wi, math3.reflect(wo, surface.normal))
    nol = torch.clamp(math3.dot(surface.normal, wi), min=1e-6)
    return torch.where(aligned[..., None], color / nol[..., None], 0.0)


# -------------------------------------------------------------------- glass

def _glass_geometry(surface: Surface, wo):
    """Side-aware normal, reflection and transmission directions, the
    Schlick Fresnel R (1 under total internal reflection) and the TIR flag."""
    n = surface.normal
    ior = torch.clamp(surface.ior, min=1.0 + 1e-4)
    now = math3.dot(n, wo)
    entering = now > 0.0
    n_eff = torch.where(entering[..., None], n, -n)
    cos_i = torch.abs(now)
    eta = torch.where(entering, 1.0 / ior, ior)  # n1 / n2
    refl = math3.normalize(math3.reflect(wo, n_eff))
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = cos_t2 < 0.0
    cos_t = math3.safe_sqrt(torch.clamp(cos_t2, min=0.0))
    tbase = torch.where(eta <= 1.0, cos_i, cos_t)
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    R = r0 + (1.0 - r0) * _schlick_weight(tbase)
    R = torch.where(tir, 1.0, torch.clamp(R, 0.0, 1.0))
    trans = math3.normalize(-wo * eta[..., None] + n_eff * (eta * cos_i - cos_t)[..., None])
    trans = torch.where(tir[..., None], refl, trans)
    return refl, trans, R, tir


def _glass_sample(surface: Surface, e2, wo):
    """Reflect with probability R (always under TIR), else refract."""
    refl, trans, R, _ = _glass_geometry(surface, wo)
    return torch.where((e2 < R)[..., None], refl, trans)


def _glass_match(surface: Surface, wi, wo):
    """(weight of the lobe ``wi`` matches, matched?): R on the reflection
    ray, 1 - R on the transmission ray."""
    refl, trans, R, tir = _glass_geometry(surface, wo)
    aligned_r = _aligned(wi, refl)
    aligned_t = ~tir & _aligned(wi, trans) & ~aligned_r
    w = torch.where(aligned_r, R, torch.where(aligned_t, 1.0 - R, 0.0))
    return w, aligned_r | aligned_t


def _glass_pdf(surface: Surface, wi, wo):
    return _glass_match(surface, wi, wo)[0]


def _glass_eval(surface: Surface, wi, wo):
    """tint * lobe weight / |NoL| on the two delta rays (|NoL|:
    transmission crosses the surface), 0 elsewhere."""
    color = surface.attrs[..., ATTR.GLASS_COLOR, :]
    w, matched = _glass_match(surface, wi, wo)
    anol = torch.clamp(torch.abs(math3.dot(surface.normal, wi)), min=1e-6)
    return torch.where(matched[..., None], color * (w / anol)[..., None], 0.0)


# ----------------------------------------------------------------- dispatch

def delta_mask(surface: Surface, present=ALL_TYPES):
    """Per-lane mask of delta (MIRROR/GLASS) materials, or None when the
    scene has none."""
    types = [t for t in DELTA_TYPES if t in present]
    if not types:
        return None
    m = surface.bsdf_type == types[0]
    for t in types[1:]:
        m = m | (surface.bsdf_type == t)
    return m


def _select(bsdf_type, results: dict, present):
    """Each lane takes its material's entry of {type: value}, over the
    types the scene uses."""
    present = tuple(present)
    out = results[present[0]]
    for ty in present[1:]:
        r = results[ty]
        mask = bsdf_type == ty
        if r.dim() > mask.dim():
            mask = mask[..., None]
        out = torch.where(mask, r, out)
    return out


def sample(surface: Surface, e0, e1, e2, wo, present=ALL_TYPES):
    """Importance sample. Returns (wi, aux); aux is the Phong lobe pick
    (+1 diffuse, -1 specular) on Phong lanes, 0 elsewhere, and goes into
    :func:`pdf`."""
    results = {}
    lobe = None
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _cosine_hemisphere(surface, e0, e1)
    if BSDFType.PHONG in present:
        results[BSDFType.PHONG], lobe = _phong_sample(surface, e0, e1, e2, wo)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_sample(surface, e0, e1, e2, wo)
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_sample(surface, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_sample(surface, e0, e1, e2, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_sample(surface, e2, wo)
    wi = _select(surface.bsdf_type, results, present)
    if lobe is None:
        return wi, torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    return wi, torch.where(surface.bsdf_type == BSDFType.PHONG, lobe, 0.0)


def pdf(surface: Surface, wi, wo, aux, present=ALL_TYPES):
    """pdf of ``wi``; ``aux`` is the lobe pick of this bounce's sample."""
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_pdf(surface, wi)
    if BSDFType.PHONG in present:
        results[BSDFType.PHONG] = _phong_pdf(surface, wi, wo, aux)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_pdf(surface, wi, wo)
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_pdf(surface, wi, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_pdf(surface, wi, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_pdf(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def eval_f(surface: Surface, wi, wo, present=ALL_TYPES):
    """f(wi, wo), (N, 3)."""
    results = {}
    if BSDFType.DIFFUSE in present:
        results[BSDFType.DIFFUSE] = _diffuse_eval(surface, wi, wo)
    if BSDFType.PHONG in present:
        results[BSDFType.PHONG] = _phong_eval(surface, wi, wo)
    if BSDFType.GGX in present:
        results[BSDFType.GGX] = _ggx_eval(surface, wi, wo)
    if BSDFType.MIRROR in present:
        results[BSDFType.MIRROR] = _mirror_eval(surface, wi, wo)
    if BSDFType.DISNEY in present:
        results[BSDFType.DISNEY] = _disney_eval(surface, wi, wo)
    if BSDFType.GLASS in present:
        results[BSDFType.GLASS] = _glass_eval(surface, wi, wo)
    return _select(surface.bsdf_type, results, present)


def continuation_factors(surface: Surface, wi, present=ALL_TYPES):
    """(cos factor, offset sign) of the path continuation: the signed N.wi
    and a +normal origin offset, except on GLASS lanes, which take |N.wi|
    and offset to the side ``wi`` leaves through. The sign is None when the
    scene has no glass."""
    nol = math3.dot(surface.normal, wi)
    if BSDFType.GLASS not in present:
        return nol, None
    is_glass = surface.bsdf_type == BSDFType.GLASS
    sign = torch.where(is_glass & (nol < 0.0), -1.0, 1.0)
    return torch.where(is_glass, torch.abs(nol), nol), sign
