"""Wavefront integrator passes (port of ``terra_tpu/integrators.py``):
SIMPLE (emissive only), DIRECT (next-event estimation), DIRECT_MIS (NEE
plus BSDF sampling, power-2 MIS), each with environment NEE when the
context carries an env proposal (``ctx['env_dist']``), and the four debug
views (first-hit mask, depth, normals, MIS weights). Each pass returns
per-lane radiance already multiplied by the throughput."""
from __future__ import annotations

from typing import Callable

import torch

from . import bsdf, envmap, lights
from .intersect import mask_dead_rays
from .ops import math3
from .ops.rng import PathStreams as S
from .scene import Integrator, Scene
from .surface import Surface, surface_init

__all__ = ["make_integrator"]

# Shadow-ray range: hits within t_max*(1-1e-3) occlude, so the sampled
# light point never occludes itself.
SHADOW_TMAX_SCALE = 1.0 - 1e-3
PDF_CLAMP = 1e17  # keeps pdf^2 finite in f32
FAR_PLANE = 500.0  # far plane of the depth view


def _power2_weight(pa, pb):
    """Power-2 MIS weight of strategy a against b, pdfs clamped first."""
    pa = torch.clamp(pa, max=PDF_CLAMP)
    pb = torch.clamp(pb, max=PDF_CLAMP)
    return (pa * pa) / torch.clamp(pa * pa + pb * pb, min=1e-20)


def _emit_gate(ctx, bounce):
    """Emissive pickup: at bounce 0, or after a delta lobe when the scene
    has one (``ctx['emit_ok']``). ``bounce`` is an int or a lane tensor."""
    ok = ctx.get("emit_ok")
    return bounce == 0 if ok is None else ok


def _skip_delta(ctx, mask):
    delta = ctx.get("delta")
    return mask if delta is None else mask & ~delta


def _shadow_ray(surf: Surface, wi, ctx):
    """Ray leaving the surface along ``wi``; dead lanes become miss rays."""
    o, d = surf.point + surf.normal * 1e-4, wi
    return mask_dead_rays(ctx["active"], o, d)


def _integrate_simple(ctx, surf: Surface, wo, throughput, bounce):
    facing = math3.dot(wo, surf.normal) > 0.0
    return torch.where(facing[..., None], surf.emissive, 0.0) * throughput


def _nee_light_strategy(ctx, surf: Surface, wo, bounce, want_weight: bool, aux):
    """Light sampling shared by DIRECT and DIRECT_MIS. Returns
    (contribution, weight, light sample)."""
    scene: Scene = ctx["scene"]
    rng = ctx["rng"]
    ls = lights.pick_and_sample(scene, rng(bounce, S.LIGHT_PICK), rng(bounce, S.LIGHT_U),
                                rng(bounce, S.LIGHT_V), ctx["tables"].light,
                                area_weighted=ctx["light_area"])
    p_to_light = ls.pos - surf.point
    wi = math3.normalize(p_to_light)
    o_sh, d_sh = _shadow_ray(surf, wi, ctx)
    t_light = math3.length(ls.pos - o_sh) * SHADOW_TMAX_SCALE
    occ = ctx["raycast"](o_sh, d_sh, t_max=t_light, any_hit=True, sort_hint=ctx["hit_tri"])
    visible = ~occ.hit
    cos_l = math3.dot(ls.normal, -wi)
    visible = _skip_delta(ctx, visible & (cos_l > 0.0))
    light_pdf = math3.sqlen(p_to_light) / torch.clamp(torch.abs(cos_l * ls.area), min=1e-12)
    f = bsdf.eval_f(surf, wi, wo, ctx["present"])
    nol = math3.dot(wi, surf.normal)
    if want_weight:
        bsdf_pdf = bsdf.pdf(surf, wi, wo, aux, ctx["present"])
        weight = _power2_weight(light_pdf, bsdf_pdf)
        visible = visible & (light_pdf != 0.0)
    else:
        weight = torch.ones_like(light_pdf)
    denom = torch.where(visible, light_pdf * ls.pick_pdf, 1.0)
    contrib = ls.emissive * f * (nol * weight / denom)[..., None]
    contrib = torch.where(visible[..., None], contrib, 0.0)
    return contrib, torch.where(visible, weight, 0.0), ls


def _nee_env_strategy(ctx, surf: Surface, wo, bounce, want_weight: bool, aux):
    """Environment NEE: a direction from the env proposal (streams ENV_U,
    ENV_V) whose shadow ray must escape the scene, weighted by its
    solid-angle pdf (power-2 MIS against the BSDF pdf with
    ``want_weight``)."""
    scene: Scene = ctx["scene"]
    rng = ctx["rng"]
    wi, env_pdf = envmap.sample(ctx["env_dist"], rng(bounce, S.ENV_U), rng(bounce, S.ENV_V))
    nol = math3.dot(wi, surf.normal)
    o_sh, d_sh = _shadow_ray(surf, wi, ctx)
    hit = ctx["raycast"](o_sh, d_sh, any_hit=True, sort_hint=ctx["hit_tri"])
    visible = _skip_delta(ctx, ~hit.hit & (nol > 0.0) & (env_pdf > 0.0))
    f = bsdf.eval_f(surf, wi, wo, ctx["present"])
    if want_weight:
        weight = _power2_weight(env_pdf, bsdf.pdf(surf, wi, wo, aux, ctx["present"]))
    else:
        weight = torch.ones_like(env_pdf)
    denom = torch.where(visible, env_pdf, 1.0)
    contrib = envmap.radiance(scene, wi) * f * (nol * weight / denom)[..., None]
    return torch.where(visible[..., None], contrib, 0.0)


def _mis_bsdf_env_term(ctx, surf: Surface, wo, wi, f, bsdf_pdf, hit):
    """Env radiance of an escaping MIS BSDF-strategy ray, weighted against
    the env-NEE pdf (the counterpart of :func:`_nee_env_strategy`)."""
    env_pdf = envmap.pdf(ctx["env_dist"], wi)
    nol = math3.dot(wi, surf.normal)
    ok = _skip_delta(ctx, ~hit.hit & (bsdf_pdf > 0.0) & (nol > 0.0))
    weight = _power2_weight(bsdf_pdf, env_pdf)
    denom = torch.where(ok, bsdf_pdf, 1.0)
    contrib = envmap.radiance(ctx["scene"], wi) * f * (nol * weight / denom)[..., None]
    return torch.where(ok[..., None], contrib, 0.0)


def _mis_bsdf_strategy(ctx, surf: Surface, wo, bounce, ls):
    """BSDF-sampling strategy of DIRECT_MIS: trace a BSDF sample; if it
    lands on the light object NEE picked, weight it by power-2 MIS; with
    env NEE, an escaping sample adds the env term."""
    scene: Scene = ctx["scene"]
    rng = ctx["rng"]
    wi, aux = bsdf.sample(surf, rng(bounce, S.MIS_E0), rng(bounce, S.MIS_E1),
                          rng(bounce, S.MIS_E2), wo, ctx["present"])
    f = bsdf.eval_f(surf, wi, wo, ctx["present"])
    bsdf_pdf = bsdf.pdf(surf, wi, wo, aux, ctx["present"])
    o_sh, d_sh = _shadow_ray(surf, wi, ctx)
    hit = ctx["raycast"](o_sh, d_sh, sort_hint=ctx["hit_tri"])
    hit_surf = surface_init(scene, ctx["tables"], o_sh + d_sh * 1e-3, d_sh, hit.tri,
                            live=hit.hit if ctx.get("recording") else None)
    same_object = hit_surf.obj_id == scene.geometry.obj_id[ls.tri_idx.long()]
    now = math3.dot(hit_surf.normal, -wi)
    ok = _skip_delta(ctx, hit.hit & same_object & (now > 0.0))
    dist2 = math3.sqlen(hit_surf.point - surf.point)
    light_pdf = dist2 / torch.clamp(now * hit_surf.tri_area, min=1e-12)
    weight = _power2_weight(bsdf_pdf, light_pdf)
    ok = ok & (bsdf_pdf != 0.0)
    nol = math3.dot(wi, surf.normal)
    denom = torch.where(ok, bsdf_pdf, 1.0)
    contrib = hit_surf.emissive * f * (nol * weight / denom)[..., None]
    contrib = torch.where(ok[..., None], contrib, 0.0)
    if ctx.get("env_dist") is not None:
        contrib = contrib + _mis_bsdf_env_term(ctx, surf, wo, wi, f, bsdf_pdf, hit)
    return contrib, torch.where(ok, weight, 0.0)


def _integrate_direct(ctx, surf: Surface, wo, throughput, bounce):
    facing = (math3.dot(wo, surf.normal) > 0.0) & _emit_gate(ctx, bounce)
    lo = torch.where(facing[..., None], surf.emissive, 0.0)
    contrib, _, _ = _nee_light_strategy(ctx, surf, wo, bounce, want_weight=False, aux=None)
    if ctx.get("env_dist") is not None:
        contrib = contrib + _nee_env_strategy(ctx, surf, wo, bounce, want_weight=False, aux=None)
    return (lo + contrib) * throughput


def _mis_aux(ctx, surf: Surface, wo, bounce):
    """Lobe pick of the MIS BSDF sample, which the light strategies' pdfs
    use (the reference samples the BSDF first and reuses its pick)."""
    rng = ctx["rng"]
    return bsdf.sample(surf, rng(bounce, S.MIS_E0), rng(bounce, S.MIS_E1),
                       rng(bounce, S.MIS_E2), wo, ctx["present"])[1]


def _integrate_direct_mis(ctx, surf: Surface, wo, throughput, bounce):
    facing = (math3.dot(wo, surf.normal) > 0.0) & _emit_gate(ctx, bounce)
    lo = torch.where(facing[..., None], surf.emissive, 0.0)
    aux = _mis_aux(ctx, surf, wo, bounce)
    light_c, _, ls = _nee_light_strategy(ctx, surf, wo, bounce, want_weight=True, aux=aux)
    bsdf_c, _ = _mis_bsdf_strategy(ctx, surf, wo, bounce, ls)
    lo = lo + light_c + bsdf_c
    if ctx.get("env_dist") is not None:
        lo = lo + _nee_env_strategy(ctx, surf, wo, bounce, want_weight=True, aux=aux)
    return lo * throughput


def _first_hit(surf: Surface, bounce):
    """(N, 1) mask of lanes at bounce 0 (``bounce`` an int or a lane tensor)."""
    if isinstance(bounce, torch.Tensor):
        first = (bounce == 0).expand(surf.t.shape)
    else:
        first = torch.full(surf.t.shape, bounce == 0, dtype=torch.bool, device=surf.t.device)
    return first[..., None]


def _integrate_debug_mono(ctx, surf: Surface, wo, throughput, bounce):
    """White on the first hit."""
    return torch.where(_first_hit(surf, bounce), 1.0, 0.0).expand(*surf.t.shape, 3)


def _integrate_debug_depth(ctx, surf: Surface, wo, throughput, bounce):
    """Distance from the bounce-0 ray origin (the camera) over the far plane."""
    d = math3.length(surf.point - ctx["ray_origin"]) / FAR_PLANE
    return torch.where(_first_hit(surf, bounce), d[..., None], 0.0)


def _integrate_debug_normals(ctx, surf: Surface, wo, throughput, bounce):
    """Signed-normal color map: each axis's positive and negative part
    mixes its own color: +x red, +y green, +z blue, -x cyan, -y magenta,
    -z yellow. The colors are made on the device (no host copy inside a
    captured graph)."""
    n = surf.normal
    e = torch.eye(3, dtype=torch.float32, device=n.device)
    cols = [e[0], e[1], e[2], e[1] + e[2], e[0] + e[2], e[0] + e[1]]
    p = torch.clamp(n, 0.0, 1.0)
    m = -torch.clamp(n, -1.0, 0.0)
    color = (p[..., 0:1] * cols[0] + p[..., 1:2] * cols[1] + p[..., 2:3] * cols[2]
             + m[..., 0:1] * cols[3] + m[..., 1:2] * cols[4] + m[..., 2:3] * cols[5])
    return torch.where(_first_hit(surf, bounce), color, 0.0)


def _integrate_debug_mis_weights(ctx, surf: Surface, wo, throughput, bounce):
    """MIS weights at bounce 0: the BSDF strategy's in red, the light
    strategy's in blue."""
    aux = _mis_aux(ctx, surf, wo, bounce)
    _, w_light, ls = _nee_light_strategy(ctx, surf, wo, bounce, want_weight=True, aux=aux)
    _, w_bsdf = _mis_bsdf_strategy(ctx, surf, wo, bounce, ls)
    color = torch.stack([w_bsdf, torch.zeros_like(w_bsdf), w_light], dim=-1)
    return torch.where(_first_hit(surf, bounce), color, 0.0) * throughput


_TABLE = {
    Integrator.SIMPLE: _integrate_simple,
    Integrator.DIRECT: _integrate_direct,
    Integrator.DIRECT_MIS: _integrate_direct_mis,
    Integrator.DEBUG_MONO: _integrate_debug_mono,
    Integrator.DEBUG_DEPTH: _integrate_debug_depth,
    Integrator.DEBUG_NORMALS: _integrate_debug_normals,
    Integrator.DEBUG_MIS_WEIGHTS: _integrate_debug_mis_weights,
}


def make_integrator(kind: Integrator) -> Callable:
    return _TABLE[Integrator(kind)]
