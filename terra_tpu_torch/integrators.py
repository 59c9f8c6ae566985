"""Wavefront integrator passes (port of ``terra_tpu/integrators.py``):
SIMPLE (emissive only), DIRECT (next-event estimation) and DIRECT_MIS
(NEE plus BSDF sampling, power-2 MIS). Each pass returns per-lane radiance
already multiplied by the throughput. The debug integrators are not
ported yet and raise; the environment-NEE strategies wait for envmap.py
(``render`` refuses ``env_nee``)."""
from __future__ import annotations

from typing import Callable

import torch

from . import bsdf, lights
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


def _mis_bsdf_strategy(ctx, surf: Surface, wo, bounce, ls):
    """BSDF-sampling strategy of DIRECT_MIS: trace a BSDF sample; if it
    lands on the light object NEE picked, weight it by power-2 MIS."""
    scene: Scene = ctx["scene"]
    rng = ctx["rng"]
    wi, aux = bsdf.sample(surf, rng(bounce, S.MIS_E0), rng(bounce, S.MIS_E1),
                          rng(bounce, S.MIS_E2), wo, ctx["present"])
    f = bsdf.eval_f(surf, wi, wo, ctx["present"])
    bsdf_pdf = bsdf.pdf(surf, wi, wo, aux, ctx["present"])
    o_sh, d_sh = _shadow_ray(surf, wi, ctx)
    hit = ctx["raycast"](o_sh, d_sh, sort_hint=ctx["hit_tri"])
    hit_surf = surface_init(scene, ctx["tables"], o_sh + d_sh * 1e-3, d_sh, hit.tri)
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
    return torch.where(ok[..., None], contrib, 0.0), torch.where(ok, weight, 0.0)


def _integrate_direct(ctx, surf: Surface, wo, throughput, bounce):
    facing = (math3.dot(wo, surf.normal) > 0.0) & _emit_gate(ctx, bounce)
    lo = torch.where(facing[..., None], surf.emissive, 0.0)
    contrib, _, _ = _nee_light_strategy(ctx, surf, wo, bounce, want_weight=False, aux=None)
    return (lo + contrib) * throughput


def _integrate_direct_mis(ctx, surf: Surface, wo, throughput, bounce):
    facing = (math3.dot(wo, surf.normal) > 0.0) & _emit_gate(ctx, bounce)
    lo = torch.where(facing[..., None], surf.emissive, 0.0)
    # the light strategy's pdf uses the lobe pick of the MIS BSDF sample
    rng = ctx["rng"]
    _, aux = bsdf.sample(surf, rng(bounce, S.MIS_E0), rng(bounce, S.MIS_E1),
                         rng(bounce, S.MIS_E2), wo, ctx["present"])
    light_c, _, ls = _nee_light_strategy(ctx, surf, wo, bounce, want_weight=True, aux=aux)
    bsdf_c, _ = _mis_bsdf_strategy(ctx, surf, wo, bounce, ls)
    return (lo + light_c + bsdf_c) * throughput


_TABLE = {
    Integrator.SIMPLE: _integrate_simple,
    Integrator.DIRECT: _integrate_direct,
    Integrator.DIRECT_MIS: _integrate_direct_mis,
}


def make_integrator(kind: Integrator) -> Callable:
    kind = Integrator(kind)
    if kind not in _TABLE:
        raise NotImplementedError(
            f"integrator {kind.name} is not ported yet (ROADMAP queue A, integrators.py)")
    return _TABLE[kind]
