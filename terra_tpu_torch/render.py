"""Wavefront path-tracing driver (port of ``terra_tpu/render.py``).

The per-pixel, per-sample loops are one flat wavefront of lanes. The
fixed-depth tracer (:func:`trace`) runs ``bounces + 1`` bounces with
per-lane active masks; the persistent-lane tracer
(:func:`trace_persistent`) regenerates a camera ray in a lane the moment
its path ends. Both draw every random number from the counter-based
threefry stream keyed by (pixel, sample, bounce, stream), so they replay
the JAX renderer's decisions exactly. Loops that JAX compiles
(``lax.scan``, ``lax.while_loop``) are Python loops here; PyTorch runs
eagerly on the device of the scene's tensors.

Gradients: :func:`trace` records autograd when its caller has it on, so a
loss on its radiance reaches the scene's positions, attributes, emission,
textures and the camera through the differentiable surface recompute
(``surface.py``); the raycast's hit choice carries none, as in the
reference. :func:`trace_persistent` is a ``lax.while_loop`` in the
reference, which JAX cannot reverse-differentiate, so it refuses inputs
that require gradients. :func:`render` never records a graph.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import bsdf, camera as camera_mod, envmap, intersect
from .accel import pallas_traverse, traverse
from .film import Film
from .integrators import make_integrator
from .ops import math3, rng as rng_mod
from .ops.rng import PathStreams as S
from .scene import Accelerator, Camera, Integrator, Intersector, LightPick, RenderOptions, \
    SamplingMethod, Scene
from .surface import build_shade_tables, surface_init

__all__ = ["render", "render_rows", "trace", "trace_persistent", "make_raycast_fn"]

EPS = 1e-4
# Largest wavefront one render_rows call carries; bigger frames are split
# into row bands. The bounce body keeps a few dozen (N, 3) f32 temporaries
# alive, about 1 KB a lane, so 2^21 lanes stay near 2 GB of device memory.
MAX_WAVEFRONT_LANES = 1 << 21


def make_raycast_fn(scene: Scene, opts: RenderOptions):
    """Raycast closure: nudges the origin by dir * RAY_OFFSET_DIR and
    traces through the BVH (``Accelerator.BVH`` on a scene committed with
    one; the tables of the kind ``pallas_traverse.wide_mode`` picks, packed
    once) or the brute-force sweep. With ``t_max`` it is the ranged
    occlusion query of NEE shadow rays: ``hit`` means occluded within
    t_max. The BVH path sorts each batch by parent-hit keys (``sort_hint``,
    the previous hit's triangle per lane, through the leaf-of-triangle
    table built once here), or by octant keys when no hint is given."""
    algo = "watertight" if opts.intersector == Intersector.WATERTIGHT else "mt"
    # the hit choice carries no gradient: tables come from detached corners,
    # so no graph is recorded over them
    corners = [c.detach() for c in scene.geometry.corners()]
    if opts.accelerator == Accelerator.BVH and scene.bvh is not None:
        tables = pallas_traverse.pack_tables_auto(scene.bvh, *corners)
        leaf_of = traverse.leaf_of_tri_table(scene.bvh)

        def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
            o = o + d * intersect.RAY_OFFSET_DIR
            return pallas_traverse.raycast(scene, o, d, t_max=t_max, any_hit=any_hit,
                                           sort_hint=sort_hint, algo=algo, tables=tables,
                                           leaf_of_tri=leaf_of)

        return raycast

    tri_a, tri_b, tri_c = corners

    def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
        o = o + d * intersect.RAY_OFFSET_DIR
        h = intersect.raycast_brute(o, d, tri_a, tri_b, tri_c, algo=algo)
        if t_max is None:
            return h
        occ = h.t < t_max
        return intersect.RayHit(t=h.t, tri=torch.where(occ, h.tri, 0), hit=occ)

    return raycast


def _pixel_jitter(opts: RenderOptions, key, pixel_idx, sample_idx):
    """Pixel-jitter uniforms of the selected sampling method."""
    method = opts.sampling_method
    if method == SamplingMethod.STRATIFIED:
        strata = max(int(opts.strata), 1)
        stratum = sample_idx % (strata * strata)
        sx = (stratum % strata).to(torch.float32)
        sy = (stratum // strata).to(torch.float32)
        u1, u2 = rng_mod.path_uniform2(key, pixel_idx, sample_idx, 0, S.JITTER_X)
        inv = 1.0 / strata
        r1 = torch.clamp((sx + u1) * inv, max=1.0 - 1e-4)
        r2 = torch.clamp((sy + u2) * inv, max=1.0 - 1e-4)
        return r1, r2
    if method == SamplingMethod.HALTON:
        return rng_mod.radical_inverse(3, sample_idx), rng_mod.radical_inverse(2, sample_idx)
    return rng_mod.path_uniform2(key, pixel_idx, sample_idx, 0, S.JITTER_X)


_CONTINUATION_STREAMS = (S.BSDF_E0, S.BSDF_E1, S.BSDF_E2, S.ROULETTE)


def _streams_for(integrator, env_nee: bool = False) -> tuple:
    """RNG streams a bounce draws (one threefry batch per bounce)."""
    integ = Integrator(integrator)
    if integ == Integrator.DIRECT:
        extra = (S.LIGHT_PICK, S.LIGHT_U, S.LIGHT_V)
    elif integ in (Integrator.DIRECT_MIS, Integrator.DEBUG_MIS_WEIGHTS):
        extra = (S.MIS_E0, S.MIS_E1, S.MIS_E2, S.LIGHT_PICK, S.LIGHT_U, S.LIGHT_V)
    else:
        extra = ()
    if env_nee and integ in (Integrator.DIRECT, Integrator.DIRECT_MIS):
        extra = extra + (S.ENV_U, S.ENV_V)
    return _CONTINUATION_STREAMS + extra


def _continue(surf, u, wo, throughput, present):
    """BSDF sample, pdf, f and cosine of the path continuation; returns
    (wi, unnormalised new throughput, continuation origin). Transmitted
    rays continue from the far side of the surface."""
    wi, aux = bsdf.sample(surf, u[S.BSDF_E0], u[S.BSDF_E1], u[S.BSDF_E2], wo, present)
    pdf = torch.clamp(bsdf.pdf(surf, wi, wo, aux, present), min=EPS)
    f = bsdf.eval_f(surf, wi, wo, present)
    nol, off_sign = bsdf.continuation_factors(surf, wi, present)
    new_tp = throughput * f * (nol / pdf)[..., None]
    offset = intersect.SURFACE_OFFSET_NORMAL
    if off_sign is not None:
        offset = (off_sign * offset)[..., None]
    return wi, new_tp, surf.point + surf.normal * offset


def _miss_env(scene, opts: RenderOptions, d, throughput, miss, emit_ok, bounce):
    """Env radiance picked up by rays that miss (``env_on_miss``). Under
    env NEE the shaded vertices already sampled the environment, so only
    camera rays and rays leaving a delta lobe add it: the specular-bounce
    flag gates it where the scene has delta lobes, ``bounce == 0`` where
    it has none."""
    if opts.env_nee:
        miss = miss & (emit_ok if emit_ok is not None else bounce == 0)
    return torch.where(miss[..., None], throughput * envmap.radiance(scene, d), 0.0)


def _shade(scene, ctx_base, integrator, hit, o, d, active, throughput, bounce, u, emit_ok):
    """Surface, integrator radiance and the per-lane delta mask of one
    bounce."""
    surf = surface_init(scene, ctx_base["tables"], o + d * intersect.RAY_OFFSET_DIR, d, hit.tri)
    ctx = dict(ctx_base, rng=lambda _bounce, stream: u[stream], ray_origin=o, active=active,
               emit_ok=emit_ok, delta=bsdf.delta_mask(surf, ctx_base["present"]),
               hit_tri=torch.where(active, hit.tri, -1))
    radiance = integrator(ctx, surf, -d, throughput, bounce)
    return surf, radiance, ctx["delta"]


def _context(scene: Scene, opts: RenderOptions):
    present = scene.materials.types_present
    return dict(scene=scene, raycast=make_raycast_fn(scene, opts),
                tables=build_shade_tables(scene), present=present,
                light_area=opts.light_pick == LightPick.AREA,
                env_dist=envmap.build_distribution(scene) if opts.env_nee else None,
                has_delta=any(t in present for t in bsdf.DELTA_TYPES))


def trace(scene: Scene, opts: RenderOptions, key, o, d, pixel_idx, sample_idx):
    """Trace a wavefront of primary rays for ``bounces + 1`` bounces.
    Returns (N, 3) f32 radiance per lane, differentiable in the scene's
    tensors and the rays when autograd is on."""
    ctx_base = _context(scene, opts)
    integrator = make_integrator(opts.integrator)
    streams = _streams_for(opts.integrator, opts.env_nee)
    n = o.shape[0]
    dev = o.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    lo = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    # specular-bounce flag, carried where the scene has delta lobes
    emit_ok = active.clone() if ctx_base["has_delta"] else None
    for bounce in range(opts.bounces + 1):
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams)
        hit = ctx_base["raycast"](*intersect.mask_dead_rays(active, o, d),
                                  sort_hint=torch.where(active, prev_tri, -1))
        if opts.env_on_miss:
            lo = lo + _miss_env(scene, opts, d, throughput, active & ~hit.hit, emit_ok, bounce)
        active = active & hit.hit
        surf, radiance, delta = _shade(scene, ctx_base, integrator, hit, o, d, active,
                                       throughput, bounce, u, emit_ok)
        lo = lo + torch.where(active[..., None], radiance, 0.0)

        wi, new_tp, new_o = _continue(surf, u, -d, throughput, ctx_base["present"])
        if bounce >= opts.rr_start_bounce:  # Russian roulette
            p = math3.max3(new_tp)
            active = active & (u[S.ROULETTE] <= p)
            new_tp = new_tp / (p + EPS)[..., None]
        live = active[..., None]
        o = torch.where(live, new_o, o)
        d = torch.where(live, wi, d)
        throughput = torch.where(live, new_tp, throughput)
        prev_tri = torch.where(active, hit.tri, -1)
        emit_ok = delta
    return lo


def _wants_grad(scene: Scene, cam: Camera) -> bool:
    """Autograd is on and a scene or camera tensor requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    g, m = scene.geometry, scene.materials
    return any(t.requires_grad for t in (
        g.positions, g.normals, g.uvs, m.attrs, m.emissive, m.ior, scene.textures.data,
        scene.env_value, cam.position, cam.direction, cam.up, cam.fov_deg))


def trace_persistent(scene: Scene, opts: RenderOptions, cam: Camera, key, pixel_idx, px, py,
                     sample_base, quota: int):
    """Persistent lanes: each lane traces ``quota`` samples of its pixel
    back to back, starting a new camera ray as soon as a path ends. The
    same estimator as :func:`trace`; only the order in which samples are
    summed differs. The loop runs at most ``quota * (bounces + 1)`` times
    and reads one flag from the device per iteration. Returns (N, 3)
    radiance sums over each lane's quota. It has no gradient (the
    reference's while loop has none either): a scene or camera tensor that
    requires one raises."""
    if _wants_grad(scene, cam):
        raise RuntimeError(
            "trace_persistent has no gradient (a while loop in the reference); render "
            "with samples_per_lane=1 to differentiate")
    with torch.no_grad():
        return _trace_persistent(scene, opts, cam, key, pixel_idx, px, py, sample_base, quota)


def _trace_persistent(scene: Scene, opts: RenderOptions, cam: Camera, key, pixel_idx, px, py,
                      sample_base, quota: int):
    ctx_base = _context(scene, opts)
    integrator = make_integrator(opts.integrator)
    streams = _streams_for(opts.integrator, opts.env_nee)
    n = pixel_idx.shape[0]
    dev = pixel_idx.device

    def new_ray(sample_idx):
        r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
        return camera_mod.generate_rays(cam, opts.width, opts.height, px, py,
                                        opts.subpixel_jitter, r1, r2)

    sample = sample_base.to(torch.int64).clone()
    o, d = new_ray(sample)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    lo_sample = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    lo_total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    bounce = torch.zeros((n,), dtype=torch.int64, device=dev)
    done = torch.zeros((n,), dtype=torch.int64, device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    prev_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    emit_ok = ~finished if ctx_base["has_delta"] else None
    for _ in range(quota * (opts.bounces + 1)):
        if bool(finished.all()):
            break
        active = ~finished
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample, bounce, streams)
        hit = ctx_base["raycast"](*intersect.mask_dead_rays(active, o, d),
                                  sort_hint=torch.where(active, prev_tri, -1))
        if opts.env_on_miss:
            lo_sample = lo_sample + _miss_env(scene, opts, d, throughput, active & ~hit.hit,
                                              emit_ok, bounce)
        alive = active & hit.hit
        surf, radiance, delta = _shade(scene, ctx_base, integrator, hit, o, d, alive,
                                       throughput, bounce, u, emit_ok)
        lo_sample = lo_sample + torch.where(alive[..., None], radiance, 0.0)

        wi, new_tp, cont_o = _continue(surf, u, -d, throughput, ctx_base["present"])
        p = math3.max3(new_tp)
        rr_on = bounce >= opts.rr_start_bounce
        survive = alive & torch.where(rr_on, u[S.ROULETTE] <= p, True) & (bounce < opts.bounces)
        new_tp = torch.where(rr_on[..., None], new_tp / (p + EPS)[..., None], new_tp)

        # a path that ends banks its sample, then regenerates or finishes
        path_end = active & ~survive
        done = done + path_end
        lo_total = lo_total + torch.where(path_end[..., None], lo_sample, 0.0)
        need_more = done < quota
        regen = path_end & need_more
        finished = finished | (path_end & ~need_more)
        sample = sample + path_end

        ro, rd = new_ray(sample)
        rg, sv = regen[..., None], survive[..., None]
        o = torch.where(rg, ro, torch.where(sv, cont_o, o))
        d = torch.where(rg, rd, torch.where(sv, wi, d))
        throughput = torch.where(rg, 1.0, torch.where(sv, new_tp, throughput))
        lo_sample = torch.where(path_end[..., None], 0.0, lo_sample)
        bounce = torch.where(regen, 0, torch.where(survive, bounce + 1, bounce))
        prev_tri = torch.where(regen, -1, torch.where(survive, hit.tri, prev_tri))
        if emit_ok is not None:  # fresh paths start True; continuations carry delta
            emit_ok = regen | delta
    return lo_total


def _lane_ids(opts: RenderOptions, spp_chunk: int, sample_offset: int, row0: int, rows: int,
              device):
    """Pixel-major lanes, ``spp_chunk`` consecutive lanes per pixel, for
    the band of ``rows`` rows from ``row0``. Pixel ids stay global, so the
    random stream does not depend on banding. Returns (pixel_idx, px, py,
    sample_idx), int64."""
    band = torch.arange(rows * opts.width, dtype=torch.int64, device=device)
    pixel_idx = torch.repeat_interleave(band, spp_chunk) + row0 * opts.width
    px = pixel_idx % opts.width
    py = pixel_idx // opts.width
    sample_idx = torch.arange(spp_chunk, dtype=torch.int64, device=device).repeat(
        rows * opts.width) + sample_offset
    return pixel_idx, px, py, sample_idx


def _quota(opts: RenderOptions, spp_chunk: int) -> int:
    """Samples per persistent lane: the largest divisor of the chunk not
    above ``samples_per_lane``."""
    quota = max(int(opts.samples_per_lane), 1)
    while spp_chunk % quota:
        quota -= 1
    return quota


def render_rows(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset: int,
                spp_chunk: int, row0: int, rows: int):
    """Radiance sum (rows, W, 3) of ``spp_chunk`` samples per pixel over
    the band of ``rows`` rows from ``row0``."""
    dev = scene.device
    quota = _quota(opts, spp_chunk)
    if quota > 1:
        lanes_pp = spp_chunk // quota
        pixel_idx, px, py, sample_idx = _lane_ids(opts, lanes_pp, sample_offset, row0, rows, dev)
        lane_base = sample_offset + (sample_idx - sample_offset) * quota
        lo = trace_persistent(scene, opts, cam, key, pixel_idx, px, py, lane_base, quota)
        return lo.reshape(rows, opts.width, lanes_pp, 3).sum(dim=2)
    pixel_idx, px, py, sample_idx = _lane_ids(opts, spp_chunk, sample_offset, row0, rows, dev)
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(cam, opts.width, opts.height, px, py, opts.subpixel_jitter,
                                    r1, r2)
    lo = trace(scene, opts, key, o, d, pixel_idx, sample_idx)
    return lo.reshape(rows, opts.width, spp_chunk, 3).sum(dim=2)


def _band_rows(opts: RenderOptions, spp_chunk: int) -> int:
    """Row-band height keeping a launch under MAX_WAVEFRONT_LANES: the
    whole frame when it fits, else the largest divisor of the height that
    does."""
    lanes_per_row = opts.width * spp_chunk // _quota(opts, spp_chunk)
    target = max(MAX_WAVEFRONT_LANES // max(lanes_per_row, 1), 1)
    if target >= opts.height:
        return opts.height
    for b in range(target, 0, -1):
        if opts.height % b == 0:
            return b
    return 1


def _validate_acc(acc, where: str):
    """debug_checks: raise on non-finite radiance, naming the rows."""
    bad = ~torch.isfinite(acc)
    if bool(bad.any()):
        rows = np.unique(np.nonzero(bad.reshape(acc.shape[0], -1).any(dim=1).cpu().numpy())[0])
        raise FloatingPointError(
            f"non-finite radiance in {where}: {int(bad.sum())} values, "
            f"pixel rows {rows[:8].tolist()}{'...' if len(rows) > 8 else ''}")


@torch.no_grad()
def render(scene: Scene, cam: Camera, opts: RenderOptions, seed: int = 0,
           film: Optional[Film] = None) -> Film:
    """Progressive render on the scene's device: adds
    ``opts.samples_per_pixel`` samples to ``film`` (a new one if None).
    Pass the returned film back in to keep accumulating. The film adds in
    the reference's order: banded frames chunk by chunk and band by band;
    otherwise (without ``debug_checks``) the full chunks are summed from
    zero and that sum is added once, then the remainder chunk."""
    if film is None:
        film = Film.create(opts.width, opts.height, scene.device)
    key = rng_mod.key_from_seed(seed)
    spp = opts.samples_per_pixel
    chunk = min(opts.samples_per_launch or spp, spp)
    # resume after the film's samples; a non-uniform film would reuse ids
    base = int(film.samples.max()) if film.samples.numel() else 0
    if film.samples.numel() and int(film.samples.min()) != base:
        raise ValueError(
            "render() resume requires a uniformly-sampled film "
            f"(min={int(film.samples.min())}, max={base}); render missing "
            "regions separately or reset the film")
    band = _band_rows(opts, chunk)
    h = opts.height
    done = 0
    if band < h:
        while done < spp:
            cur = min(chunk, spp - done)
            acc = film.acc.clone()
            for b0 in range(0, h, band):
                part = render_rows(scene, cam, opts, key, base + done, cur, b0, band)
                if opts.debug_checks:
                    _validate_acc(part, f"chunk at sample offset {base + done}, rows from {b0}")
                acc[b0:b0 + band] = acc[b0:b0 + band] + part
            film = Film(acc=acc, samples=film.samples + cur)
            done += cur
        return film
    n_full = spp // chunk
    if n_full > 1 and not opts.debug_checks:
        acc = torch.zeros_like(film.acc)
        for i in range(n_full):
            acc = acc + render_rows(scene, cam, opts, key, base + i * chunk, chunk, 0, h)
        film = Film(acc=film.acc + acc, samples=film.samples + n_full * chunk)
        done = n_full * chunk
    while done < spp:
        cur = min(chunk, spp - done)
        acc = render_rows(scene, cam, opts, key, base + done, cur, 0, h)
        if opts.debug_checks:
            _validate_acc(acc, f"chunk at sample offset {base + done}")
        film = Film(acc=film.acc + acc, samples=film.samples + cur)
        done += cur
    return film
