"""Wavefront path-tracing driver (port of ``terra_tpu/render.py``).

The per-pixel, per-sample loops are one flat wavefront of lanes. The
fixed-depth tracer (:func:`trace`) runs ``bounces + 1`` bounces with
per-lane active masks; the persistent-lane tracer
(:func:`trace_persistent`) regenerates a camera ray in a lane the moment
its path ends. Both draw every random number from the counter-based
threefry stream keyed by (pixel, sample, bounce, stream), so they replay
the JAX renderer's decisions exactly. Loops that JAX compiles
(``lax.scan``, ``lax.while_loop``) are Python loops here.

Launch units: the JAX package renders through three jitted functions,
:func:`render_chunk`, :func:`render_band` and :func:`render_chunks`, each
one device program per call with the key, sample offset and first row
traced. Here each is a CUDA graph on a CUDA scene, captured once per
(scene, camera, options, samples, rows) and replayed with new inputs
(``graphs.py``); on CPU tensors the same capture-safe body
(:class:`_BandBody`) runs eagerly. :func:`render` goes through them in the
reference's order. :func:`render_rows` is the eager body by name: every
op dispatched from the host, the persistent loop's flag read every trip
(the A/B baseline, and the body the eager gradient records through).
:class:`_GradBody` is the training units' capture-safe differentiable
forward (``optim.py``).

Gradients: :func:`trace` records autograd when its caller has it on, so a
loss on its radiance reaches the scene's positions, attributes, emission,
textures and the camera through the differentiable surface recompute
(``surface.py``); the raycast's hit choice carries none, as in the
reference. :func:`trace_persistent` is a ``lax.while_loop`` in the
reference, which JAX cannot reverse-differentiate, so it refuses inputs
that require gradients. :func:`render` never records a graph.

Spans (``profile``): a pass is ``terra.render.pass``, its host reads of
the film's sample counts ``terra.render.resume_read`` and each write of a
unit's inputs ``terra.unit.inputs`` (hot spans: they record only while
tracing is on); building a render context is ``terra.render.context``.
"""
from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

from . import bsdf, camera as camera_mod, envmap, graphs, intersect
from .accel import pallas_traverse, traverse
from .film import Film
from .integrators import make_integrator
from .ops import math3, rng as rng_mod
from .ops.rng import PathStreams as S
from .profile import profiler
from .scene import Accelerator, Camera, Integrator, Intersector, LightPick, RenderOptions, \
    SamplingMethod, Scene
from .surface import build_shade_tables, surface_init

__all__ = ["render", "render_chunk", "render_band", "render_chunks", "render_rows", "trace",
           "trace_persistent", "make_raycast_fn"]

EPS = 1e-4
# Largest wavefront one render_rows call carries; bigger frames are split
# into row bands. The bounce body keeps a few dozen (N, 3) f32 temporaries
# alive, about 1 KB a lane, so 2^21 lanes stay near 2 GB of device memory.
MAX_WAVEFRONT_LANES = 1 << 21

# Persistent-loop trips run since import (eager trips one by one, captured
# blocks by their trip count); reset it before the run to count.
trips = 0


def make_raycast_fn(scene: Scene, opts: RenderOptions, leaf_of=None):
    """Raycast closure: nudges the origin by dir * RAY_OFFSET_DIR and
    traces through the BVH (``Accelerator.BVH`` on a scene committed with
    one; the tables of the kind ``pallas_traverse.wide_mode`` picks, packed
    once) or the brute-force sweep (``intersect.raycast_sweep``; its rows
    packed once). With ``t_max`` it is the ranged
    occlusion query of NEE shadow rays: ``hit`` means occluded within
    t_max. The BVH path sorts each batch by parent-hit keys (``sort_hint``,
    the previous hit's triangle per lane, through the leaf-of-triangle
    table ``leaf_of``, built here when not given), or by octant keys when
    no hint is given."""
    algo = "watertight" if opts.intersector == Intersector.WATERTIGHT else "mt"
    # the hit choice carries no gradient: tables come from detached corners,
    # so no graph is recorded over them
    corners = [c.detach() for c in scene.geometry.corners()]
    if opts.accelerator == Accelerator.BVH and scene.bvh is not None:
        if not pallas_traverse.supported(scene.bvh):  # the reference's kernel choice
            raise ValueError("the traversal kernels cannot walk this tree "
                             "(pallas_traverse.supported)")
        tables = pallas_traverse.pack_tables_auto(scene.bvh, *corners)
        if leaf_of is None:
            leaf_of = traverse.leaf_of_tri_table(scene.bvh)
        # the closure holds the tree, not the scene: cached contexts and
        # captured graphs must not keep a scene alive
        tree = types.SimpleNamespace(bvh=scene.bvh)

        def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
            o = o + d * intersect.RAY_OFFSET_DIR
            return pallas_traverse.raycast(tree, o, d, t_max=t_max, any_hit=any_hit,
                                           sort_hint=sort_hint, algo=algo, tables=tables,
                                           leaf_of_tri=leaf_of)

        return raycast

    tri_a, tri_b, tri_c = corners
    # the sweep kernel's rows, packed once a context (CPU corners take the grid)
    slots = intersect.pack_sweep(*corners) if tri_a.device.type != "cpu" else None

    def raycast(o, d, t_max=None, any_hit=False, sort_hint=None):
        o = o + d * intersect.RAY_OFFSET_DIR
        return intersect.raycast_sweep(o, d, tri_a, tri_b, tri_c, t_max=t_max, algo=algo,
                                       slots=slots)

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


def _continue(surf, u, wo, throughput, present, live=None):
    """BSDF sample, pdf, f and cosine of the path continuation; returns
    (wi, unnormalised new throughput, continuation origin). Transmitted
    rays continue from the far side of the surface. ``live`` (given where
    autograd records): lanes outside it take f 0, cosine 0 and pdf 1
    before the product is formed, so an infinite factor of a lane the
    caller masks out meets no 0 gradient in the backward (0 × inf); a
    live lane's words and gradient are unchanged."""
    wi, aux = bsdf.sample(surf, u[S.BSDF_E0], u[S.BSDF_E1], u[S.BSDF_E2], wo, present)
    pdf = torch.clamp(bsdf.pdf(surf, wi, wo, aux, present), min=EPS)
    f = bsdf.eval_f(surf, wi, wo, present)
    nol, off_sign = bsdf.continuation_factors(surf, wi, present)
    if live is not None:
        f = torch.where(live[..., None], f, 0.0)
        nol = torch.where(live, nol, 0.0)
        pdf = torch.where(live, pdf, 1.0)
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


def _shade(scene, ctx_base, integrator, hit, o, d, active, throughput, bounce, u, emit_ok,
           recording=False):
    """Surface, integrator radiance and the per-lane delta mask of one
    bounce. ``recording`` (autograd records the bounce): lanes outside
    ``active`` shade a finite stand-in surface (``surface_init``'s
    ``live``), as do the integrator's own surfaces of rays that missed."""
    surf = surface_init(scene, ctx_base["tables"], o + d * intersect.RAY_OFFSET_DIR, d, hit.tri,
                        live=active if recording else None)
    ctx = dict(ctx_base, scene=scene, rng=lambda _bounce, stream: u[stream], ray_origin=o,
               active=active, emit_ok=emit_ok, delta=bsdf.delta_mask(surf, ctx_base["present"]),
               hit_tri=torch.where(active, hit.tri, -1), recording=recording)
    radiance = integrator(ctx, surf, -d, throughput, bounce)
    return surf, radiance, ctx["delta"]


def _build_context(scene: Scene, opts: RenderOptions, leaf_of=None):
    present = scene.materials.types_present
    return dict(raycast=make_raycast_fn(scene, opts, leaf_of),
                tables=build_shade_tables(scene), present=present,
                light_area=opts.light_pick == LightPick.AREA,
                env_dist=envmap.build_distribution(scene) if opts.env_nee else None,
                has_delta=any(t in present for t in bsdf.DELTA_TYPES))


def _scene_wants_grad(scene: Scene) -> bool:
    """Autograd is on and a scene tensor requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    g, m = scene.geometry, scene.materials
    return any(t.requires_grad for t in (g.positions, g.normals, g.uvs, m.attrs, m.emissive,
                                         m.ior, scene.textures.data, scene.env_value))


def _context(scene: Scene, opts: RenderOptions):
    """What a trace needs besides the scene, built on the host: the raycast
    with its packed tables, the shading tables, the env distribution. Built
    once per (scene, traversal options) and reused until a scene tensor
    changes (``graphs.CONTEXTS``); built anew under autograd, where the
    shading tables carry the scene's gradient."""
    if _scene_wants_grad(scene):
        return _build_context(scene, opts)

    def make():
        with profiler.span("terra.render.context"):
            return _build_context(scene, opts)

    return graphs.CONTEXTS.get((scene,), (opts.accelerator, opts.intersector, opts.env_nee,
                                          opts.light_pick), make)


def trace(scene: Scene, opts: RenderOptions, key, o, d, pixel_idx, sample_idx):
    """Trace a wavefront of primary rays for ``bounces + 1`` bounces.
    Returns (N, 3) f32 radiance per lane, differentiable in the scene's
    tensors and the rays when autograd is on."""
    return _trace(scene, _context(scene, opts), opts, key, o, d, pixel_idx, sample_idx)


def _trace(scene: Scene, ctx_base: dict, opts: RenderOptions, key, o, d, pixel_idx,
           sample_idx):
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
    # where autograd records, lanes the bounce masks out get finite factors
    # (else 0 × inf in the backward); decided on the host, so static inside
    # a captured training unit
    recording = _scene_wants_grad(scene) or (torch.is_grad_enabled() and (
        o.requires_grad or d.requires_grad))
    for bounce in range(opts.bounces + 1):
        u = rng_mod.path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams)
        hit = ctx_base["raycast"](*intersect.mask_dead_rays(active, o, d),
                                  sort_hint=torch.where(active, prev_tri, -1))
        if opts.env_on_miss:
            lo = lo + _miss_env(scene, opts, d, throughput, active & ~hit.hit, emit_ok, bounce)
        active = active & hit.hit
        surf, radiance, delta = _shade(scene, ctx_base, integrator, hit, o, d, active,
                                       throughput, bounce, u, emit_ok, recording)
        lo = lo + torch.where(active[..., None], radiance, 0.0)

        wi, new_tp, new_o = _continue(surf, u, -d, throughput, ctx_base["present"],
                                      active if recording else None)
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
    return _scene_wants_grad(scene) or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (cam.position, cam.direction, cam.up, cam.fov_deg)))


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
    global trips
    with torch.no_grad():
        ctx = _context(scene, opts)
        lanes = (pixel_idx, px, py)
        st = _persistent_start(scene, ctx, opts, cam, key, lanes, sample_base)
        for _ in range(quota * (opts.bounces + 1)):
            if bool(st["finished"].all()):
                break
            st = _persistent_trip(scene, ctx, opts, cam, key, lanes, quota, st)
            trips += 1
        return st["lo_total"]


def _new_ray(opts: RenderOptions, cam: Camera, key, lanes, sample_idx):
    pixel_idx, px, py = lanes
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    return camera_mod.generate_rays(cam, opts.width, opts.height, px, py, opts.subpixel_jitter,
                                    r1, r2)


def _persistent_start(scene: Scene, ctx: dict, opts: RenderOptions, cam: Camera, key, lanes,
                      sample_base) -> dict:
    """The persistent loop's carry before its first trip."""
    n = lanes[0].shape[0]
    dev = lanes[0].device
    sample = sample_base.to(torch.int64).clone()
    o, d = _new_ray(opts, cam, key, lanes, sample)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    st = dict(o=o, d=d, throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
              lo_sample=torch.zeros((n, 3), dtype=torch.float32, device=dev),
              lo_total=torch.zeros((n, 3), dtype=torch.float32, device=dev), sample=sample,
              bounce=torch.zeros((n,), dtype=torch.int64, device=dev),
              done=torch.zeros((n,), dtype=torch.int64, device=dev), finished=finished,
              prev_tri=torch.full((n,), -1, dtype=torch.int32, device=dev))
    if ctx["has_delta"]:  # the specular-bounce flag
        st["emit_ok"] = ~finished
    return st


def _persistent_trip(scene: Scene, ctx: dict, opts: RenderOptions, cam: Camera, key, lanes,
                     quota: int, st: dict) -> dict:
    """One trip of the persistent loop: the carry after it. A trip after
    every lane finished changes no word of ``lo_total``: no lane is
    active, so every sum adds 0.0, as for a finished lane beside running
    ones."""
    integrator = make_integrator(opts.integrator)
    streams = _streams_for(opts.integrator, opts.env_nee)
    o, d, throughput, bounce = st["o"], st["d"], st["throughput"], st["bounce"]
    lo_sample, emit_ok = st["lo_sample"], st.get("emit_ok")
    active = ~st["finished"]
    u = rng_mod.path_uniform_bundle(key, lanes[0], st["sample"], bounce, streams)
    hit = ctx["raycast"](*intersect.mask_dead_rays(active, o, d),
                         sort_hint=torch.where(active, st["prev_tri"], -1))
    if opts.env_on_miss:
        lo_sample = lo_sample + _miss_env(scene, opts, d, throughput, active & ~hit.hit,
                                          emit_ok, bounce)
    alive = active & hit.hit
    surf, radiance, delta = _shade(scene, ctx, integrator, hit, o, d, alive, throughput, bounce,
                                   u, emit_ok)
    lo_sample = lo_sample + torch.where(alive[..., None], radiance, 0.0)

    wi, new_tp, cont_o = _continue(surf, u, -d, throughput, ctx["present"])
    p = math3.max3(new_tp)
    rr_on = bounce >= opts.rr_start_bounce
    survive = alive & torch.where(rr_on, u[S.ROULETTE] <= p, True) & (bounce < opts.bounces)
    new_tp = torch.where(rr_on[..., None], new_tp / (p + EPS)[..., None], new_tp)

    # a path that ends banks its sample, then regenerates or finishes
    path_end = active & ~survive
    done = st["done"] + path_end
    lo_total = st["lo_total"] + torch.where(path_end[..., None], lo_sample, 0.0)
    need_more = done < quota
    regen = path_end & need_more
    finished = st["finished"] | (path_end & ~need_more)
    sample = st["sample"] + path_end

    ro, rd = _new_ray(opts, cam, key, lanes, sample)
    rg, sv = regen[..., None], survive[..., None]
    out = dict(o=torch.where(rg, ro, torch.where(sv, cont_o, o)),
               d=torch.where(rg, rd, torch.where(sv, wi, d)),
               throughput=torch.where(rg, 1.0, torch.where(sv, new_tp, throughput)),
               lo_sample=torch.where(path_end[..., None], 0.0, lo_sample), lo_total=lo_total,
               sample=sample,
               bounce=torch.where(regen, 0, torch.where(survive, bounce + 1, bounce)),
               done=done, finished=finished,
               prev_tri=torch.where(regen, -1, torch.where(survive, hit.tri, st["prev_tri"])))
    if emit_ok is not None:  # fresh paths start True; continuations carry delta
        out["emit_ok"] = regen | delta
    return out


def _lane_ids(opts: RenderOptions, spp_chunk: int, sample_offset, row0, rows: int, device):
    """Pixel-major lanes, ``spp_chunk`` consecutive lanes per pixel, for
    the band of ``rows`` rows from ``row0``. Pixel ids stay global, so the
    random stream does not depend on banding. ``sample_offset`` and
    ``row0`` are ints or 0-d int64 tensors on ``device`` (a captured graph
    reads them from its input buffer). Returns (pixel_idx, px, py,
    sample_idx), int64."""
    band = torch.arange(rows * opts.width, dtype=torch.int64, device=device)
    pixel_idx = band[:, None].expand(-1, spp_chunk).reshape(-1) + row0 * opts.width
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
    the band of ``rows`` rows from ``row0``, run eagerly: the body that
    :func:`render_band` captures, with every op dispatched from the host
    and the persistent loop's flag read on every trip."""
    dev = scene.device
    quota = _quota(opts, spp_chunk)
    if quota > 1:
        lanes_pp = spp_chunk // quota
        pixel_idx, px, py, sample_idx = _lane_ids(opts, lanes_pp, sample_offset, row0, rows, dev)
        lane_base = sample_offset + (sample_idx - sample_offset) * quota
        lo = trace_persistent(scene, opts, cam, key, pixel_idx, px, py, lane_base, quota)
        return lo.reshape(rows, opts.width, lanes_pp, 3).sum(dim=2)
    lo = _fixed_depth(scene, _context(scene, opts), opts, cam, key, sample_offset, spp_chunk,
                      row0, rows)
    return lo.reshape(rows, opts.width, spp_chunk, 3).sum(dim=2)


def _fixed_depth(scene: Scene, ctx: dict, opts: RenderOptions, cam: Camera, key, sample_offset,
                 spp_chunk: int, row0, rows: int):
    """(N, 3) radiance of the fixed-depth wavefront over the band's lanes
    (``spp_chunk`` consecutive lanes a pixel): pixel jitter, camera rays,
    then :func:`trace`'s bounces with the context ``ctx``."""
    pixel_idx, px, py, sample_idx = _lane_ids(opts, spp_chunk, sample_offset, row0, rows,
                                              scene.device)
    r1, r2 = _pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(cam, opts.width, opts.height, px, py, opts.subpixel_jitter,
                                    r1, r2)
    return _trace(scene, ctx, opts, key, o, d, pixel_idx, sample_idx)


class _BandBody:
    """The capture-safe body of one launch unit: :func:`render_rows`'s
    work for a band of ``rows`` rows and ``spp_chunk`` samples, in three
    stages that read the key, the sample offset and the first row from the
    int64 buffer ``inputs`` (k0, k1, offset, row0) and never read the
    device from the host:

      start  — lane ids, the first camera rays, the loop carry (on the
               fixed-depth path, with ``samples_per_lane`` 1: the whole
               trace);
      step   — ``trips_per_step`` trips of the persistent loop, the carry
               updated in place, ``flag`` set when every lane finished
               (persistent path only);
      finish — the (rows, W, 3) radiance sum.

    ``loop`` (a ``graphs.Loop``): ``steps`` blocks reach the loop's bound
    ``quota * (bounces + 1)``: blocks of ``bounces + 1`` trips, one path's
    longest, so at most ``bounces`` trips run after the last lane finished
    (they change no output word). ``graphs.unit`` captures the stages as a
    ``graphs.StagedUnit``; ``graphs.drive`` replays them, or runs this body
    eagerly on the CPU (``replay`` is ``run``). ``start`` rewrites the
    whole carry, so the warm-up leaves nothing to restore."""

    def __init__(self, scene: Scene, cam: Camera, opts: RenderOptions, spp_chunk: int,
                 rows: int):
        dev = scene.device
        self.label = (f"render_band({opts.width}x{rows} rows, {spp_chunk} spp, {opts.bounces} "
                      f"bounces, {Integrator(opts.integrator).name})")
        self.scene, self.cam, self.opts = scene, cam, opts
        self.spp, self.rows = spp_chunk, rows
        self.ctx = _context(scene, opts)
        self.quota = _quota(opts, spp_chunk)
        self.inputs = torch.zeros((4,), dtype=torch.int64, device=dev)
        persistent = self.quota > 1
        self.loop = graphs.Loop(torch.zeros((), dtype=torch.bool, device=dev),
                                self.quota if persistent else 0,
                                opts.bounces + 1 if persistent else 0)
        self.stages = ("start", "step", "finish") if persistent else ("start", "finish")
        self.lanes, self.state = None, {}

    @property
    def keep(self) -> tuple:
        """What the captured stages read besides the scene's and camera's
        own tensors (which their owners keep alive while the unit lives)."""
        return self.ctx, self.lanes, self.state

    def run(self, stage: str):
        return getattr(self, stage)()

    replay = run

    def save(self):
        return None

    def restore(self, saved) -> None:
        pass

    def start(self):
        opts, dev = self.opts, self.inputs.device
        key, offset, row0 = self.inputs[0:2], self.inputs[2], self.inputs[3]
        if self.quota > 1:
            lanes_pp = self.spp // self.quota
            pixel_idx, px, py, sample_idx = _lane_ids(opts, lanes_pp, offset, row0, self.rows,
                                                      dev)
            lane_base = offset + (sample_idx - offset) * self.quota
            self.lanes = (pixel_idx, px, py)
            st = _persistent_start(self.scene, self.ctx, opts, self.cam, key, self.lanes,
                                   lane_base)
            # own storage per entry (the camera origins are an expanded
            # view), as ``step`` writes the carry in place
            self.state = {k: v.contiguous() for k, v in st.items()}
            return
        self.state = dict(lo_total=_fixed_depth(self.scene, self.ctx, opts, self.cam, key,
                                                offset, self.spp, row0, self.rows))

    def step(self):
        st = self.state
        for _ in range(self.loop.trips_per_step):
            st = _persistent_trip(self.scene, self.ctx, self.opts, self.cam, self.inputs[0:2],
                                  self.lanes, self.quota, st)
        for k, v in st.items():
            self.state[k].copy_(v)
        self.loop.flag.copy_(self.state["finished"].all())

    def finish(self):
        lanes_pp = self.spp // self.quota
        return self.state["lo_total"].reshape(self.rows, self.opts.width, lanes_pp, 3).sum(dim=2)


class _GradBody:
    """The capture-safe differentiable forward of a training unit:
    :func:`render_rows`' fixed-depth work for ``spp_chunk`` samples over
    the band of ``rows`` rows from ``row0``, reading the key words and the
    sample offset from the int64 buffer ``inputs`` (k0, k1, offset) and
    never reading the device from the host. Each call builds the shading
    tables (they carry the gradient) and the raycast's tables from the
    scene it is given, so a captured call packs the corners and tree boxes
    as they stand at each replay; the leaf-of-triangle table depends on
    the tree's topology alone and is built once here. The persistent
    loop has no gradient (``trace_persistent``), so ``samples_per_lane``
    above 1 raises."""

    def __init__(self, scene: Scene, opts: RenderOptions, spp_chunk: int, row0: int, rows: int):
        if _quota(opts, spp_chunk) > 1:
            raise RuntimeError(
                "trace_persistent has no gradient (a while loop in the reference); render "
                "with samples_per_lane=1 to differentiate")
        self.opts, self.spp, self.row0, self.rows = opts, spp_chunk, row0, rows
        self.inputs = torch.zeros((3,), dtype=torch.int64, device=scene.device)
        self.leaf_of = traverse.leaf_of_tri_table(scene.bvh) if (
            opts.accelerator == Accelerator.BVH and scene.bvh is not None) else None

    def __call__(self, scene: Scene, cam: Camera, chunk_offset: int = 0):
        """The (rows, W, 3) radiance sum of samples from ``offset +
        chunk_offset``, recorded by autograd in ``scene``'s and ``cam``'s
        tensors."""
        opts = self.opts
        lo = _fixed_depth(scene, _build_context(scene, opts, self.leaf_of), opts, cam,
                          self.inputs[0:2], self.inputs[2] + chunk_offset, self.spp, self.row0,
                          self.rows)
        return lo.reshape(self.rows, opts.width, self.spp, 3).sum(dim=2)


def _set_inputs(buf, key, sample_offset, row0=None) -> None:
    """Key words, sample offset and (for a render unit) first row into a
    unit's int64 input buffer: one copy from the host for python values,
    device copies for tensors."""
    parts = (key, sample_offset) if row0 is None else (key, sample_offset, row0)
    with profiler.hot("terra.unit.inputs"):
        if not any(isinstance(x, torch.Tensor) for x in parts):
            buf.copy_(torch.as_tensor(np.asarray([*key, *parts[1:]], dtype=np.int64)))
            return
        for dst, x in zip((buf[0:2], buf[2:3], buf[3:4]), parts):
            if isinstance(x, torch.Tensor):
                dst.copy_(x.reshape(dst.shape))
            else:
                dst.copy_(torch.as_tensor(np.asarray(x, dtype=np.int64).reshape(dst.shape)))


def _unit_sum(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, row0,
              spp_chunk: int, rows: int):
    """One launch unit's radiance sum (rows, W, 3): the replayed graph on a
    CUDA scene (its static output: copy it before the next replay), the
    capture-safe body run eagerly on the CPU."""
    global trips
    dev = scene.device
    if dev.type == "cuda":
        body = graphs.unit((scene, cam), (opts, spp_chunk, rows, dev),
                           lambda: _BandBody(scene, cam, opts, spp_chunk, rows))
    else:
        body = _BandBody(scene, cam, opts, spp_chunk, rows)
    _set_inputs(body.inputs, key, sample_offset, row0)
    out, n = graphs.drive(body)
    trips += n
    return out


@torch.no_grad()
def render_band(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset, row0,
                spp_chunk: int, rows: int):
    """``rows`` pixel rows from ``row0`` in one launch unit: the (rows, W,
    3) radiance sum of ``spp_chunk`` samples from ``sample_offset``. One
    capture serves every key, offset and first row (ints or 0-d tensors;
    ``key`` a pair of words or a (2,) int tensor). No gradient."""
    acc = _unit_sum(scene, cam, opts, key, sample_offset, row0, spp_chunk, rows)
    return acc.clone() if acc.is_cuda else acc


@torch.no_grad()
def render_chunk(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset,
                 spp_chunk: int):
    """One launch unit: the (H, W, 3) radiance sum of ``spp_chunk`` samples
    for every pixel (the accumulation plane contribution). No gradient."""
    acc = _unit_sum(scene, cam, opts, key, sample_offset, 0, spp_chunk, opts.height)
    return acc.clone() if acc.is_cuda else acc


@torch.no_grad()
def render_chunks(scene: Scene, cam: Camera, opts: RenderOptions, key, sample_offset,
                  spp_chunk: int, n_chunks: int):
    """``n_chunks`` sample chunks: the chunk unit replayed once per chunk
    and its sums added from zero in the reference's order (its ``lax.scan``
    carry). The live wavefront is one chunk. No gradient."""
    acc = torch.zeros((opts.height, opts.width, 3), dtype=torch.float32, device=scene.device)
    for i in range(n_chunks):
        acc = acc + _unit_sum(scene, cam, opts, key, sample_offset + i * spp_chunk, 0,
                              spp_chunk, opts.height)
    return acc


def _rows_per_launch(opts: RenderOptions, spp_chunk: int) -> int:
    """The most rows whose lanes fit in MAX_WAVEFRONT_LANES (at least one)."""
    lanes_per_row = opts.width * spp_chunk // _quota(opts, spp_chunk)
    return max(MAX_WAVEFRONT_LANES // max(lanes_per_row, 1), 1)


def _band_rows(opts: RenderOptions, spp_chunk: int) -> int:
    """Row-band height keeping a launch under MAX_WAVEFRONT_LANES: the
    whole frame when it fits, else the largest divisor of the height that
    does."""
    target = _rows_per_launch(opts, spp_chunk)
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
    Pass the returned film back in to keep accumulating. It goes through
    the launch units in the reference's order: banded frames band by band
    per chunk (:func:`render_band`); otherwise (without ``debug_checks``)
    the full chunks in one :func:`render_chunks` summed from zero and
    added once, then the remainder by :func:`render_chunk`. On a CUDA
    scene each unit is a captured graph; a capture that fails raises."""
    with profiler.hot("terra.render.pass"):
        if film is None:
            film = Film.create(opts.width, opts.height, scene.device)
        key = rng_mod.key_from_seed(seed)
        spp = opts.samples_per_pixel
        chunk = min(opts.samples_per_launch or spp, spp)
        # resume after the film's samples; a non-uniform film would reuse ids
        with profiler.hot("terra.render.resume_read"):
            base = int(film.samples.max()) if film.samples.numel() else 0
            uniform = not film.samples.numel() or int(film.samples.min()) == base
        if not uniform:
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
                    part = render_band(scene, cam, opts, key, base + done, b0, cur, band)
                    if opts.debug_checks:
                        _validate_acc(part, f"chunk at sample offset {base + done}, rows from {b0}")
                    acc[b0:b0 + band] = acc[b0:b0 + band] + part
                film = Film(acc=acc, samples=film.samples + cur)
                done += cur
            return film
        n_full = spp // chunk
        if n_full > 1 and not opts.debug_checks:
            acc = render_chunks(scene, cam, opts, key, base, chunk, n_full)
            film = Film(acc=film.acc + acc, samples=film.samples + n_full * chunk)
            done = n_full * chunk
        while done < spp:
            cur = min(chunk, spp - done)
            acc = render_chunk(scene, cam, opts, key, base + done, cur)
            if opts.debug_checks:
                _validate_acc(acc, f"chunk at sample offset {base + done}")
            film = Film(acc=film.acc + acc, samples=film.samples + cur)
            done += cur
        return film
