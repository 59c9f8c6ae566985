"""Headline benchmarks of the port on one NVIDIA GPU: every config of the
repo's ``bench.py``, one JSON line each. Port of ``bench.py``.

    python -m terra_tpu_torch.bench

Configs, in ``bench.py``'s order, through the port's entry points
(``scenes``, ``render.render_chunk``, ``pallas_traverse.raycast`` and
``traverse_packed``, ``optim.make_train_step``):

  1.  cornell_fwd_mrays_per_chip: the Cornell box by brute force, SIMPLE,
      256x256, 64 spp, 4 bounces, one persistent lane of 64 samples a pixel.
  2.  cornell_ggx_mis_mrays: GGX walls, DIRECT_MIS, 512x512, 256 spp,
      lanes of 256.
  3.  courtyard_bvh_mrays: the 241,764-triangle courtyard; the SAH build
      alone (``build_ms``), then 2^20 camera rays, each timed call the
      dir3 keys, the sort and the traversal kernel.
  3i. courtyard_incoherent_mrays: 2^20 rays from uniform origins in the
      scene's box with uniform sphere directions, octant keys.
  3s. courtyard_bounce_mrays: cosine first-bounce rays from the camera
      rays' hits, sorted by the parent-hit keys.
  3b. courtyard_render_mrays: the courtyard render, 384x384, 8 spp, 2
      bounces, DIRECT, lanes of 8.
  3m. mega_bvh_mrays: the 1,013,964-triangle courtyard, 2^20 dir3-sorted
      camera rays, with the per-ray counters of one counted launch.
  4.  inverse_step_ms: the blockless Cornell box, 32x32, 8 spp, 2 bounces,
      DIRECT, Adam 3e-2 on the materials' attributes.

Rays are counted as ``bench.py`` counts them: a render's rays are its
lanes times the path rays (the camera ray and every continuation live
entering a bounce) and the shadow rays (per bounce, on the lanes live at
the shade point), with the live fractions measured by
:func:`measure_avg_active` on a 64x64x8 probe render (:func:`ray_count`).
A traversal config counts its 2^20 rays.

Times: a render config takes the host clock around each of
:data:`RENDER_REPS` renders after one that captures the launch units'
CUDA graphs, each with its own key (``fold_in(key, i + 1)``) and ending
in a host read of the image sum; the median. A traversal config
captures its call as a CUDA graph and takes CUDA events around
:data:`WALK_REPS` replays, the origins cycling through eight copies
shifted by 1e-6 x (k + 1); the mean. The
inverse step takes CUDA events around :data:`INVERSE_STEPS` steps after
the capturing one, a host read of the loss after them.

Before any timing, config 3 holds the traversal kernel to brute force
and config 3m to the packet walk on 2048 rays (equal hit masks, t within
rtol and atol 1e-4); a mismatch raises and the config writes an error
line. Each line has ``bench.py``'s keys, ``vs_baseline`` null (the
reference's baselines were taken on a TPU), the card's name and power
limit (``card``), ``device_count``, and ``launches``: each traversal
kernel's launches on the config's own path since the previous line (the
gates' launches left out). A render line adds ``rays``, the live
``fractions``, each timed render's seconds (``runs``), the capturing
render's (``first_s``) and the persistent loop's ``trips`` a render; a
traversal line adds ``call_ms``, the timed call, which includes copying
the shifted origins into the call's buffer. A config that raises writes
an error line and the later configs still run; the process then exits 1.
Without a CUDA device it exits 1 at once: there is no CPU path.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from . import bsdf, camera as camera_mod, graphs, intersect, optim, profile, scenes
from .accel import lbvh, pallas_traverse as pt, traverse
from .ops import math3, rng
from .ops.rng import PathStreams as S
from .render import _lane_ids, _pixel_jitter, make_raycast_fn, render_chunk, render_chunks
from .scene import Accelerator, BSDFType, Integrator, RenderOptions
from .surface import build_shade_tables, surface_init

COURTYARD_TRIS = 241764  # pinned scene size; a drift means the scene changed
N_RAYS = 1 << 20         # rays of each traversal config
RENDER_REPS = 5          # timed renders a render config, after the capturing one
WALK_REPS = 20           # timed calls a traversal config, after a warm-up
INVERSE_STEPS = 20       # timed steps of config 4, after the capturing one
N_CHECK = 2048           # rays of each kernel gate
INCOHERENT_SEED = 11     # bench.py's generator seeds of the 3i and 3s batches
BOUNCE_SEED = 12

# config 3b (bench.py:384-391), config 3m's scene (:406), config 4 (:499-502)
COURTYARD_RENDER = RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                                 integrator=Integrator.DIRECT, subpixel_jitter=0.5,
                                 samples_per_lane=8)
MEGA_SCENE = dict(grid=690, columns=40)
INVERSE = RenderOptions(width=32, height=32, samples_per_pixel=8, bounces=2,
                        integrator=Integrator.DIRECT, rr_start_bounce=8)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


@functools.cache
def _device_keys() -> dict:
    return {"card": profile.card(), "device_count": torch.cuda.device_count()}


def _emit(metric, value, unit, **extra):
    """One JSON line on stdout: ``bench.py``'s keys (``vs_baseline`` null),
    the card, and each traversal kernel's launches since the last line
    (the launch counter is cleared after)."""
    counted = profile.kernel_launches
    line = {"metric": metric, "value": round(float(value), 3), "unit": unit,
            "vs_baseline": None, **_device_keys(),
            "launches": {"bvh_traverse": counted["binary"], "bvh4_traverse": counted["bvh4"]}}
    line.update(extra)
    counted.clear()
    print(json.dumps(line), flush=True)


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in`` of the raw threefry key ``key`` (two words):
    the cipher of the counter (0, data)."""
    y0, y1 = rng.threefry2x32(key[0], key[1], torch.zeros((1,), dtype=torch.int64),
                              torch.tensor([int(data)], dtype=torch.int64))
    return int(y0), int(y1)


@torch.no_grad()
def measure_avg_active(scene, cam, opts, key, device) -> list:
    """Measured live-lane fraction entering each bounce (for honest ray
    counting): a 64x64x8 probe render on ``device`` whose lanes stop at a
    miss or at roulette, approximated on unit throughput."""
    probe_opts = opts.replace(width=64, height=64, samples_per_pixel=8)
    pixel_idx, px, py, sample_idx = _lane_ids(probe_opts, 8, 0, 0, 64, device)
    r1, r2 = _pixel_jitter(probe_opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(cam, 64, 64, px, py, probe_opts.subpixel_jitter, r1, r2)
    raycast = make_raycast_fn(scene, probe_opts)
    tables = build_shade_tables(scene)
    active = torch.ones(o.shape[0], dtype=torch.bool, device=device)
    fractions = []
    for bounce in range(opts.bounces + 1):
        hit = raycast(o, d)
        surf = surface_init(scene, tables, o + d * intersect.RAY_OFFSET_DIR, d, hit.tri)
        wo = -d
        active = active & hit.hit
        fractions.append(active.float().mean())
        e0, e1, e2, e3 = (rng.path_uniform(key, pixel_idx, sample_idx, bounce, s)
                          for s in (S.BSDF_E0, S.BSDF_E1, S.BSDF_E2, S.ROULETTE))
        wi, aux = bsdf.sample(surf, e0, e1, e2, wo)
        pdf = torch.clamp(bsdf.pdf(surf, wi, wo, aux), min=1e-4)
        f = bsdf.eval_f(surf, wi, wo)
        tp_gain = math3.max3(f * (math3.dot(surf.normal, wi) / pdf)[..., None])
        # approximation of the roulette survival on unit throughput
        active = active & (e3 <= torch.clamp(tp_gain, max=1.0))
        o = surf.point + surf.normal * intersect.SURFACE_OFFSET_NORMAL
        d = wi
    return torch.stack(fractions).cpu().tolist()


def ray_count(opts, fractions, shadow_rays_per_bounce: int) -> float:
    """Rays of one render at ``opts``: lanes x (path rays + shadow rays),
    the path rays the camera ray and the continuations live entering each
    bounce (``fractions`` of :func:`measure_avg_active`), the shadow rays
    ``shadow_rays_per_bounce`` on the lanes live at each shade point."""
    lanes = opts.width * opts.height * opts.samples_per_pixel
    path_rays = 1.0 + sum(fractions[:-1])
    shadow_rays = shadow_rays_per_bounce * (1.0 + sum(fractions[:-1]))
    return lanes * (path_rays + shadow_rays)


def _timed_render(scene, cam, opts, key, shadow_rays_per_bounce: int):
    """(Mrays/s, median seconds, extra line keys) of a full render: the
    launch units captured by a first render, then :data:`RENDER_REPS`
    renders on the host clock, each with its own key and ending in a host
    read of the image sum. All full sample chunks go through one
    ``render_chunks`` call when ``samples_per_launch`` is below the spp."""
    fractions = measure_avg_active(scene, cam, opts, key, scene.device)
    total_rays = ray_count(opts, fractions, shadow_rays_per_bounce)
    spp = opts.samples_per_pixel
    spp_chunk = min(opts.samples_per_launch or spp, spp)
    n_chunks = spp // spp_chunk

    if n_chunks > 1:
        def run(k):
            return render_chunks(scene, cam, opts, k, 0, spp_chunk, n_chunks).sum()
    else:
        def run(k):
            return render_chunk(scene, cam, opts, k, 0, spp_chunk).sum()

    t0 = time.perf_counter()
    float(run(key))  # captures the units
    first_s = time.perf_counter() - t0
    runs = []
    # the module's trip count (the package's ``render`` is the function)
    render_mod = sys.modules[render_chunk.__module__]
    render_mod.trips = 0
    for i in range(RENDER_REPS):
        k = fold_in(key, i + 1)
        t0 = time.perf_counter()
        float(run(k))
        runs.append(time.perf_counter() - t0)
    dt = statistics.median(runs)
    return total_rays / dt / 1e6, dt, dict(rays=total_rays, fractions=fractions, runs=runs,
                                           first_s=first_s,
                                           trips=render_mod.trips / RENDER_REPS)


def bench_cornell(device, key):
    scene = scenes.cornell_box(accelerator=Accelerator.BRUTE, device=device)
    cam = scenes.cornell_camera(device=device)
    opts = RenderOptions(
        width=256, height=256, samples_per_pixel=64, bounces=4,
        integrator=Integrator.SIMPLE, subpixel_jitter=0.5,
        samples_per_launch=64, samples_per_lane=64,
    )
    _log("config 1: cornell diffuse 256^2 ...")
    mrays, dt, info = _timed_render(scene, cam, opts, key, shadow_rays_per_bounce=0)
    _emit("cornell_fwd_mrays_per_chip", mrays, "Mrays/s", seconds=round(dt, 3), **info)


def bench_ggx_mis(device, key):
    scene = scenes.cornell_box(accelerator=Accelerator.BRUTE, wall_bsdf=BSDFType.GGX,
                               device=device)
    cam = scenes.cornell_camera(device=device)
    opts = RenderOptions(
        width=512, height=512, samples_per_pixel=256, bounces=4,
        integrator=Integrator.DIRECT_MIS, subpixel_jitter=0.5,
        samples_per_launch=256, samples_per_lane=256,
    )
    _log("config 2: cornell GGX+MIS 512^2 256 spp ...")
    # DIRECT_MIS issues 2 strategy raycasts per shaded bounce (light + bsdf)
    mrays, dt, info = _timed_render(scene, cam, opts, key, shadow_rays_per_bounce=2)
    _emit("cornell_ggx_mis_mrays", mrays, "Mrays/s", seconds=round(dt, 3), **info)


def camera_rays(cam, n: int, device):
    """``n`` (a square) unjittered camera rays, one per pixel of a sqrt(n)
    square image, row by row."""
    side = int(np.sqrt(n))
    ar = torch.arange(side, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ar, ar, indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    zeros = torch.zeros_like(px)
    o, d = camera_mod.generate_rays(cam, side, side, px, py, 0.0, zeros, zeros)
    return o.contiguous(), d


def incoherent_rays(bvh, n: int, device):
    """Config 3i's rays: origins uniform in the root box, directions
    uniform on the sphere, from ``bench.py``'s generator and seed."""
    gen = np.random.default_rng(INCOHERENT_SEED)
    lo = bvh.node_min[0].cpu().numpy()
    hi = bvh.node_max[0].cpu().numpy()
    o = lo + gen.random((n, 3), np.float32) * (hi - lo)
    v = gen.normal(size=(n, 3)).astype(np.float32)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


@torch.no_grad()
def bounce_rays(scene, o, d, tri):
    """Config 3s's rays: cosine-hemisphere directions about the shading
    normal at each camera ray's hit on triangle ``tri``, the origins lifted
    1e-4 off the surface, from ``bench.py``'s generator, seed and tangent
    axis."""
    n, dev = o.shape[0], o.device
    surf = surface_init(scene, build_shade_tables(scene), o + d * intersect.RAY_OFFSET_DIR, d,
                        tri)
    gen = np.random.default_rng(BOUNCE_SEED)
    e1 = torch.as_tensor(gen.random(n, np.float32), device=dev)
    e2 = torch.as_tensor(gen.random(n, np.float32), device=dev)
    st = torch.sqrt(torch.clamp(1.0 - e1, min=0.0))
    phi = float(np.float32(2.0 * np.pi)) * e2
    nrm = surf.normal
    t_ax = math3.normalize(math3.cross(nrm, torch.tensor([0.12, 0.98, 0.17], device=dev)))
    b_ax = math3.cross(nrm, t_ax)
    d_s = math3.normalize((st * torch.cos(phi))[:, None] * t_ax
                          + (st * torch.sin(phi))[:, None] * b_ax
                          + torch.sqrt(e1)[:, None] * nrm)
    o_s = surf.point + nrm * float(np.float32(1e-4))
    return o_s.contiguous(), d_s.contiguous()


def _check_hits(hit_k, hit_ref, what: str) -> None:
    """Raise unless the hit masks are equal and t agrees within rtol and
    atol 1e-4 where both hit. Triangle ids may differ on exact-t ties."""
    n = hit_k.hit.shape[0]
    if not torch.equal(hit_k.hit, hit_ref.hit):
        bad = int((hit_k.hit != hit_ref.hit).sum())
        raise AssertionError(f"{what}: hit mask mismatch on {bad}/{n} rays")
    both = hit_k.hit & hit_ref.hit
    if bool(both.any()) and not torch.allclose(hit_k.t[both], hit_ref.t[both], rtol=1e-4,
                                               atol=1e-4):
        worst = float((hit_k.t[both] - hit_ref.t[both]).abs().max())
        raise AssertionError(f"{what}: t mismatch (max |dt| = {worst})")


def _gate_raycast(scene, o, d):
    """``pallas_traverse.raycast`` (the kernel on a CUDA scene) for a
    gate: its launches are not the config's, so they are taken back."""
    with profile.launches_taken_back():
        return pt.raycast(scene, o, d)


def _verify_compiled_kernel(scene, o, d, n_check: int = N_CHECK):
    """Gate: ``pallas_traverse.raycast`` (the kernel on a CUDA scene)
    against ``intersect.raycast_brute`` on the first ``n_check`` rays."""
    o_s, d_s = o[:n_check].contiguous(), d[:n_check].contiguous()
    hit_k = _gate_raycast(scene, o_s, d_s)
    hit_b = intersect.raycast_brute(o_s, d_s, *scene.geometry.corners())
    _check_hits(hit_k, hit_b, "traversal kernel against brute force")
    _log(f"  kernel gate ok ({n_check} rays vs brute force)")


def _verify_wide_kernel(scene, o, d, n_check: int = N_CHECK):
    """Gate: ``pallas_traverse.raycast`` against the packet walk
    (``accel/traverse.raycast``, an independent walk of the binary tree)
    on the first ``n_check`` rays."""
    o_s, d_s = o[:n_check].contiguous(), d[:n_check].contiguous()
    hit_k = _gate_raycast(scene, o_s, d_s)
    hit_x = traverse.raycast(scene, o_s, d_s)
    _check_hits(hit_k, hit_x, "traversal kernel against the packet walk")
    _log(f"  wide-kernel gate ok ({n_check} rays vs the packet walk)")


def _walk_mrays(bvh, tables, o, d, mode: str, hint=None, leaf_of=None) -> tuple:
    """(Mrays/s, extra line keys) of the bench's timed call on (o, d): the
    coherence keys (``mode``'s, or the parent-hit keys of ``hint``), the
    stable sort and ``traverse_packed`` over an origin buffer, captured
    once as a CUDA graph (``graphs.staged_unit``: the counterpart of
    ``bench.py``'s jitted call; eager, the host's dispatch of the keys'
    small kernels can pace the device). Timed by CUDA events over
    :data:`WALK_REPS` replays, each after copying one of eight shifted
    copies of the origins into the buffer (the copy is inside the timed
    window). The key: ``call_ms``, that mean."""
    perturbs = [o + float(np.float32(1e-6 * (k + 1))) for k in range(8)]
    o_buf = o.clone()

    def call():
        order = traverse.sort_order(bvh, o_buf, d, mode, hint, leaf_of)
        best_t, _ = pt.traverse_packed(tables, o_buf[order], d[order])
        return torch.clamp(best_t, max=1e9).sum()

    unit = graphs.staged_unit(profile.StageBody("walk", call, o_buf))  # warms up, captures
    shifted = itertools.cycle(perturbs)

    def replay():
        o_buf.copy_(next(shifted))
        unit.replay("walk")

    call_ms = profile.device_ms(replay, WALK_REPS, warm_up=False)
    return o.shape[0] / call_ms / 1e3, dict(call_ms=call_ms)


def _table_kind(bvh) -> str:
    return pt.wide_mode(bvh) or "binary"


def bench_courtyard(device, key):
    _log("config 3: courtyard 242k-tri build+traversal ...")
    t0 = time.perf_counter()
    # the port's builders run on the host and commit to the device (the
    # reference's _host_courtyard moves a CPU build to the TPU)
    scene = scenes.courtyard(device=device)
    scene.bvh.node_min[:1].cpu()  # host read = completion proof
    total_build_s = time.perf_counter() - t0
    ntri = scene.geometry.num_triangles
    if ntri != COURTYARD_TRIS:
        _log(f"  WARNING: courtyard drifted to {ntri} tris "
             f"(bench.py pins {COURTYARD_TRIS})")
    # isolate the BVH build itself (scene construction includes geometry)
    t0 = time.perf_counter()
    bvh = lbvh.build(scene.geometry, leaf_size=scene.bvh.leaf_size)
    bvh.node_min[:1].cpu()
    build_ms = (time.perf_counter() - t0) * 1e3
    del bvh

    cam = scenes.courtyard_camera(device=device)
    o, d = camera_rays(cam, N_RAYS, device)
    tables = pt.pack_tables_auto(scene.bvh, *scene.geometry.corners())
    _log(f"  pack_tables_auto: {_table_kind(scene.bvh)} tables")
    _verify_compiled_kernel(scene, o, d)

    # camera batches are known-coherent: direction-major key (dir3)
    mrays, walk = _walk_mrays(scene.bvh, tables, o, d, "dir3")
    _emit("courtyard_bvh_mrays", mrays, "Mrays/s", tris=ntri, build_ms=round(build_ms, 1),
          scene_build_s=round(total_build_s, 2), **walk)

    _log("config 3i: courtyard incoherent rays ...")
    o_i, d_i = incoherent_rays(scene.bvh, N_RAYS, device)
    mrays_i, walk = _walk_mrays(scene.bvh, tables, o_i, d_i, "octant")
    _emit("courtyard_incoherent_mrays", mrays_i, "Mrays/s", tris=ntri, **walk)
    del o_i, d_i

    _log("config 3s: courtyard first-bounce (cosine) rays ...")
    hit0 = pt.raycast(scene, o, d, tables=tables)
    o_s, d_s = bounce_rays(scene, o, d, hit0.tri)
    # the production bounce sort: parent-hit (leaf, dir3) keys
    leaf_of = traverse.leaf_of_tri_table(scene.bvh)
    mrays_s, walk = _walk_mrays(scene.bvh, tables, o_s, d_s, "octant", hint=hit0.tri,
                                leaf_of=leaf_of)
    _emit("courtyard_bounce_mrays", mrays_s, "Mrays/s", tris=ntri, sort="parent-hit", **walk)
    del o_s, d_s, hit0, o, d

    _log("config 3b: courtyard full render 384^2 ...")
    mrays_r, dt_r, info = _timed_render(scene, cam, COURTYARD_RENDER, key,
                                        shadow_rays_per_bounce=1)
    _emit("courtyard_render_mrays", mrays_r, "Mrays/s", seconds=round(dt_r, 3), **info)


def bench_mega(device, key):
    """Config 3m: the ~1M-triangle courtyard on the tables
    ``pack_tables_auto`` picks, with one counted launch's iterations, pops
    and leaf visits (``count_decode``: per 32-ray warp here, per 1024-ray
    packet on the TPU; the units differ)."""
    _log("config 3m: 1M-tri scene ...")
    t0 = time.perf_counter()
    scene = scenes.courtyard(**MEGA_SCENE, device=device)  # 1,013,964 tris
    scene.bvh.node_min[:1].cpu()
    build_s = time.perf_counter() - t0
    bvh = scene.bvh
    mode = pt.wide_mode(bvh)
    _log(f"  tris={scene.geometry.num_triangles} leaf={bvh.leaf_size} wide={bvh.num_wide} "
         f"wide_mode={mode} (pack_tables_auto: {_table_kind(bvh)} tables) build={build_s:.1f}s")

    cam = scenes.courtyard_camera(device=device)
    o, d = camera_rays(cam, N_RAYS, device)
    tables = pt.pack_tables_auto(bvh, *scene.geometry.corners())
    _verify_wide_kernel(scene, o, d)

    mrays, walk = _walk_mrays(bvh, tables, o, d, "dir3")
    # one counted launch on the same sorted rays; a counter failure fails
    # the config
    order = traverse.sort_order(bvh, o, d, "dir3")
    _, _, steps = pt.traverse_packed(tables, o[order], d[order], count_steps=True)
    c = pt.count_decode(steps)
    _emit("mega_bvh_mrays", mrays, "Mrays/s", tris=scene.geometry.num_triangles,
          leaf_size=bvh.leaf_size, box_enc=str(mode), build_s=round(build_s, 1),
          iters=int(c["iters"].sum()), pops=int(c["pops"].sum()),
          leaf_visits=int(c["leaves"].sum()), **walk)


def bench_inverse(device, key):
    _log("config 4: inverse-render step ...")
    scene_gt = scenes.cornell_box(with_blocks=False, device=device)
    cam = scenes.cornell_camera(device=device)
    opts = INVERSE
    with torch.no_grad():
        target = optim.render_mean_image(scene_gt, cam, opts, key, 0, 8)
    attrs0 = scene_gt.materials.attrs.clone()
    attrs0[0, 0, :] = torch.tensor([0.3, 0.5, 0.6], device=device)
    scene0 = dataclasses.replace(
        scene_gt, materials=dataclasses.replace(scene_gt.materials, attrs=attrs0))

    adam = functools.partial(torch.optim.Adam, lr=3e-2)
    state = optim.TrainState(optim.extract_params(scene0, ("attrs",)), None, 0)
    step = optim.make_train_step(cam, opts, target, adam)
    state, loss = step(state, scene0, key)
    float(loss)  # host read: the unit is captured and has run
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(INVERSE_STEPS):
        state, loss = step(state, scene0, key)
    stop.record()
    final = float(loss)  # host read: the completion barrier
    ms = start.elapsed_time(stop) / INVERSE_STEPS
    _emit("inverse_step_ms", ms, "ms/step", final_loss=round(final, 6))


CONFIGS = (bench_cornell, bench_ggx_mis, bench_courtyard, bench_mega, bench_inverse)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("terra_tpu_torch.bench: no CUDA device (torch.cuda.is_available() is "
                         "False); the bench runs on an NVIDIA GPU and has no CPU path")
    device = torch.device("cuda")
    key = rng.key_from_seed(0)
    failed = []
    for fn in CONFIGS:
        profile.kernel_launches.clear()
        try:
            fn(device, key)
        except Exception as e:  # keep later configs alive; record the failure
            traceback.print_exc(file=sys.stderr)
            _emit(fn.__name__, 0.0, "error", error=f"{type(e).__name__}: {e}")
            failed.append(fn.__name__)
        finally:
            graphs.clear()
            torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"terra_tpu_torch.bench: {len(failed)} config(s) failed: "
                         f"{', '.join(failed)}")


if __name__ == "__main__":
    main()
