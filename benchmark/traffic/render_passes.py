"""Progressive passes in a closed loop of one client.

A pass is one ``terra_tpu_torch.render.render(scene, cam, opts, seed=s_i,
film=film)`` call adding the cell's samples per pixel to one progressive
film, ended by reading the developed image to the host; the next pass
starts when the image is there. Pass i's seed is drawn from the run's
seed and i. Every pass's image is kept at a sample of pixels drawn from
the run's seed; after the window the plain reference recomputes those
pixels through every pass and the two are compared value by value.

Parameters (a mix file's ``params``): width, height, spp,
samples_per_lane, bounces, integrator ("direct" or "direct_mis"),
subpixel_jitter, rr_start_bounce, env ([r, g, b] constant sky; optional),
check_pixels (how many pixels the check follows).
"""
from __future__ import annotations

import importlib
import time

import numpy as np

M64 = (1 << 64) - 1


def pass_seed(seed: int, i: int) -> int:
    """The seed of pass ``i`` (``i`` = -1: the warm-up pass)."""
    return (int(seed) * 0x100000001B3 + 0x9E37 * (i + 2)) & M64


def _program_scene(ctx):
    """The configuration's arrays handed to the program's public scene API."""
    import torch

    S = importlib.import_module("terra_tpu_torch.scene")
    a, dev = ctx.arrays, ctx.device
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)  # noqa: E731
    geom = S.Geometry(t(a["positions"]), t(a["tri_vidx"]), t(a["normals"]), t(a["uvs"]),
                      t(a["mat_id"]), t(a["obj_id"]))
    mats = S.MaterialTable(t(a["bsdf_type"]), t(a["attrs"]), t(a["attr_tex"]), t(a["emissive"]),
                           t(a["emissive_tex"]), t(a["ior"]))
    tex = None if a.get("tex_data") is None else S.TextureAtlas(
        t(a["tex_data"]), t(a["tex_size"]), t(a["tex_filter"]), t(a["tex_address"]))
    accel = ctx.config["accelerator"]
    env = ctx.params.get("env", (0.0, 0.0, 0.0))
    return S.commit(geom, mats, tex, env_value=env,
                    accelerator=S.Accelerator.BVH if accel == "bvh" else S.Accelerator.BRUTE,
                    leaf_size=ctx.config.get("leaf_size"), bvh_builder="sah")


def options(ctx):
    S = importlib.import_module("terra_tpu_torch.scene")
    p = ctx.params
    env = "env" in p
    return S.RenderOptions(
        width=int(p["width"]), height=int(p["height"]), samples_per_pixel=int(p["spp"]),
        bounces=int(p["bounces"]),
        integrator=S.Integrator.DIRECT if p["integrator"] == "direct" else S.Integrator.DIRECT_MIS,
        accelerator=S.Accelerator.BVH if ctx.config["accelerator"] == "bvh" else
        S.Accelerator.BRUTE,
        subpixel_jitter=float(p["subpixel_jitter"]), samples_per_lane=int(p["samples_per_lane"]),
        rr_start_bounce=int(p.get("rr_start_bounce", 0)), env_on_miss=env, env_nee=env)


def camera(ctx):
    S = importlib.import_module("terra_tpu_torch.scene")
    c = ctx.config["camera"]
    return S.Camera.make(c["position"], c["direction"], c["up"], c["fov_deg"],
                         device=ctx.device)


def table_facts(ctx, scene) -> None:
    """Shapes the traversal's roofline is counted from: rays per launch
    (every lane of the wavefront, finished ones as miss rays) and the
    table sizes of the tree the program built."""
    p = ctx.params
    quota = max(int(p["samples_per_lane"]), 1)
    while int(p["spp"]) % quota:
        quota -= 1
    ctx.facts["rays_per_launch"] = int(p["width"]) * int(p["height"]) * int(p["spp"]) // quota
    if scene.bvh is not None:
        bvh = scene.bvh
        ctx.facts.update(num_wide=int(bvh.num_wide), leaf_rows=int(bvh.num_leaves * bvh.leaf_size))


def setup(ctx):
    import torch

    render_mod = importlib.import_module("terra_tpu_torch.render")
    film_mod = importlib.import_module("terra_tpu_torch.film")
    scene = _program_scene(ctx)
    cam, opts = camera(ctx), options(ctx)
    table_facts(ctx, scene)
    # warm-up: captures the pass's launch units; a second pass finds them
    film = None
    for i in (-1, -1):
        film = render_mod.render(scene, cam, opts, seed=pass_seed(ctx.seed, i), film=film)
        film_mod.develop(film).cpu().numpy()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    n = opts.width * opts.height
    k = min(int(ctx.params["check_pixels"]), n)
    pixels = np.random.default_rng(int(ctx.seed) & M64).choice(n, size=k, replace=False)
    return dict(scene=scene, cam=cam, opts=opts, pixels=np.sort(pixels))


def window(ctx, state, seconds: float, slice_=None) -> dict:
    render_mod = importlib.import_module("terra_tpu_torch.render")
    film_mod = importlib.import_module("terra_tpu_torch.film")
    scene, cam, opts, pix = state["scene"], state["cam"], state["opts"], state["pixels"]
    film = film_mod.Film.create(opts.width, opts.height, scene.device)
    times, kept = [], []
    trips0 = render_mod.trips
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds or (slice_ is not None and slice_.pending):
        if slice_ is not None:
            slice_.before(i)
        t0 = time.perf_counter()
        film = render_mod.render(scene, cam, opts, seed=pass_seed(ctx.seed, i), film=film)
        img = film_mod.develop(film).cpu().numpy()
        end = time.perf_counter()
        if slice_ is not None:
            slice_.after(i)
        times.append(end - t0)
        kept.append(img.reshape(-1, 3)[pix])
        i += 1
    ctx.counters["render.trips per pass"] = (render_mod.trips - trips0) / i
    ctx.counters["passes"] = i
    if ctx.device == "cuda":
        graphs = importlib.import_module("terra_tpu_torch.graphs")
        ctx.counters["graph units"] = [{k: u[k] for k in ("label", "captures", "replays")
                                        if k in u} for u in graphs.units()]
    state["kept"] = np.stack(kept)
    state["passes"] = i
    return {"metrics": {"frame_s": (end - start) / i,
                        "frame_p95_s": float(np.percentile(np.asarray(times), 95))},
            "attempted": i, "failed": 0}


def release(ctx, state) -> None:
    """Frees the program's state (its scene, films and captured units)."""
    ctx.kept = state.pop("kept")
    ctx.passes = state.pop("passes")
    ctx.pixels = state["pixels"]
    state.clear()
    if ctx.device == "cuda":
        importlib.import_module("terra_tpu_torch.graphs").clear()


def reference_opts(ctx) -> dict:
    p = ctx.params
    return dict(width=int(p["width"]), height=int(p["height"]), bounces=int(p["bounces"]),
                integrator=p["integrator"], subpixel_jitter=float(p["subpixel_jitter"]),
                rr_start_bounce=int(p.get("rr_start_bounce", 0)), env=p.get("env"))


def reference_values(ctx, tf32: bool = False):
    """(passes, pixels, 3) image values of the plain reference (``tf32``:
    the control) at the kept pixels after every pass of the window."""
    import torch

    from benchmark.reference import pathtrace

    rs = pathtrace.Scene(ctx.arrays, ctx.device, ctx.config["accelerator"], tf32=tf32)
    n = ctx.passes
    seeds = [pass_seed(ctx.seed, i) for i in range(n)]
    pix = torch.as_tensor(ctx.pixels, device=ctx.device)
    with torch.no_grad():
        out = pathtrace.film_values(rs, reference_opts(ctx), ctx.config["camera"], seeds, pix,
                                    int(ctx.params["spp"]), set(range(n)))
    return np.stack([out[j].cpu().numpy() for j in range(n)])


def compare(got, ref, tol: float) -> dict:
    """``off_share``: the share of image values whose gap from the
    reference exceeds ``tol`` of the reference's value (or of the mean
    magnitude, where the value is smaller), a non-finite value counting
    as off. One lane whose path rounds the other way moves one pixel from
    its pass on: at most 1/pixels of the values."""
    scale = np.maximum(np.abs(ref), np.mean(np.abs(ref)))
    gap = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return {"off_share": float(np.mean(~np.isfinite(got) | (gap > tol * scale)))}


def check(ctx) -> list:
    lim = ctx.cell["limits"]
    ref = reference_values(ctx)
    nums = compare(ctx.kept, ref, float(lim["tolerance"]))
    return [(k, v, float(lim[k])) for k, v in nums.items()]
