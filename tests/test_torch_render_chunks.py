"""The port's launch units (``render_chunk``, ``render_band``,
``render_chunks``) and their capture-safe body, on the CPU.

The units against ``terra_tpu.render``'s jitted ones on the same scene, key
and options; the capture-safe body (tensor key, device-scalar sample
offset and first row, the persistent loop in blocks run to its bound)
against the eager ``render_rows`` bit for bit; the functions whose host
copies were removed against their earlier forms; the cache keys of the
captured graphs; the launch bookkeeping of a replay with a stub graph;
and the order in which ``render`` calls the units.
"""
import gc
import importlib
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terra_tpu as tt
import terra_tpu_torch as ttt
from terra_tpu.ops import rng as jrng
from terra_tpu.render import render_band as j_render_band
from terra_tpu.render import render_chunk as j_render_chunk
from terra_tpu.render import render_chunks as j_render_chunks
from terra_tpu_torch import camera as camera_mod
from terra_tpu_torch import graphs, integrators, intersect, profile
from terra_tpu_torch.ops import math3, rng
from tests.test_golden import _assert_twin_match

# ``ttt.render`` is the function; the module holds the units and the body
render_mod = importlib.import_module("terra_tpu_torch.render")

SIZE = dict(width=24, height=24, bounces=2, subpixel_jitter=0.5, samples_per_lane=4)
SPP = 8


@pytest.fixture(autouse=True)
def torch_one_thread():
    """One torch thread (see tests/test_torch_bsdf.py: MKL's threaded sqrt
    after JAX has run was sometimes inexact on the test host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cornell(**kw):
    return ttt.scenes.cornell_box(device="cpu", **kw), ttt.scenes.cornell_camera(device="cpu")


@pytest.fixture(scope="module")
def reference():
    """terra_tpu's three units on the Cornell box, DIRECT, persistent lanes
    of 4: the chunk, two bands of 8 rows and two chunks of 4 spp."""
    opts = tt.RenderOptions(**SIZE, samples_per_pixel=SPP, integrator=tt.Integrator.DIRECT)
    scene, cam = tt.scenes.cornell_box(), tt.scenes.cornell_camera()
    key = jnp.array(jrng.key_from_seed(5), jnp.uint32)
    out = {"chunk": j_render_chunk(scene, cam, opts, key, jnp.int32(3), SPP),
           "chunks": j_render_chunks(scene, cam, opts, key, jnp.int32(3), 4, 2)}
    for row0 in (0, 16):
        out[f"band{row0}"] = j_render_band(scene, cam, opts, key, jnp.int32(3), jnp.int32(row0),
                                           SPP, 8)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("unit", ["chunk", "band0", "band16", "chunks"])
def test_units_match_reference(reference, unit):
    """Each unit against terra_tpu's on the same inputs: the twin budgets of
    tests/test_golden.py (a lane of 4,608 flips a discrete decision: one
    pixel is off by 4e-4), and at least 99% of the values within f32
    reassociation of the sample sums."""
    scene, cam = _cornell()
    opts = ttt.RenderOptions(**SIZE, samples_per_pixel=SPP, integrator=ttt.Integrator.DIRECT)
    key = rng.key_from_seed(5)
    if unit == "chunk":
        got = render_mod.render_chunk(scene, cam, opts, key, 3, SPP)
    elif unit == "chunks":
        got = render_mod.render_chunks(scene, cam, opts, key, 3, 4, 2)
    else:
        got = render_mod.render_band(scene, cam, opts, key, 3, int(unit[4:]), SPP, 8)
    got, ref = got.numpy(), reference[unit]
    assert got.shape == ref.shape and np.isfinite(got).all() and got.max() > 0.0
    _assert_twin_match(got, ref, 2e-3, 8e-3, 5e-3)  # a lane or two flips a decision
    same = np.abs(got - ref) <= 1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
    assert same.mean() >= 0.99, f"only {same.mean():.4f} of the values agree to reassociation"
    if unit == "chunk":  # the chunk is the two bands of 8 rows and the middle one
        ports = [render_mod.render_band(scene, cam, opts, key, 3, r, SPP, 8) for r in (0, 8, 16)]
        assert torch.equal(torch.cat(ports), torch.as_tensor(got))


def test_chunks_equal_summed_chunks():
    """render_chunks adds its chunks from zero in the reference's scan
    order: the same words as summing render_chunk by hand."""
    scene, cam = _cornell()
    opts = ttt.RenderOptions(**SIZE, samples_per_pixel=SPP, integrator=ttt.Integrator.DIRECT)
    key = rng.key_from_seed(5)
    acc = torch.zeros((24, 24, 3))
    for i in range(3):
        acc = acc + render_mod.render_chunk(scene, cam, opts, key, 3 + 4 * i, 4)
    assert torch.equal(render_mod.render_chunks(scene, cam, opts, key, 3, 4, 3), acc)


def test_threefry_tensor_key_matches_int_key():
    """A (2,) int64 key tensor and int64 tensor bounces draw the words the
    python-int key and bounce draw."""
    g = np.random.default_rng(0)
    x0 = torch.as_tensor(g.integers(0, 2**32, 4096), dtype=torch.int64)
    x1 = torch.as_tensor(g.integers(0, 2**32, 4096), dtype=torch.int64)
    for seed in (0, 1, 12345, 2**40 + 7):
        key = rng.key_from_seed(seed)
        kt = torch.tensor(key, dtype=torch.int64)
        for a, b in zip(rng.threefry2x32(*key, x0, x1), rng.threefry2x32(kt[0], kt[1], x0, x1)):
            assert torch.equal(a, b)
        sample = x1 % 1024
        streams = render_mod._streams_for(ttt.Integrator.DIRECT_MIS, env_nee=True)
        for bounce in (0, 3):
            ints = rng.path_uniform_bundle(key, x0, sample, bounce, streams)
            tens = rng.path_uniform_bundle(kt, x0, sample, torch.full((4096,), bounce), streams)
            assert sorted(ints) == sorted(tens)
            assert all(torch.equal(ints[s], tens[s]) for s in streams)
        assert torch.equal(rng.path_uniform(key, x0, sample, 2, 5),
                           rng.path_uniform(kt, x0, sample, 2, 5))


BODY_CASES = {
    "direct": (dict(), dict(integrator=ttt.Integrator.DIRECT)),
    "direct_fixed_depth": (dict(), dict(integrator=ttt.Integrator.DIRECT, samples_per_lane=1)),
    "mis_env_nee": (dict(env_value=(0.3, 0.4, 0.5)),
                    dict(integrator=ttt.Integrator.DIRECT_MIS, env_on_miss=True, env_nee=True)),
    "glass_mis": (dict(accelerator=ttt.Accelerator.BVH, block_bsdf=int(ttt.BSDFType.GLASS)),
                  dict(integrator=ttt.Integrator.DIRECT_MIS, bounces=4)),
    "mirror_direct": (dict(accelerator=ttt.Accelerator.BVH, block_bsdf=int(ttt.BSDFType.MIRROR)),
                      dict(integrator=ttt.Integrator.DIRECT, bounces=3)),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_capture_safe_body_matches_eager(case):
    """render_band (the capture-safe body, run eagerly here: a tensor key,
    0-d tensor offset and first row, the loop in blocks with one flag read
    per block) gives render_rows's words (python ints, a flag read every
    trip); it runs at most ``bounces`` trips more."""
    scene_kw, opts_kw = BODY_CASES[case]
    scene, cam = _cornell(**scene_kw)
    opts = ttt.RenderOptions(**{**SIZE, "width": 16, "height": 16, **opts_kw},
                             samples_per_pixel=SPP)
    key = rng.key_from_seed(9)
    render_mod.trips = 0
    eager = render_mod.render_rows(scene, cam, opts, key, 8, SPP, 4, 8)
    eager_trips, render_mod.trips = render_mod.trips, 0
    safe = render_mod.render_band(scene, cam, opts, torch.tensor(key), torch.tensor(8),
                                  torch.tensor(4), SPP, 8)
    assert torch.equal(safe, eager)
    assert eager.abs().max() > 0.0
    if opts.samples_per_lane > 1:
        assert eager_trips <= render_mod.trips <= eager_trips + opts.bounces
    if case == "glass_mis":
        assert render_mod._context(scene, opts)["has_delta"]  # the emit_ok carry is exercised


def test_blocked_loop_to_bound_matches_early_break():
    """Run to its bound without reading the flag (as a capture of every
    block would), the blocked loop gives the words of the eager loop that
    stopped when every lane finished."""
    scene, cam = _cornell()
    opts = ttt.RenderOptions(width=16, height=16, samples_per_pixel=SPP, bounces=4,
                             subpixel_jitter=0.5, samples_per_lane=4,
                             integrator=ttt.Integrator.DIRECT)
    key = rng.key_from_seed(2)
    render_mod.trips = 0
    eager = render_mod.render_rows(scene, cam, opts, key, 0, SPP, 0, 16)
    body = render_mod._BandBody(scene, cam, opts, SPP, 16)
    flag, steps, trips_per_step = body.loop
    assert render_mod.trips < steps * trips_per_step  # it did stop early
    render_mod._set_inputs(body.inputs, torch.tensor(key), 0, 0)
    body.run("start")
    for _ in range(steps):
        body.run("step")
    assert bool(flag)
    assert torch.equal(body.run("finish"), eager)


def _old_generate_rays(camera, width, height, px, py, jitter, r1, r2):
    """generate_rays as it was, with the aspect a 0-d f32 tensor copied to
    the lanes' device."""
    jitter = float(jitter)
    dx = -jitter + 2.0 * r1 * jitter
    dy = -jitter + 2.0 * r2 * jitter
    ndc_x = (px.to(torch.float32) + 0.5 + dx) / float(width)
    ndc_y = (py.to(torch.float32) + 0.5 + dy) / float(height)
    screen_x = 2.0 * ndc_x - 1.0
    screen_y = 1.0 - 2.0 * ndc_y
    aspect = torch.tensor(width / height, dtype=torch.float32, device=px.device)
    tan_half_fov = torch.tan(camera.fov_deg * camera_mod.DEG2RAD / 2.0)
    frustum_x = screen_x * aspect * tan_half_fov
    frustum_y = screen_y * tan_half_fov
    local = math3.normalize(torch.stack([frustum_x, frustum_y, torch.ones_like(frustum_x)], dim=-1))
    xaxis, yaxis, zaxis = camera_mod.camera_basis(camera)
    directions = local[..., 0:1] * xaxis + local[..., 1:2] * yaxis + local[..., 2:3] * zaxis
    return camera.position.expand(directions.shape), directions


@pytest.mark.parametrize("size", [(24, 24), (640, 480), (37, 101)])
def test_generate_rays_unchanged(size):
    """The aspect as a python float rounded to f32 multiplies as the 0-d
    f32 tensor did: the same rays bit for bit."""
    width, height = size
    cam = ttt.scenes.courtyard_camera(device="cpu")
    g = np.random.default_rng(1)
    n = 4096
    px = torch.as_tensor(g.integers(0, width, n))
    py = torch.as_tensor(g.integers(0, height, n))
    r1, r2 = (torch.as_tensor(g.random(n, dtype=np.float32)) for _ in range(2))
    new = camera_mod.generate_rays(cam, width, height, px, py, 0.5, r1, r2)
    old = _old_generate_rays(cam, width, height, px, py, 0.5, r1, r2)
    assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_first_hit_and_dead_rays_unchanged():
    """_first_hit for an int bounce and a lane tensor, the dead-ray mask and
    the debug-normal colours give the words of their forms that copied
    host constants to the device."""
    g = np.random.default_rng(2)
    n = 512
    t = torch.as_tensor(g.random(n, dtype=np.float32))
    surf = type("S", (), {"t": t})()
    lanes = torch.as_tensor(g.integers(0, 3, n))
    for bounce in (0, 1, 2, lanes):
        old = (torch.as_tensor(bounce) == 0).expand(t.shape)[..., None]
        assert torch.equal(integrators._first_hit(surf, bounce), old)
    o = torch.as_tensor(g.normal(size=(n, 3)).astype(np.float32))
    d = torch.as_tensor(g.normal(size=(n, 3)).astype(np.float32))
    active = torch.as_tensor(g.random(n) < 0.5)
    o_q, d_q = intersect.mask_dead_rays(active, o, d)
    live = active[..., None]
    assert torch.equal(o_q, torch.where(live, o, intersect.MISS_ORIGIN))
    assert torch.equal(d_q, torch.where(live, d, torch.tensor([1.0, 0.0, 0.0])))
    normal = torch.nn.functional.normalize(torch.as_tensor(g.normal(size=(n, 3)).astype(
        np.float32)), dim=-1)
    surf = type("S", (), {"t": t, "normal": normal})()
    cols = [torch.tensor(c, dtype=torch.float32) for c in (
        (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
        (0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0))]
    p = torch.clamp(normal, 0.0, 1.0)
    m = -torch.clamp(normal, -1.0, 0.0)
    old = (p[..., 0:1] * cols[0] + p[..., 1:2] * cols[1] + p[..., 2:3] * cols[2]
           + m[..., 0:1] * cols[3] + m[..., 1:2] * cols[4] + m[..., 2:3] * cols[5])
    got = integrators._integrate_debug_normals(None, surf, None, None, 0)
    assert torch.equal(got, old)


def test_unit_cache_keys():
    """What forces a new capture: another scene object of the same shapes,
    a scene tensor changed in place, other options, another row count; the
    same scene, camera and key hit. An entry goes when its scene dies."""
    cache = graphs.WeakCache(8)
    built = []

    def get(scene, cam, key):
        return cache.get((scene, cam), key, lambda: built.append(key) or len(built))

    scene, cam = _cornell()
    opts = ttt.RenderOptions(**SIZE, samples_per_pixel=SPP)
    assert get(scene, cam, (opts, SPP, 24)) == 1
    assert get(scene, cam, (opts, SPP, 24)) == 1  # hit
    twin, _ = _cornell()  # the same shapes and values, another object
    assert get(twin, cam, (opts, SPP, 24)) == 2
    assert get(scene, cam, (opts.replace(bounces=3), SPP, 24)) == 3
    assert get(scene, cam, (opts, SPP, 12)) == 4
    scene.materials.attrs.mul_(1.0)  # in place: the version moves
    assert get(scene, cam, (opts, SPP, 24)) == 5
    assert get(scene, cam, (opts, SPP, 24)) == 5
    scene.env_tex = scene.env_tex  # a plain field left as it was: still a hit
    assert get(scene, cam, (opts, SPP, 24)) == 5
    cam.position = cam.position.clone()  # a camera tensor replaced
    assert get(scene, cam, (opts, SPP, 24)) == 6
    n = len(cache)
    del twin
    gc.collect()
    assert len(cache) == n - 1
    small = graphs.WeakCache(2)
    for rows in (1, 2, 3):
        small.get((scene, cam), rows, lambda: rows)
    assert len(small) == 2 and small.values() == [2, 3]


def test_context_cached_until_scene_changes():
    """The render context (packed tables, shading tables) is built once per
    scene and traversal options, again after an in-place change, and fresh
    under autograd."""
    scene, _ = _cornell(accelerator=ttt.Accelerator.BVH)
    opts = ttt.RenderOptions(**SIZE, samples_per_pixel=SPP)
    a = render_mod._context(scene, opts)
    assert render_mod._context(scene, opts.replace(width=8, bounces=1)) is a
    assert render_mod._context(scene, opts.replace(env_nee=True)) is not a
    scene.geometry.positions.add_(0.0)
    b = render_mod._context(scene, opts)
    assert b is not a and render_mod._context(scene, opts) is b
    scene.materials.attrs.requires_grad_(True)
    assert render_mod._context(scene, opts) is not b
    with torch.no_grad():
        assert render_mod._context(scene, opts) is b


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def counter():
    """``profile.kernel_launches``, put back as it was after the test."""
    with profile.launches_taken_back():
        yield profile.kernel_launches


def _stub_unit(cls, stages, counts, loop=None):
    """A unit of ``cls`` whose stages replay stub graphs that record the
    launches ``counts[stage]``."""
    unit = object.__new__(cls)
    unit.stages, unit.loop, unit.replays = stages, loop, 0
    unit.label, unit.warmup_s, unit.capture_s, unit.pool_bytes = "stub", 0, 0, 0
    unit._graphs = {s: (_StubGraph(), counts.get(s, Counter()), torch.zeros(1)) for s in stages}
    return unit


@pytest.mark.parametrize("kind", ["render", "train"])
def test_replay_adds_captured_launches(kind, counter):
    """A capture's launches are taken back out of the one counter, and a
    replay adds what its stage's capture recorded, under whatever kernel
    names the wrappers counted (``graphs`` knows none of them). The render
    unit runs through ``drive`` by its loop; the training unit replays its
    stages in order, each returning its static output. The replay count
    moves with the first stage."""
    counter.update(binary=5, bvh4=7)
    with profile.launches_taken_back() as captured:
        counter["bvh4"] += 6  # as a capture's wrappers would count
        counter["sweep"] += 3  # a kernel graphs has never heard of
    assert captured == Counter(bvh4=6, sweep=3) and counter == Counter(binary=5, bvh4=7)

    if kind == "render":
        stages = ("start", "step", "finish")
        unit = _stub_unit(graphs.StagedUnit, stages,
                          {"start": Counter(threefry=1), "step": captured},
                          graphs.Loop(torch.tensor(False), 4, 3))
        out, trips = graphs.drive(unit)  # the flag never sets: 4 blocks
        assert out is unit._graphs["finish"][2] and trips == 12
        assert [unit._graphs[s][0].replays for s in stages] == [1, 4, 1]
        assert counter == Counter(binary=5, bvh4=7 + 4 * 6, sweep=4 * 3, threefry=1)
        unit.loop = unit.loop._replace(flag=torch.tensor(True))  # done after one block
        assert graphs.drive(unit)[1] == 3
        assert unit._graphs["step"][0].replays == 5 and unit.replays == 2
        info = unit.describe()
        assert info["trips_per_step"] == 3 and info["max_steps"] == 4
        assert info["launches"] == {"start": {"threefry": 1}, "step": {"bvh4": 6, "sweep": 3},
                                    "finish": {}}
    else:
        stages = ("forward0", "forward1", "backward0", "backward1", "sum")
        unit = _stub_unit(graphs.TrainUnit, stages,
                          {"forward0": captured, "forward1": captured,
                           "backward0": Counter(row_accumulate=7),
                           "backward1": Counter(row_accumulate=7)})
        for _ in range(2):
            for s in stages:
                assert unit.replay(s) is unit._graphs[s][2]
        assert all(g.replays == 2 for g, _, _ in unit._graphs.values()) and unit.replays == 2
        assert counter == Counter(binary=5, bvh4=7 + 2 * 2 * 6, sweep=2 * 2 * 3,
                                  row_accumulate=2 * 2 * 7)
        info = unit.describe()
        assert "trips_per_step" not in info
        assert info["launches"]["forward1"] == {"bvh4": 6, "sweep": 3}
        assert info["launches"]["backward0"] == {"row_accumulate": 7}


def test_render_calls_units_in_reference_order(monkeypatch):
    """render: full chunks through one render_chunks, then the remainder
    through render_chunk; banded frames band by band per chunk; debug
    checks a chunk at a time. The film is the same words as the eager
    render_rows calls in that order."""
    scene, cam = _cornell()
    calls = []
    real = {n: getattr(render_mod, n) for n in ("render_band", "render_chunk", "render_chunks")}

    def spy(name):
        def f(*a):
            calls.append((name,) + tuple(x for x in a[4:]))
            return real[name](*a)
        return f

    for name in real:
        monkeypatch.setattr(render_mod, name, spy(name))
    opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=10, samples_per_launch=4,
                             bounces=2, subpixel_jitter=0.5, samples_per_lane=2,
                             integrator=ttt.Integrator.DIRECT)
    film = ttt.render(scene, cam, opts, seed=4)
    assert calls == [("render_chunks", 0, 4, 2), ("render_chunk", 8, 2)]
    key = rng.key_from_seed(4)
    acc = torch.zeros((12, 12, 3))
    for off in (0, 4):
        acc = acc + render_mod.render_rows(scene, cam, opts, key, off, 4, 0, 12)
    acc = torch.zeros((12, 12, 3)) + acc
    acc = acc + render_mod.render_rows(scene, cam, opts, key, 8, 2, 0, 12)
    assert torch.equal(film.acc, acc) and bool((film.samples == 10).all())

    calls.clear()
    ttt.render(scene, cam, opts.replace(debug_checks=True), seed=4)
    assert calls == [("render_chunk", 0, 4), ("render_chunk", 4, 4), ("render_chunk", 8, 2)]
    calls.clear()
    monkeypatch.setattr(render_mod, "MAX_WAVEFRONT_LANES", 12 * 2 * 5)
    ttt.render(scene, cam, opts, seed=4)
    assert calls == [("render_band", off, b0, cur, 4) for off, cur in ((0, 4), (4, 4), (8, 2))
                     for b0 in (0, 4, 8)]
