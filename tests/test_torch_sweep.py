"""The brute-force raycast by device (``intersect.raycast_sweep``). CPU
rays take the plain grid ``raycast_brute`` word for word, load no kernel
and count no launch; an unknown intersector raises; the CUDA wrapper
refuses what it does not take before it builds or launches; the kernel
source exports the entry point ``load_kernel`` binds; the render's brute
branch gives the grid's hits; the benchmark's reader of the kernel's
roofline share counts its work from the shapes. Tests marked ``cuda`` hold
the kernel (``csrc/sweep.cu``) to ``raycast_brute`` on the card word for
word (t, tri, hit): the rays of a Cornell pass, duplicated triangles (ties
at equal t), degenerate triangles and rays parallel to a triangle, with
and without ``t_max``, both intersectors, 1 to 5,000 triangles (several
shared-memory tiles), zero rays, and launches inside a CUDA graph. They
skip without a CUDA device. Nothing here is imported from ``tests`` (the
card's machine has another package of that name)."""
import ctypes
import importlib
import os
import re
import types

import numpy as np
import pytest
import torch

import terra_tpu_torch as ttt
from terra_tpu_torch import graphs, intersect, profile
from terra_tpu_torch.ops import rng

render_mod = importlib.import_module("terra_tpu_torch.render")

ALGOS = ["mt", "watertight"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel runs only on the card")
    return torch.device("cuda")


def _tris(count: int, seed: int, kind: str = "random"):
    """(a, b, c) f32 (count, 3) corners of random triangles around the
    origin. ``duplicates``: every third triangle repeats one of lower id, so
    rays at it meet equal t; ``degenerate``: every fourth has zero area
    (two corners equal, or the three on a line)."""
    gen = np.random.default_rng(seed)
    tri = (gen.uniform(-1.0, 1.0, (count, 1, 3))
           + gen.uniform(-0.3, 0.3, (count, 3, 3))).astype(np.float32)
    if kind == "duplicates":
        for k in range(2, count, 3):
            tri[k] = tri[gen.integers(0, k)]
    elif kind == "degenerate":
        for k in range(0, count, 4):
            if k % 8 == 0:
                tri[k, 1] = tri[k, 0]
            else:
                tri[k, 2] = tri[k, 0] + 2.0 * (tri[k, 1] - tri[k, 0])
    return tuple(torch.from_numpy(np.ascontiguousarray(tri[:, i])) for i in range(3))


def _rays(tris, n: int, seed: int):
    """(o, d, t_max): n rays from random points, half of them aimed at a
    random triangle's centroid, an eighth lying in a triangle's plane
    (parallel to it: |det| = 0), the rest in random directions; t_max
    uniform in (0, 4)."""
    a, b, c = (x.numpy() for x in tris)
    gen = np.random.default_rng(seed)
    o = gen.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    if a.shape[0]:
        pick = gen.integers(0, a.shape[0], n)
        aim = n // 2
        d[:aim] = (a[pick] + b[pick] + c[pick])[:aim] / 3.0 - o[:aim]
        par = slice(aim, aim + n // 8)
        o[par] = a[pick][par] - 2.0 * (b[pick] - a[pick])[par]
        d[par] = (b[pick] - a[pick])[par]
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    t_max = gen.uniform(0.0, 4.0, n).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)), torch.from_numpy(t_max)


def _grid(o, d, tris, t_max, algo):
    """What the render's brute branch computed before the kernel: the grid,
    then the ranged query's occlusion test."""
    h = intersect.raycast_brute(o, d, *tris, algo=algo)
    if t_max is None:
        return h
    occ = h.t < t_max
    return intersect.RayHit(t=h.t, tri=torch.where(occ, h.tri, 0), hit=occ)


def _same_words(got, want) -> None:
    assert got.t.dtype == torch.float32 and got.tri.dtype == torch.int32
    assert got.hit.dtype == torch.bool
    assert torch.equal(got.t.view(torch.int32), want.t.view(torch.int32))
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(got.hit, want.hit)


def _no_build():
    raise AssertionError("the sweep kernel library was loaded")


@pytest.mark.parametrize("ranged", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_cpu_rays_take_the_plain_grid(algo, ranged, monkeypatch):
    """CPU rays go through ``raycast_brute``, never load the kernel, count
    no launch, and give the grid's words; with ``t_max``, its occlusion."""
    tris = _tris(300, 1, "duplicates")
    o, d, t_max = _rays(tris, 500, 2)
    t_max = t_max if ranged else None
    want = _grid(o, d, tris, t_max, algo)
    calls = []
    real = intersect.raycast_brute
    monkeypatch.setattr(intersect, "load_kernel", _no_build)
    monkeypatch.setattr(intersect, "raycast_brute",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = profile.kernel_launches.copy()
    got = intersect.raycast_sweep(o, d, *tris, t_max=t_max, algo=algo)
    assert profile.kernel_launches == before and len(calls) == 1
    _same_words(got, want)
    assert bool(want.hit.any()) and not bool(want.hit.all())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_unknown_intersector_raises(device, monkeypatch):
    """An unknown intersector raises on every device, before a kernel is
    built or a launch counted."""
    monkeypatch.setattr(intersect, "load_kernel", _no_build)
    tris = tuple(x.to(device) for x in _tris(4, 3))
    o = torch.zeros((2, 3), device=device)
    before = profile.kernel_launches.copy()
    with pytest.raises(ValueError, match="unknown intersector"):
        intersect.raycast_sweep(o, o, *tris, algo="plucker")
    assert profile.kernel_launches == before


def _meta_call(case):
    """Arguments of a CUDA-path call on the meta device, broken as ``case``
    says."""
    tris = tuple(x.to("meta") for x in _tris(6, 4))
    o, d, t_max = (x.to("meta") for x in _rays(_tris(6, 4), 8, 5))
    slots = intersect.pack_sweep(*tris)
    if case == "float64 rays":
        o = o.double()
    elif case == "rays of four columns":
        d = torch.empty((8, 4), device="meta")
    elif case == "t_max one short":
        t_max = t_max[:-1]
    elif case == "slots of nine columns":
        slots = slots[:, :9]
    elif case == "slots on the CPU":
        slots = torch.zeros((6, 10))
    elif case == "non-contiguous slots":
        slots = torch.empty((10, 6), device="meta").t()
    return o, d, tris, t_max, slots


@pytest.mark.parametrize("case, match", [
    ("float64 rays", "float32 o"),
    ("rays of four columns", "float32 d of shape"),
    ("t_max one short", "float32 t_max of shape"),
    ("slots of nine columns", "float32 slots of shape"),
    ("slots on the CPU", "device"),
    ("non-contiguous slots", "contiguous slots"),
    ("every tensor right, on no card", "CUDA tensors")])
def test_a_call_the_kernel_does_not_take_raises(case, match, monkeypatch):
    """Rays on a device other than the CPU go to the kernel's wrapper, which
    refuses a call it does not take before it builds, loads or launches
    anything; nothing falls back to the grid."""
    monkeypatch.setattr(intersect, "load_kernel", _no_build)
    monkeypatch.setattr(intersect, "raycast_brute", _no_build)
    o, d, tris, t_max, slots = _meta_call(case)
    before = profile.kernel_launches.copy()
    with pytest.raises(ValueError, match=match):
        intersect.raycast_sweep(o, d, *tris, t_max=t_max, slots=slots)
    assert profile.kernel_launches == before


def test_pack_sweep_rows():
    """The kernel's rows: the corners a, b, c, then the id's i32 bits, in
    id order, contiguous, with no gradient."""
    a, b, c = (x.requires_grad_() for x in _tris(7, 6))
    rows = intersect.pack_sweep(a, b, c)
    assert rows.shape == (7, 10) and rows.dtype == torch.float32 and rows.is_contiguous()
    assert not rows.requires_grad
    assert torch.equal(rows[:, :9], torch.cat([a, b, c], dim=1).detach())
    assert torch.equal(rows[:, 9].contiguous().view(torch.int32), torch.arange(7, dtype=torch.int32))


def test_kernel_source_exports_its_entry_point(monkeypatch):
    """``csrc/sweep.cu`` exports ``terra_sweep`` with C linkage, and
    ``load_kernel`` binds it with one ctypes type per parameter of the
    source's signature (pointers, ``int``, ``int64_t``), returning int."""
    with open(intersect.KERNEL_SRC) as f:
        src = f.read()
    sig = re.search(r'extern "C" int terra_sweep\(([^)]*)\)', src)
    assert sig is not None
    kinds = {"*": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    want = [next(v for k, v in kinds.items() if k in p) for p in sig.group(1).split(",")]
    lib = types.SimpleNamespace(terra_sweep=types.SimpleNamespace())
    monkeypatch.setattr(intersect, "kernel_path", lambda: "sweep.so")
    monkeypatch.setattr(intersect.ctypes, "CDLL", lambda path: lib)
    assert intersect.load_kernel.__wrapped__() is lib
    assert lib.terra_sweep.argtypes == want and lib.terra_sweep.restype is ctypes.c_int
    assert len(want) == 11


def _record_raycasts(monkeypatch):
    """Every ``raycast_sweep`` call's (o, d, t_max, algo) and result."""
    calls = []
    real = intersect.raycast_sweep

    def recorder(o, d, tri_a, tri_b, tri_c, t_max=None, algo="mt", slots=None):
        h = real(o, d, tri_a, tri_b, tri_c, t_max=t_max, algo=algo, slots=slots)
        calls.append((o.detach().clone(), d.detach().clone(),
                      None if t_max is None else t_max.detach().clone(), algo, h))
        return h

    monkeypatch.setattr(intersect, "raycast_sweep", recorder)
    return calls


def _cornell_opts(**kw):
    return ttt.RenderOptions(width=16, height=16, samples_per_pixel=2, bounces=2,
                             integrator=ttt.Integrator.DIRECT_MIS, subpixel_jitter=0.5, **kw)


@pytest.mark.parametrize("algo", ALGOS)
def test_render_brute_branch_gives_the_grid_hits(algo, monkeypatch):
    """The brute branch of ``make_raycast_fn`` on a small Cornell render
    (DIRECT_MIS: the closest hit, the light's shadow ray with ``t_max``
    and the BSDF ray each bounce) goes through ``raycast_sweep``, and each
    call's hits equal the grid's on the same rays, word for word."""
    scene, cam = ttt.scenes.cornell_box(device="cpu"), ttt.scenes.cornell_camera(device="cpu")
    opts = _cornell_opts(intersector=ttt.Intersector.WATERTIGHT if algo == "watertight"
                         else ttt.Intersector.MT)
    calls = _record_raycasts(monkeypatch)
    render_mod.render_rows(scene, cam, opts, rng.key_from_seed(7), 0, 2, 0, 16)
    assert len(calls) >= 9
    assert any(c[2] is not None for c in calls) and any(c[2] is None for c in calls)
    tris = tuple(x.detach() for x in scene.geometry.corners())
    for o, d, t_max, got_algo, h in calls:
        assert got_algo == algo
        _same_words(h, _grid(o, d, tris, t_max, algo))


def _trace(*kernels):
    """A profiler trace of two passes (0-100 and 100-200 us) holding
    ``kernels`` as (name, ts, dur)."""
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts,  # noqa: E731
                                     "dur": dur}
    return {"traceEvents": [ev("bench.item", "user_annotation", 0, 100),
                            ev("bench.item", "user_annotation", 100, 100),
                            *(ev(n, "kernel", ts, dur) for n, ts, dur in kernels)]}


def test_sweep_roofline_reader():
    """``benchmark/metrics/sweep_roofline.py`` on a synthetic trace: the
    kernel's instances by name, a launch's bytes and operations counted by
    hand for one shape, the share priced at the H100's peaks, and nothing
    where the trace or the facts hold nothing to read."""
    from benchmark import harness, peaks
    from benchmark.trace import TraceView

    reader = harness.load_module(os.path.join(ROOT, "benchmark", "metrics", "sweep_roofline.py"),
                                 "test_sweep_roofline_reader")
    closest = "void (anonymous namespace)::sweep_kernel<0, false>(const float*, int64_t)"
    shadow = "void (anonymous namespace)::sweep_kernel<1, true>(const float*, int64_t)"
    assert reader.sweep_instance(closest) == (0, False)
    assert reader.sweep_instance(shadow) == (1, True)
    assert reader.sweep_instance("void bvh4_traverse_kernel<0, true, true, 0>()") is None
    # 1,000 rays x 32 triangles: 24 B of ray (+4 of t_max), 9 B of hit, 40 B a triangle row;
    # 46 operations a pair and 6 a triangle
    assert reader.sweep_launch(1000, 32, False) == {"bytes": 1000 * 33 + 32 * 40,
                                                    "flops": 1000 * 32 * 46 + 32 * 6}
    assert reader.sweep_launch(1000, 32, True) == {"bytes": 1000 * 37 + 32 * 40,
                                                   "flops": 1000 * 32 * 46 + 32 * 6}
    h100 = peaks.for_device("NVIDIA H100 80GB HBM3")
    trace = _trace((closest, 10, 20), ("k_other", 40, 30), (shadow, 120, 40))
    ctx = types.SimpleNamespace(trace=TraceView(trace), facts={"rays_per_launch": 1000},
                                peaks=h100, config={"triangles": 32})
    least = (max(34280 / 3.35e12, 1472192 / 67e12) + max(38280 / 3.35e12, 1472192 / 67e12))
    assert reader.read(ctx) == pytest.approx(100.0 * least / 60e-6)
    nothing = [dict(ctx.__dict__, trace=TraceView(_trace(("k_other", 40, 30)))),
               dict(ctx.__dict__, facts={}), dict(ctx.__dict__, config={}),
               dict(ctx.__dict__, peaks=None), dict(ctx.__dict__, trace=None)]
    for kw in nothing:
        assert reader.read(types.SimpleNamespace(**kw)) is None


# --- the kernel on the card against the plain grid. Marked ``cuda``: each
# skips without a CUDA device (decided in the fixture).


def _check_on_card(dev, tris, o, d, t_max, algo, launches=1):
    """The kernel's hits against the grid's on the card, word for word, and
    the launches it counted."""
    tris = tuple(x.to(dev) for x in tris)
    o, d = o.to(dev), d.to(dev)
    t_max = None if t_max is None else t_max.to(dev)
    before = profile.kernel_launches.copy()
    got = intersect.raycast_sweep(o, d, *tris, t_max=t_max, algo=algo)
    assert (profile.kernel_launches - before) == ({"sweep": launches} if launches else {})
    want = _grid(o, d, tris, t_max, algo)
    torch.cuda.synchronize()
    _same_words(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("ranged", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("kind", ["random", "duplicates", "degenerate"])
@pytest.mark.parametrize("count", [1, 32, 1000, 5000])
def test_kernel_matches_the_grid(cuda, count, kind, algo, ranged):
    """Random, duplicated (ties at equal t: the lowest id wins) and
    degenerate triangles, rays aimed at them, parallel to them and at
    random, with and without ``t_max``, 1 to 5,000 triangles (the kernel
    stages 512 a tile): the kernel's (t, tri, hit) equal the grid's."""
    tris = _tris(count, count, kind)
    o, d, t_max = _rays(tris, 4099, count + 1)
    want = _check_on_card(cuda, tris, o, d, t_max if ranged else None, algo)
    # a lone degenerate triangle is never hit
    assert bool(want.hit.any()) == (count > 1 or kind != "degenerate")
    if kind == "duplicates" and count >= 32:
        # some ray hit a triangle that a later id repeats
        dup = torch.zeros(count, dtype=torch.bool)
        a = tris[0]
        for k in range(2, count, 3):
            dup |= (a == a[k]).all(dim=1) & (torch.arange(count) < k)
        assert bool(dup.to(cuda)[want.tri[want.hit].long()].any())


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 5])
def test_kernel_with_nothing_to_do(cuda, count):
    """Zero rays: empty results and no launch. Zero triangles: every ray
    misses (t T_FAR, tri 0), in one launch."""
    tris = _tris(count, 9)
    o, d, t_max = _rays(tris, 0 if count else 64, 10)
    for tm in (None, t_max):
        want = _check_on_card(cuda, tris if count else _tris(0, 9), o, d, tm, "mt",
                              launches=1 if o.shape[0] else 0)
        assert o.shape[0] == 0 or not bool(want.hit.any())


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_kernel_on_the_rays_of_a_cornell_pass(cuda, algo, monkeypatch):
    """Every raycast of an eager Cornell pass on the card (DIRECT_MIS,
    persistent lanes of 2): the kernel's hits equal the grid's on the same
    rays, and the pass's radiance equals a pass whose raycasts are the
    grid's, word for word."""
    scene, cam = ttt.scenes.cornell_box(device=cuda), ttt.scenes.cornell_camera(device=cuda)
    opts = _cornell_opts(samples_per_lane=2, intersector=(
        ttt.Intersector.WATERTIGHT if algo == "watertight" else ttt.Intersector.MT))
    key = rng.key_from_seed(11)
    calls = _record_raycasts(monkeypatch)
    kernel = render_mod.render_rows(scene, cam, opts, key, 0, 2, 0, 16)
    assert len(calls) >= 9 and any(c[2] is not None for c in calls)
    tris = tuple(x.detach() for x in scene.geometry.corners())
    for o, d, t_max, _, h in calls:
        _same_words(h, _grid(o, d, tris, t_max, algo))
    monkeypatch.setattr(intersect, "raycast_sweep",
                        lambda o, d, a, b, c, t_max=None, algo="mt", slots=None:
                        _grid(o, d, (a, b, c), t_max, algo))
    grid = render_mod.render_rows(scene, cam, opts, key, 0, 2, 0, 16)
    assert torch.equal(kernel.view(torch.int32), grid.view(torch.int32))


@pytest.mark.cuda
def test_kernel_in_a_captured_graph(cuda):
    """``raycast_sweep`` captured in a CUDA graph (it reads nothing back):
    the capture's launch is taken back out of the counter, and each replay
    on new rays writes the grid's hits."""
    tris = tuple(x.to(cuda) for x in _tris(1000, 12, "duplicates"))
    slots = intersect.pack_sweep(*tris)
    o, d, t_max = (x.to(cuda) for x in _rays(_tris(1000, 12, "duplicates"), 2048, 13))
    intersect.raycast_sweep(o, d, *tris, t_max=t_max, slots=slots)  # warm-up: builds and loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = profile.kernel_launches.copy()
    with profile.launches_taken_back() as counts, torch.cuda.graph(graph):
        out = intersect.raycast_sweep(o, d, *tris, t_max=t_max, slots=slots)
    assert counts == {"sweep": 1} and profile.kernel_launches == before
    for seed in (14, 15):
        o2, d2, t2 = (x.to(cuda) for x in _rays(_tris(1000, 12, "duplicates"), 2048, seed))
        o.copy_(o2), d.copy_(d2), t_max.copy_(t2)
        graph.replay()
        _same_words(out, _grid(o, d, tris, t_max, "mt"))


@pytest.mark.cuda
def test_graphed_pass_adds_back_the_captured_launches(cuda):
    """A Cornell pass through the launch units (``render.render``, a CUDA
    graph on the card): each replayed pass adds to the counter the sweep
    launches its capture took back, as many as the eager body makes."""
    scene, cam = ttt.scenes.cornell_box(device=cuda), ttt.scenes.cornell_camera(device=cuda)
    opts = _cornell_opts()
    before = profile.kernel_launches.copy()
    render_mod.render_rows(scene, cam, opts, rng.key_from_seed(3), 0, 2, 0, 16)
    eager = (profile.kernel_launches - before)["sweep"]
    assert eager >= 9
    try:
        ttt.render(scene, cam, opts, seed=3)  # captures the units
        torch.cuda.synchronize()
        before = profile.kernel_launches.copy()
        ttt.render(scene, cam, opts, seed=4)
        torch.cuda.synchronize()
        assert (profile.kernel_launches - before)["sweep"] == eager
    finally:
        graphs.clear()
