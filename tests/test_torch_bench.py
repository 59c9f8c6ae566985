"""The port's bench (``terra_tpu_torch/bench.py``) held to the root
``bench.py`` on the CPU.

Configs 1 and 2 are built by each bench with its ``_timed_render``
patched to keep what reaches it: the scene builder's arguments, the
options and the shadow rays a bounce must be equal, and the port's
measured live fractions must match ``bench.measure_avg_active``'s within
2e-3 (~65 of the probe's 32,768 lanes: coplanar-edge and bucket-edge
ties). The ray count, the camera, 3i and 3s batches are held to
``bench.py``'s own statements, taken from its syntax tree and run on the
same inputs: the ray count and the 3i batch equal, the camera rays and
the 3s batch within 1e-6 of the largest coordinate. The other configs'
options are written here as ``bench.py`` writes them. The metric names
and units are those of ``bench.py``'s ``_emit`` calls; both kernel gates
raise on one flipped hit or a moved t; ``python -m terra_tpu_torch.bench``
without a card exits non-zero naming the missing device.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terra_tpu as tt
import terra_tpu_torch as ttt
from terra_tpu import camera as j_camera, intersect as j_intersect
from terra_tpu.ops import math3 as j_math3, rng as jrng
from terra_tpu.surface import build_shade_tables as j_build_shade_tables
from terra_tpu.surface import surface_init as j_surface_init
from terra_tpu_torch import bench as port
from terra_tpu_torch import intersect, profile
from terra_tpu_torch.accel import pallas_traverse as tpt
from terra_tpu_torch.ops import rng

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_PATH = ROOT / "bench.py"
_spec = importlib.util.spec_from_file_location("bench", REF_PATH)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SMALL_COURTYARD = dict(grid=40, columns=8)
FRACTION_TOL = 2e-3
BATCH_TOL = 1e-6  # of the largest coordinate


@pytest.fixture(autouse=True)
def torch_one_thread():
    """One torch thread (see tests/test_torch_bsdf.py: MKL's threaded sqrt
    after JAX has run was sometimes inexact on the test host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _function(path, name):
    tree = ast.parse(pathlib.Path(path).read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _targets(st) -> set:
    names = set()
    for t in st.targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                names.add(n.id)
    return names


def _run_statements(fn_name: str, names: set, namespace: dict) -> dict:
    """Run, in order, the assignments of ``bench.py``'s ``fn_name`` whose
    targets all lie in ``names``, in ``namespace``; returns it."""
    body = [st for st in _function(REF_PATH, fn_name).body
            if isinstance(st, ast.Assign) and _targets(st) <= names]
    assert {n for st in body for n in _targets(st)} == names, "bench.py changed"
    exec(compile(ast.Module(body=body, type_ignores=[]), str(REF_PATH), "exec"), namespace)
    return namespace


def _plain(v):
    return int(v) if hasattr(v, "__index__") and not isinstance(v, bool) else v


def _fields(opts) -> dict:
    return {f.name: _plain(getattr(opts, f.name)) for f in dataclasses.fields(opts)}


def _jkey():
    return jnp.array(jrng.key_from_seed(0), jnp.uint32)


@pytest.fixture(scope="module")
def cornell_configs():
    """Configs 1 and 2 as each bench builds them: {config: {side: what
    reached ``_timed_render`` and the scene builder's arguments}}."""
    out = {}
    for name in ("bench_cornell", "bench_ggx_mis"):
        got = {}
        for side, mod, pkg, where, key in (("ref", ref, tt, tt, _jkey()),
                                           ("port", port, ttt, "cpu", rng.key_from_seed(0))):
            builder = pkg.scenes.cornell_box
            calls = []

            def record(*a, builder=builder, calls=calls, **kw):
                calls.append(kw)
                return builder(*a, **kw)

            def timed(scene, cam, opts, key, shadow_rays_per_bounce, side=side, calls=calls):
                got[side] = dict(scene=scene, cam=cam, opts=opts, key=key,
                                 shadow=shadow_rays_per_bounce, builder=dict(calls[-1]))
                return (1.0, 1.0) if side == "ref" else (1.0, 1.0, {})

            with mock.patch.object(pkg.scenes, "cornell_box", record), \
                    mock.patch.object(mod, "_timed_render", timed), \
                    mock.patch.object(mod, "_emit"):
                getattr(mod, name)(where, key)
        out[name] = got
    return out


@pytest.mark.parametrize("config", ["bench_cornell", "bench_ggx_mis"])
def test_cornell_configs_match_bench(cornell_configs, config):
    got = cornell_configs[config]
    r, p = got["ref"], got["port"]
    assert p["builder"].pop("device") == "cpu"
    assert {k: _plain(v) for k, v in p["builder"].items()} == \
        {k: _plain(v) for k, v in r["builder"].items()}
    assert _fields(p["opts"]) == _fields(r["opts"])
    assert p["shadow"] == r["shadow"]


@pytest.mark.parametrize("config", ["bench_cornell", "bench_ggx_mis"])
def test_measure_avg_active_matches_bench(cornell_configs, config):
    r, p = cornell_configs[config]["ref"], cornell_configs[config]["port"]
    want = ref.measure_avg_active(r["scene"], r["cam"], r["opts"], r["key"])
    have = port.measure_avg_active(p["scene"], p["cam"], p["opts"], p["key"], "cpu")
    assert len(have) == len(want) == r["opts"].bounces + 1
    assert have[0] > 0.5  # the probe really sees the box
    np.testing.assert_allclose(have, want, rtol=0, atol=FRACTION_TOL)


def test_other_configs_options_are_bench_pys():
    """Config 3b (bench.py:384-391), 3m's scene (:406) and config 4
    (:499-502), written as bench.py writes them; the shadow rays a bounce
    of every ``_timed_render`` call equal to bench.py's, call by call."""
    opts_3b = tt.RenderOptions(width=384, height=384, samples_per_pixel=8, bounces=2,
                               integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5,
                               samples_per_lane=8)
    opts_4 = tt.RenderOptions(width=32, height=32, samples_per_pixel=8, bounces=2,
                              integrator=tt.Integrator.DIRECT, rr_start_bounce=8)
    assert _fields(port.COURTYARD_RENDER) == _fields(opts_3b)
    assert _fields(port.INVERSE) == _fields(opts_4)
    assert port.MEGA_SCENE == {"grid": 690, "columns": 40}

    def shadows(path):
        out = {}
        for node in ast.walk(ast.parse(pathlib.Path(path).read_text())):
            if isinstance(node, ast.FunctionDef):
                out[node.name] = [kw.value.value for c in ast.walk(node)
                                  if isinstance(c, ast.Call)
                                  and getattr(c.func, "id", None) == "_timed_render"
                                  for kw in c.keywords if kw.arg == "shadow_rays_per_bounce"]
        return {k: v for k, v in out.items() if v}

    assert shadows(port.__file__) == shadows(REF_PATH) == {
        "bench_cornell": [0], "bench_ggx_mis": [2], "bench_courtyard": [1]}


@pytest.mark.parametrize("fractions,shadow", [
    ([1.0, 0.9, 0.5, 0.25, 0.1], 0), ([0.97, 0.61, 0.33], 1),
    ([0.999, 0.7, 0.45, 0.2, 0.05], 2), ([0.5], 2)])
def test_ray_count_is_bench_pys_arithmetic(fractions, shadow):
    opts = tt.RenderOptions(width=48, height=40, samples_per_pixel=12, bounces=len(fractions) - 1)
    ns = _run_statements("_timed_render", {"lanes", "path_rays", "shadow_rays", "total_rays"},
                         dict(opts=opts, fractions=fractions, shadow_rays_per_bounce=shadow))
    popts = ttt.RenderOptions(width=48, height=40, samples_per_pixel=12,
                              bounces=len(fractions) - 1)
    assert port.ray_count(popts, fractions, shadow) == ns["total_rays"]


@pytest.mark.parametrize("i", [1, 2, 3, 5, 0xFFFFFFFF])
def test_fold_in_is_jax_random_fold_in(i):
    want = np.asarray(jax.random.fold_in(_jkey(), i)).astype(np.int64)
    assert port.fold_in(rng.key_from_seed(0), i) == tuple(int(w) for w in want)


@pytest.fixture(scope="module")
def small_courtyard():
    """The small courtyard in both packages, its camera, and 64^2 camera
    rays of bench.py's expressions (JAX) and of the port."""
    pscene = ttt.scenes.courtyard(**SMALL_COURTYARD, device="cpu")
    pcam = ttt.scenes.courtyard_camera(device="cpu")
    jscene, jcam = tt.scenes.courtyard(**SMALL_COURTYARD), tt.scenes.courtyard_camera()
    n = 64 * 64
    ns = _run_statements("bench_courtyard", {"side", "px", "py", "zeros", "o", "d"},
                         dict(np=np, jnp=jnp, camera_mod=j_camera, cam=jcam, n=n))
    o, d = port.camera_rays(pcam, n, "cpu")
    return dict(pscene=pscene, jscene=jscene, o=o, d=d, n=n,
                jo=np.asarray(ns["o"]), jd=np.asarray(ns["d"]))


def _close(have, want, tol=BATCH_TOL):
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape and have.dtype == want.dtype
    assert np.abs(have - want).max() <= tol * max(np.abs(want).max(), 1.0)


def test_camera_rays_match_bench(small_courtyard):
    c = small_courtyard
    _close(c["o"].numpy(), np.broadcast_to(c["jo"], c["o"].shape))
    _close(c["d"].numpy(), c["jd"])


def test_incoherent_batch_is_bench_pys(small_courtyard):
    c = small_courtyard
    bvh = c["pscene"].bvh
    box = types.SimpleNamespace(bvh=types.SimpleNamespace(node_min=jnp.asarray(bvh.node_min),
                                                          node_max=jnp.asarray(bvh.node_max)))
    ns = _run_statements("bench_courtyard", {"rng", "lo", "hi", "o_i", "v", "d_i"},
                         dict(np=np, jnp=jnp, scene=box, n=c["n"]))
    o_i, d_i = port.incoherent_rays(bvh, c["n"], "cpu")
    for have, want in ((o_i, ns["o_i"]), (d_i, ns["d_i"])):
        want = np.asarray(want)
        assert have.dtype == torch.float32 and have.shape == want.shape
        assert np.array_equal(have.numpy().view(np.int32), want.view(np.int32))


def test_bounce_batch_matches_bench(small_courtyard):
    """3s: both from the same camera rays and parent hits (the port's
    walk on the CPU): bench.py's statements on the JAX scene, run op by op
    (``jax.disable_jit``, as tests/test_torch_packet.py runs the packet
    walk), against ``bounce_rays`` on the port's."""
    c = small_courtyard
    hit0 = tpt.raycast(c["pscene"], c["o"], c["d"])
    assert float(hit0.hit.float().mean()) > 0.5
    with jax.disable_jit():  # compiled, XLA contracts surface_init into FMAs
        ns = _run_statements(
            "bench_courtyard",
            {"tables", "surf", "rb", "e1", "e2", "st", "phi", "nrm", "t_ax", "b_ax", "d_s",
             "o_s"},
            dict(np=np, jnp=jnp, jax=jax, scene=c["jscene"], o=jnp.asarray(c["o"].numpy()),
                 d=jnp.asarray(c["d"].numpy()), n=c["n"],
                 hit0=types.SimpleNamespace(tri=jnp.asarray(hit0.tri.numpy())),
                 build_shade_tables=j_build_shade_tables, surface_init=j_surface_init,
                 intersect_mod=j_intersect, math3=j_math3))
    o_s, d_s = port.bounce_rays(c["pscene"], c["o"], c["d"], hit0.tri)
    _close(o_s.numpy(), ns["o_s"])
    _close(d_s.numpy(), ns["d_s"])


def _emits(path) -> dict:
    """{metric: (unit, explicit keyword names)} of the ``_emit`` calls
    with a literal metric name."""
    out = {}
    for node in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_emit" \
                and isinstance(node.args[0], ast.Constant):
            out[node.args[0].value] = (node.args[2].value,
                                       {kw.arg for kw in node.keywords if kw.arg})
    return out


def test_metrics_and_units_are_bench_pys():
    want, have = _emits(REF_PATH), _emits(port.__file__)
    assert len(want) == 8
    assert {m: u for m, (u, _) in have.items()} == {m: u for m, (u, _) in want.items()}
    for metric, (_, keys) in want.items():
        assert keys <= have[metric][1], metric  # bench.py's extra keys, each kept
    # the counted launch's keys, and no TPU-priced ceiling
    mega = _function(port.__file__, "bench_mega")
    kw = {k.arg for c in ast.walk(mega) if isinstance(c, ast.Call)
          and getattr(c.func, "id", None) == "_emit" for k in c.keywords}
    assert {"iters", "pops", "leaf_visits"} <= kw and "pct_pop_free_ceiling" not in kw
    source = pathlib.Path(port.__file__).read_text()
    assert "BASE_" not in source and "B_CHUNK_NS" not in source


def test_emit_line(capsys):
    profile.kernel_launches.update(binary=2, bvh4=5)
    with mock.patch.object(port, "_device_keys", lambda: {"card": "X, 1 W",
                                                          "device_count": 1}):
        port._emit("courtyard_bvh_mrays", 12.34567, "Mrays/s", tris=7)
    line = json.loads(capsys.readouterr().out)
    assert line == {"metric": "courtyard_bvh_mrays", "value": 12.346, "unit": "Mrays/s",
                    "vs_baseline": None, "card": "X, 1 W", "device_count": 1,
                    "launches": {"bvh_traverse": 2, "bvh4_traverse": 5}, "tris": 7}
    assert profile.kernel_launches == {}


def _flip(real, what):
    def patched(*a, **kw):
        h = real(*a, **kw)
        hit, t = h.hit.clone(), h.t.clone()
        i = int(torch.nonzero(hit)[3])
        if what == "hit":
            hit[i] = ~hit[i]
        else:
            t[i] = t[i] * 1.01 + 1e-2
        return intersect.RayHit(t=t, tri=h.tri, hit=hit)

    return patched


@pytest.mark.parametrize("gate", ["_verify_compiled_kernel", "_verify_wide_kernel"])
def test_gates_raise_on_one_flipped_hit(small_courtyard, gate):
    c = small_courtyard
    check = getattr(port, gate)
    check(c["pscene"], c["o"], c["d"], 256)  # the walk agrees
    with mock.patch.object(tpt, "raycast", _flip(tpt.raycast, "hit")):
        with pytest.raises(AssertionError, match="hit mask mismatch on 1/256"):
            check(c["pscene"], c["o"], c["d"], 256)
    with mock.patch.object(tpt, "raycast", _flip(tpt.raycast, "t")):
        with pytest.raises(AssertionError, match="t mismatch"):
            check(c["pscene"], c["o"], c["d"], 256)


@pytest.mark.parametrize("gate", ["_verify_compiled_kernel", "_verify_wide_kernel"])
def test_gates_leave_the_launch_counts(small_courtyard, gate):
    """A gate's kernel launches are not its config's: the counts that the
    config's line reports are the same after the gate as before it."""
    c = small_courtyard
    real, calls = tpt.raycast, []

    def counted(*a, **kw):  # the wrapper's count, as on a CUDA scene
        calls.append(1)
        profile.kernel_launches["bvh4"] += 1
        return real(*a, **kw)

    profile.kernel_launches.update(binary=3, bvh4=4)
    try:
        with mock.patch.object(tpt, "raycast", counted):
            getattr(port, gate)(c["pscene"], c["o"], c["d"], 256)
        assert calls and profile.kernel_launches == {"binary": 3, "bvh4": 4}
    finally:
        profile.kernel_launches.clear()


def test_main_without_a_card_exits_naming_it():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "terra_tpu_torch.bench"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
