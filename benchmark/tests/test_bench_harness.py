"""The harness end to end on the CPU at small sizes: cells found by name
from added files alone, sound runs correct, each fault the cells can have
planted under the timed path and caught, the control caught, and the
command's refusals (no card, no program, a forbidden import)."""
import io
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import ROOT, SMALL, small_tree

SEED = 2 ** 31 + 4099


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run(root, cell, seconds=0.2, trace=False, seed=SEED, **over):
    return harness.run(cell, seed, seconds, trace, root=root, device="cpu",
                       overrides=dict(SMALL, **over), log=io.StringIO())


def test_added_files_are_found(tree, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file of its own, are found by the names in BENCHMARK.json."""
    root = str(tmp_path / "more")
    shutil.copytree(tree, root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "tiny_passes.json"), "w") as f:
        json.dump({"generator": "render_passes",
                   "params": dict(json.load(open(os.path.join(
                       b, "traffic", "preview_384_8spp.json")))["params"], width=6, height=4)}, f)
    with open(os.path.join(b, "workloads", "small.tiny.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(b, "workloads", "small.render.json"))),
                       trace_first=1, trace_items=2), f)
    with open(os.path.join(b, "metrics", "items_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.trace.items) if ctx.trace else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "small.tiny", "config": "small",
                               "traffic": "tiny_passes", "chips": 1, "why": "test"})
    bench["end_to_end"][1]["workloads"].append("small.tiny")
    bench["per_layer"].append({"name": "items_traced", "unit": "passes", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "frame_s", "workloads": ["small.tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = harness.run("small.tiny", SEED, 0.2, True, root=root, device="cpu", log=io.StringIO())
    assert r["correct"] is True
    assert r["metrics"]["items_traced"]["value"] == 2.0
    assert "device_idle_pct.render" not in r["metrics"]  # no device work on the CPU
    r = harness.run("small.tiny", SEED, 0.2, False, root=root, device="cpu", log=io.StringIO())
    assert set(r["metrics"]) == {"setup_s", "frame_s"}


@pytest.mark.parametrize("cell", ["small.render", "cornell.render", "small.inverse",
                                  "small.inverse_pos"])
def test_sound_run_is_correct(tree, cell):
    r = run(tree, cell)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["metrics"]["setup_s"]["value"] > 0
    for m in r["metrics"].values():
        assert m["value"] > 0


def _render_fault(kind):
    """``render.render`` broken under the window: the film returned as it
    came (a state unchanged); half of each pass's samples left out, the
    mean taken over the rest; the pass's radiance altered where it is made."""
    import importlib

    film_mod = importlib.import_module("terra_tpu_torch.film")
    render_mod = importlib.import_module("terra_tpu_torch.render")

    real = render_mod.render

    def broken(scene, cam, opts, seed=0, film=None):
        if kind == "unchanged" and film is not None:
            return film
        if kind == "half":
            return real(scene, cam, opts.replace(samples_per_pixel=opts.samples_per_pixel // 2,
                                                 samples_per_lane=1), seed=seed, film=film)
        out = real(scene, cam, opts, seed=seed, film=film)
        if kind == "altered":
            before = film.acc if film is not None else 0.0
            out = film_mod.Film(acc=before + (out.acc - before) * 1.01, samples=out.samples)
        return out

    return mock.patch.object(render_mod, "render", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["small.render", "cornell.render"])
def test_render_faults_are_caught(tree, cell, kind):
    with _render_fault(kind):
        r = run(tree, cell)
    assert r["correct"] is False, r["checks"]


def _train_fault(kind):
    """The training step broken under the window: the parameters left as
    they were (a state unchanged); half of the rows left out, the mean
    taken over the rest; the loss altered where it is made."""
    from terra_tpu_torch import optim

    real = optim.make_train_step

    def make(cam, opts, target, optimizer, spp=None):
        if kind == "half":
            half = opts.height // 2
            return real(cam, opts.replace(height=half), target[:half], optimizer, spp)
        step = real(cam, opts, target, optimizer, spp)

        def broken(state, scene, key):
            before = {k: v.detach().clone() for k, v in state.params.items()}
            new, loss = step(state, scene, key)
            if kind == "unchanged":
                with torch.no_grad():
                    for k, v in new.params.items():
                        v.copy_(before[k])
            return new, (loss * 1.01 if kind == "altered" else loss)

        return broken

    return mock.patch.object(optim, "make_train_step", make)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_faults_are_caught(tree, kind):
    with _train_fault(kind):
        r = run(tree, "small.inverse")
    assert r["correct"] is False, r["checks"]


def test_a_refit_left_out_is_caught(tree):
    """With positions trained, boxes that are not refit fail the exact box
    check."""
    from terra_tpu_torch.accel import lbvh

    with mock.patch.object(lbvh, "refit_", lambda bvh, geometry: bvh):
        r = run(tree, "small.inverse_pos")
    assert r["correct"] is False and r["checks"]["box_gap"]["value"] > 0, r["checks"]


def test_controls_are_caught(tree):
    """The reference in TF32 put in the program's place fails a number of
    each cell."""
    for cell in ("small.render", "cornell.render"):
        ctx, traffic, _ = harness.prepare(cell, SEED, tree, "cpu", SMALL)
        _run_window(ctx, traffic)
        ref = traffic.reference_values(ctx)
        nums = traffic.compare(traffic.reference_values(ctx, tf32=True), ref,
                               ctx.cell["limits"]["tolerance"])
        assert any(nums[k] > ctx.cell["limits"][k] for k in nums), (cell, nums)
    ctx, traffic, _ = harness.prepare("small.inverse", SEED, tree, "cpu", SMALL)
    _run_window(ctx, traffic)
    ref = traffic.reference_run(ctx)
    nums = traffic.numbers(ctx, traffic.control_snapshot(ctx, traffic.reference_run(
        ctx, tf32=True)), ref)
    assert any(nums[k] > ctx.cell["limits"][k] for k in nums), nums
    for fault, nums in traffic.fault_readings(ctx, ref).items():
        assert any(nums[k] > ctx.cell["limits"][k] for k in nums), (fault, nums)


def _run_window(ctx, traffic):
    st = traffic.setup(ctx)
    traffic.window(ctx, st, 0.2)
    traffic.release(ctx, st)


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "courtyard.render", "--seed", str(SEED), "--seconds", "1", "--trace",
                           "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_command_refuses_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_by_whole_top_level_name():
    ok = ["terra_tpu_torch", "terra_tpu_torch.render", "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ["terra_tpu.scene", "jax.numpy", "flax", "jaxlib"]) \
        == ["flax", "jax", "jaxlib", "terra_tpu"]


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package(tree):
    """A run in a fresh process leaves neither JAX nor the JAX package in
    ``sys.modules`` (whole top-level names)."""
    code = ("import io, json, sys, torch; torch.set_num_threads(2);"
            "from benchmark import harness;"
            f"harness.run('cornell.render', {SEED}, 0.1, False, root={tree!r}, device='cpu',"
            f" overrides={SMALL!r}, log=io.StringIO());"
            "print(json.dumps(harness.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
