"""The training cell's generator (``traffic/inverse_frames.py``) and the
host refit's reader (``metrics/refit_wait_ms.train.py``) on the CPU at
small sizes: a small cell on ``inverse_frames`` found from added files, a
sound run correct and reporting ``frame_s``, each fault of a training
cell and a refit left out caught, a run that turns non-finite refused,
and the reader's number from a traced run and from a synthetic trace."""
import io
import json
import os
import types
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import SMALL, TRAIN_CELL, small_tree
from benchmark.tests.test_bench_harness import _train_fault
from benchmark.tests.test_bench_metrics import _ev, ctx_of, read
from benchmark.trace import ITEM

SEED = 2 ** 31 + 8221
CELL = "small.inverse_frames"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The small tree with the cell ``small.inverse_frames``: the small
    courtyard under the benchmark's ``inverse_frames_384_8spp`` mix, in
    ``frame_s``'s cells and the three training readers' cells."""
    root = small_tree(tmp_path_factory.mktemp("bench_inverse"))
    with open(os.path.join(root, "benchmark", "workloads", f"{CELL}.json"), "w") as f:
        json.dump(TRAIN_CELL, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": "small",
                               "traffic": "inverse_frames_384_8spp", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "courtyard.inverse" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run(root, trace=False, seconds=0.2):
    return harness.run(CELL, SEED, seconds, trace, root=root, device="cpu", overrides=SMALL,
                       log=io.StringIO())


def test_sound_run_is_correct_and_reports_frame_s(tree):
    r = run(tree)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "frame_s"}
    assert r["metrics"]["frame_s"]["unit"] == "s" and r["metrics"]["frame_s"]["value"] > 0
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap", "box_gap",
                                "nonfinite_steps"}


def test_frame_s_is_the_window_over_its_steps(tree, monkeypatch):
    """``frame_s`` is ``inverse_steps``' window in seconds a step, and the
    generator passes its counts on unchanged."""
    from benchmark.traffic import inverse_steps

    def window(ctx, st, seconds, slice_=None):
        ctx.bad_steps = 0
        return {"metrics": {"step_ms": 500.0}, "attempted": 7, "failed": 0}

    monkeypatch.setattr(inverse_steps, "window", window)
    gen = harness.load_module(os.path.join(tree, "benchmark", "traffic", "inverse_frames.py"),
                              "inverse_frames_under_test")
    ctx = type("Ctx", (), {})()
    st = {"state": types.SimpleNamespace(params={"attrs": torch.ones(2)})}
    assert gen.window(ctx, st, 1.0) == {"metrics": {"frame_s": 0.5}, "attempted": 7,
                                        "failed": 0}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_faults_are_caught(tree, kind):
    with _train_fault(kind):
        r = run(tree)
    assert r["correct"] is False, r["checks"]


def test_a_refit_left_out_is_caught(tree):
    from terra_tpu_torch.accel import lbvh

    with mock.patch.object(lbvh, "refit_", lambda bvh, geometry: bvh):
        r = run(tree)
    assert r["correct"] is False and r["checks"]["box_gap"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("what", ["loss", "params"])
def test_a_run_that_turns_non_finite_is_refused(tree, what):
    """A window step whose loss comes back non-finite, or after which a
    parameter is non-finite (the loss then stays finite: every lane
    misses), ends the run with an error after the window, before any
    result."""
    from terra_tpu_torch import optim

    real = optim.make_train_step
    calls = []

    def make(*a, **k):
        step = real(*a, **k)

        def broken(state, scene, key):
            new, loss = step(state, scene, key)
            calls.append(1)
            if len(calls) > 3:  # after set-up's checked steps
                if what == "loss":
                    loss = loss * float("nan")
                else:
                    with torch.no_grad():
                        new.params["attrs"][0, 0, 0] = float("nan")
            return new, loss

        return broken

    with mock.patch.object(optim, "make_train_step", make), \
            pytest.raises(RuntimeError, match="non-finite"):
        run(tree)


def test_traced_run_reads_the_refit_wait(tree):
    """A traced run reads ``refit_wait_ms.train`` from the refit's spans
    (the CPU has no device operations, so the kernel readers stay
    silent)."""
    r = run(tree, trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["refit_wait_ms.train"]["value"] >= 0.0
    assert r["metrics"]["refit_wait_ms.train"]["unit"] == "ms"
    assert "device_ms_per_step.train" not in r["metrics"]


def _steps(refit: bool) -> dict:
    """Two steps of 100 us: kernels 0-40 and 100-140 inside the step span,
    the host refit 50-90 and 150-190, the gaps 40-95 and 140-195 (their
    midpoints inside the refit, so 55 us a step), a kernel 95-100 and
    195-200; without ``refit`` the program has no refit span."""
    ev = [_ev(ITEM, "user_annotation", 0, 100), _ev(ITEM, "user_annotation", 100, 100),
          _ev("terra.train.step", "user_annotation", 0, 45),
          _ev("terra.train.step", "user_annotation", 100, 45),
          _ev("k", "kernel", 0, 40), _ev("k", "kernel", 100, 40),
          _ev("k", "kernel", 95, 5), _ev("k", "kernel", 195, 5)]
    if refit:
        ev += [_ev("terra.bvh.refit", "user_annotation", 50, 40),
               _ev("terra.bvh.refit", "user_annotation", 150, 40)]
    return {"traceEvents": ev}


def test_refit_wait_is_the_idle_inside_the_refit_per_step():
    assert read("refit_wait_ms.train", ctx_of(_steps(True))) == pytest.approx(55e-3)
    assert read("refit_wait_ms.train", ctx_of(_steps(False))) is None  # a program without it


def _prepared(tree):
    ctx, traffic, _ = harness.prepare(CELL, SEED, tree, "cpu", SMALL)
    st = traffic.setup(ctx)
    traffic.window(ctx, st, 0.2)
    traffic.release(ctx, st)
    return ctx, traffic


def test_the_loss_is_compared_on_the_first_step_alone(tree):
    """``loss_gap`` reads the first step's loss: later losses that part
    from the reference's move it not, a first loss 1% off does."""
    ctx, traffic = _prepared(tree)
    ref = traffic.reference_run(ctx)
    sound = traffic.numbers(ctx, ctx.snap, ref)
    later = [x * (1.0 if i == 0 else 3.0) for i, x in enumerate(ctx.snap["losses"])]
    assert traffic.numbers(ctx, dict(ctx.snap, losses=later), ref) == sound
    first = [x * (1.01 if i == 0 else 1.0) for i, x in enumerate(ctx.snap["losses"])]
    assert traffic.numbers(ctx, dict(ctx.snap, losses=first), ref)["loss_gap"] > 0.009


def test_control_and_faults_are_caught(tree):
    """The reference in TF32 in the program's place, and each planted
    fault, read above a limit of the small cells."""
    ctx, traffic = _prepared(tree)
    ref = traffic.reference_run(ctx)
    lim = TRAIN_CELL["limits"]
    nums = traffic.numbers(ctx, traffic.control_snapshot(ctx, traffic.reference_run(
        ctx, tf32=True)), ref)
    assert any(nums[k] > lim[k] for k in nums), nums
    faults = traffic.fault_readings(ctx, ref)
    assert set(faults) == {"unchanged", "half", "altered"}
    for fault, nums in faults.items():
        assert any(nums[k] > lim[k] for k in nums), (fault, nums)
    assert faults["altered"]["loss_gap"] == pytest.approx(0.01, rel=1e-6)


def test_the_cell_runs_its_own_configuration_on_the_courtyard_scene():
    """``courtyard.inverse`` runs configuration ``courtyard_inverse``, a
    deployment of its own (its own file and source), on configuration
    ``courtyard``'s scene unchanged: every key the harness and the
    generators read is the same, so the cell's scene is the render cells'."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    configs = {c["name"]: c for c in bench["configs"]}
    cell = {w["name"]: w for w in bench["workloads"]}["courtyard.inverse"]
    assert cell["config"] == "courtyard_inverse"
    entry, base = configs["courtyard_inverse"], configs["courtyard"]
    assert entry["file"] == "benchmark/configs/courtyard_inverse.json" != base["file"]
    assert entry["source"] != base["source"] and entry["reduced"] == []
    mine = harness.read_json(os.path.join(harness.ROOT, entry["file"]))
    theirs = harness.read_json(os.path.join(harness.ROOT, base["file"]))
    assert mine["name"] == "courtyard_inverse" and mine["source"] == entry["source"]
    for key in ("generator", "params", "triangles", "accelerator", "leaf_size", "camera"):
        assert mine[key] == theirs[key], key
