"""The program's spans (``profile.Profiler.span`` / ``hot``) on the CPU: in
the ``torch.profiler`` trace as ``user_annotation`` events nested in the
pass, counted as the work they wrap, silent and clock-free while tracing
is off, the cold ones recorded either way, and listed by ``render
--stats``."""
import contextlib
import json
import sys

import pytest
import torch

import terra_tpu_torch as ttt
from terra_tpu_torch import _build, cli, graphs, profile
from terra_tpu_torch.scene import commit

HOT = ("terra.render.pass", "terra.render.resume_read", "terra.unit.inputs",
       "terra.unit.flag_read")


@pytest.fixture(autouse=True)
def fresh_profiler():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    profile.profiler.clear()
    yield profile.profiler
    profile.profiler.clear()
    torch.set_num_threads(prev)


def _case():
    """A small Cornell box on a BVH and persistent-lane options, so a unit's
    loop reads its flag."""
    scene = ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH)
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=4, samples_per_lane=4,
                             bounces=1, integrator=ttt.Integrator.DIRECT)
    return scene, ttt.scenes.cornell_camera(device="cpu"), opts


def test_render_spans_land_in_the_trace_nested_in_the_pass(tmp_path):
    scene, cam, opts = _case()
    film = ttt.render(scene, cam, opts, seed=1)
    with profile.device_trace(str(tmp_path)):
        ttt.render(scene, cam, opts, seed=2, film=film)
    events = [e for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("terra.")]
    by = {}
    for e in events:
        assert e["cat"] == "user_annotation", e
        by.setdefault(e["name"], []).append(e)
    assert set(HOT) <= set(by), sorted(by)
    (outer,) = by["terra.render.pass"]
    for name in HOT[1:]:
        for e in by[name]:
            assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_flag_read_spans_count_the_flag_reads(monkeypatch):
    """One ``terra.unit.flag_read`` a read of the flag: a drive that stops
    early at block n read n flags, one that ran every block one fewer."""
    scene, cam, opts = _case()
    reads = []
    real = graphs.drive

    def spy(body):
        out, trips = real(body)
        blocks = trips // body.trips_per_step if body.trips_per_step else 0
        reads.append(min(blocks, max(body.steps - 1, 0)))
        return out, trips

    monkeypatch.setattr(graphs, "drive", spy)
    with profile.tracing():
        film = ttt.render(scene, cam, opts, seed=1)
        ttt.render(scene, cam, opts, seed=2, film=film)
    assert sum(reads) > 0
    assert profile.profiler.stats("terra.unit.flag_read").n == sum(reads)
    assert profile.profiler.stats("terra.unit.inputs").n == len(reads)


def test_hot_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    scene, cam, opts = _case()
    film = ttt.render(scene, cam, opts, seed=1)  # builds the cached context (a cold span)
    profile.profiler.clear()
    reads = []
    monkeypatch.setattr(profile, "_clock", lambda: reads.append(1) or 0.0)
    ttt.render(scene, cam, opts, seed=2, film=film)
    assert reads == []
    assert not any(k.startswith("terra.") for k in profile.profiler.targets)
    off = profile.profiler.hot("terra.render.pass")
    assert off is profile.profiler.hot("terra.unit.flag_read")
    with off as entered:
        assert entered is off


@pytest.mark.parametrize("traced", [False, True])
def test_cold_spans_aggregate_either_way(traced):
    scene, cam, opts = _case()
    profile.profiler.clear()  # the case's own commit
    with profile.tracing() if traced else contextlib.nullcontext():
        again = commit(scene.geometry, scene.materials, accelerator=ttt.Accelerator.BVH)
        ttt.render(again, cam, opts, seed=1)
    p = profile.profiler
    assert p.stats("terra.scene.commit").n == 1 and p.stats("terra.scene.bvh_build").n == 1
    assert p.stats("terra.render.context").n == 1
    assert p.nested("terra.scene.commit", "terra.scene.bvh_build") == pytest.approx(
        p.stats("terra.scene.bvh_build").sum)
    assert p.stats("terra.scene.bvh_build").sum <= p.stats("terra.scene.commit").sum
    assert (p.stats("terra.render.pass").n == 1) is traced


def test_tracing_counts_one_pass_span_per_pass():
    scene, cam, opts = _case()
    film = None
    with profile.tracing() as p:
        assert p is profile.profiler
        for i in range(3):
            film = ttt.render(scene, cam, opts, seed=i, film=film)
    assert profile.profiler.stats("terra.render.pass").n == 3
    assert profile.profiler.stats("terra.render.resume_read").n == 3
    ttt.render(scene, cam, opts, seed=3, film=film)  # tracing is off again
    assert profile.profiler.stats("terra.render.pass").n == 3


def test_span_seconds_and_nesting():
    """A span keeps its seconds once closed; ``nested`` sums an inner
    target's spans that ran inside an outer one, and only those."""
    p = profile.Profiler()
    with p.span("outer") as outer:
        with p.span("inner") as a:
            pass
        with p.span("inner") as b:
            pass
    with p.span("inner") as c:
        pass
    assert outer.seconds >= a.seconds + b.seconds and c.seconds >= 0.0
    assert p.stats("inner").n == 3 and p.stats("outer").n == 1
    assert p.stats("inner").sum == pytest.approx(a.seconds + b.seconds + c.seconds)
    assert p.nested("outer", "inner") == pytest.approx(a.seconds + b.seconds)
    assert p.nested("inner", "outer") == 0.0
    p.clear()
    assert p.nested("outer", "inner") == 0.0 and p.report() == ""


def test_kernel_build_span_only_when_the_compiler_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "k.c"
    src.write_text("int x;\n")
    # a stand-in compiler: writes the file named after -o
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')"]
    first = _build.build_shared(cmd, [str(src)], "stub")
    assert profile.profiler.stats("terra.kernel.build").n == 1
    assert _build.build_shared(cmd, [str(src)], "stub") == first  # built already: no span
    assert profile.profiler.stats("terra.kernel.build").n == 1


def test_stats_lists_the_span_targets(capsys):
    assert cli.main(["render", "--cornell", "--device", "cpu", "--width", "8", "--height", "8",
                     "--spp", "2", "--bounces", "1", "--stats"]) == 0
    report = capsys.readouterr().out
    for name in ("render ", "terra.render.pass", "terra.render.resume_read",
                 "terra.unit.inputs", "terra.scene.commit", "terra.render.context"):
        assert name in report, (name, report)


# --- the training loop's spans ----------------------------------------------

TRAIN = ("terra.train.step", "terra.bvh.refit")


def _recover(steps=2):
    """``optim.recover`` on the small lit Cornell box on a BVH, positions
    trained, so every step refits the tree on the host."""
    from terra_tpu_torch import optim

    scene = ttt.scenes.cornell_box(with_blocks=False, accelerator=ttt.Accelerator.BVH,
                                   device="cpu")
    cam = ttt.scenes.cornell_camera(device="cpu")
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=1,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=8)
    target = torch.full((8, 8, 3), 0.1)
    return optim.recover(scene, cam, opts, target, fields=("attrs", "positions"), steps=steps,
                         learning_rate=0.5, seed=5)


def test_train_spans_count_the_steps_and_refits():
    with profile.tracing():
        _recover(steps=3)
    p = profile.profiler
    assert p.stats("terra.train.step").n == 3 and p.stats("terra.bvh.refit").n == 3


def test_train_spans_land_in_the_trace_and_the_refit_holds_only_its_own(tmp_path):
    """Under a ``torch.profiler`` both spans are ``user_annotation``
    events; each refit lies after its step's span, and neither it nor the
    step holds the other or any other span of the program (the step's
    replays and input write lie inside the step), so the device idle
    inside a refit is the refit's own."""
    with profile.device_trace(str(tmp_path)):
        _recover(steps=2)
    events = [e for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("terra.")]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    assert len(by["terra.train.step"]) == 2 and len(by["terra.bvh.refit"]) == 2
    for e in by["terra.train.step"] + by["terra.bvh.refit"]:
        assert e["cat"] == "user_annotation", e

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    for refit, step in zip(by["terra.bvh.refit"], by["terra.train.step"]):
        assert refit["ts"] >= step["ts"] + step["dur"]
        for e in events:
            if e is not refit:
                assert not inside(e, refit), e["name"]
                assert not inside(refit, e), e["name"]
    for e in by.get("terra.unit.inputs", []):
        assert any(inside(e, s) for s in by["terra.train.step"])
    p = profile.profiler
    for name in p.targets:
        assert p.nested("terra.bvh.refit", name) == 0.0, name
        assert p.nested(name, "terra.bvh.refit") == 0.0, name


def test_train_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    reads = []
    monkeypatch.setattr(profile, "_clock", lambda: reads.append(1) or 0.0)
    _, losses = _recover(steps=2)
    assert len(losses) == 2
    targets = profile.profiler.targets
    assert not any(name in targets for name in TRAIN)
    assert "terra.scene.commit" in targets  # a cold span, recorded
    assert len(reads) == 2 * sum(s.n for s in targets.values())  # the cold spans' reads only
    for name in TRAIN:
        assert profile.profiler.hot(name) is profile.profiler.hot("terra.render.pass")
