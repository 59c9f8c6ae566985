"""The readers of the program's spans: device idle by the innermost
``terra.*`` span on a small synthetic profiler trace, and the set-up's
span sums from the program's registry."""
import os

import pytest

from benchmark import harness, spans
from benchmark.tests.test_bench_metrics import _ev, ctx_of
from benchmark.trace import ITEM

METRICS = os.path.join(harness.BENCH_DIR, "metrics")
IDLE = ("flag_wait_ms.render", "launch_wait_ms.render", "host_read_wait_ms.render")


def read(metric, ctx):
    return harness.load_module(os.path.join(METRICS, f"{metric}.py"), "m_" + metric.replace(
        ".", "_")).read(ctx)


def traced() -> dict:
    """Two passes of 100 us (0-100, 100-200), each a ``terra.render.pass``
    span. Pass 1: kernels 0-10, 30-40, 60-100; its gaps 10-30 inside a
    step replay (a ``cudaGraphLaunch`` inside it), 40-60 inside the flag
    read. Pass 2: kernels 100-110, 130-190; its gap 110-130 inside the
    resume read nested in an input write (the innermost counts), 190-200
    inside the pass alone. A gap 200-210 after the passes, outside every
    span, lies outside the traced window."""
    return {"traceEvents": [
        _ev(ITEM, "user_annotation", 0, 100), _ev(ITEM, "user_annotation", 100, 100),
        _ev("terra.render.pass", "user_annotation", 0, 99),
        _ev("terra.render.pass", "user_annotation", 100, 99),
        _ev("terra.unit.replay.step", "user_annotation", 8, 24),
        _ev("cudaGraphLaunch", "cuda_runtime", 9, 22),
        _ev("terra.unit.flag_read", "user_annotation", 38, 24),
        _ev("cudaStreamSynchronize", "cuda_runtime", 39, 22),
        _ev("terra.unit.inputs", "user_annotation", 105, 30),
        _ev("terra.render.resume_read", "user_annotation", 108, 24),
        _ev("k", "kernel", 0, 10), _ev("k", "kernel", 30, 10), _ev("k", "kernel", 60, 40),
        _ev("k", "kernel", 100, 10), _ev("k", "kernel", 130, 60),
        _ev("k", "kernel", 210, 5)]}


def test_a_gap_goes_to_the_innermost_terra_span():
    ctx = ctx_of(traced())
    by = spans.idle_by_span(ctx.trace)
    assert by["terra.unit.replay.step"] == pytest.approx(20e-6)
    assert by["terra.unit.flag_read"] == pytest.approx(20e-6)
    assert by["terra.render.resume_read"] == pytest.approx(20e-6)
    assert by["terra.unit.inputs"] == 0.0  # named, though the gap went to the inner span
    assert by["terra.render.pass"] == pytest.approx(10e-6)
    # per traced pass, in ms
    assert read("launch_wait_ms.render", ctx) == pytest.approx(20e-3 / 2)
    assert read("flag_wait_ms.render", ctx) == pytest.approx(20e-3 / 2)
    assert read("host_read_wait_ms.render", ctx) == pytest.approx(20e-3 / 2)
    idle = ctx.trace.window_s - ctx.trace.busy_s
    assert sum(read(m, ctx) for m in IDLE) * 1e-3 * ctx.trace.items <= idle + 1e-12


def test_a_gap_outside_every_span_counts_for_none():
    t = traced()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["name"] != "terra.render.pass"]
    ctx = ctx_of(t)
    by = spans.idle_by_span(ctx.trace)
    assert "terra.render.pass" not in by
    assert sum(by.values()) == pytest.approx(60e-6)  # the 10 us at 190-200 goes nowhere
    assert ctx.trace.window_s - ctx.trace.busy_s == pytest.approx(70e-6)


def test_spans_present_without_idle_read_zero():
    t = traced()
    t["traceEvents"].append(_ev("k", "kernel", 40, 20))  # the flag read's gap filled
    assert read("flag_wait_ms.render", ctx_of(t)) == 0.0


def test_a_trace_without_spans_gives_none():
    t = traced()
    t["traceEvents"] = [e for e in t["traceEvents"] if not e["name"].startswith("terra.")]
    for m in IDLE:
        assert read(m, ctx_of(t)) is None
        assert read(m, ctx_of({"traceEvents": []})) is None
    no_flag = traced()
    no_flag["traceEvents"] = [e for e in no_flag["traceEvents"]
                              if e["name"] != "terra.unit.flag_read"]
    assert read("flag_wait_ms.render", ctx_of(no_flag)) is None
    assert read("launch_wait_ms.render", ctx_of(no_flag)) is not None


def test_setup_readers_take_the_program_sums(monkeypatch):
    """``setup_capture_s`` and ``setup_bvh_s``: the process's span sums,
    less the kernel builds run inside them; None where the program
    recorded none."""
    from terra_tpu_torch import profile

    p = profile.Profiler()
    monkeypatch.setattr(profile, "profiler", p)
    for m in ("setup_bvh_s", "setup_capture_s"):
        assert read(m, None) is None
    with p.span("terra.unit.capture") as cap:
        with p.span("terra.kernel.build") as build:
            pass
    with p.span("terra.kernel.build"):  # outside any capture: not taken off
        pass
    with p.span("terra.scene.bvh_build") as bvh:
        pass
    assert read("setup_capture_s", None) == pytest.approx(cap.seconds - build.seconds)
    assert read("setup_bvh_s", None) == pytest.approx(bvh.seconds)


def test_setup_readers_give_none_on_a_program_without_spans(monkeypatch):
    """A program whose registry has no span API (an older one) gives None."""
    from terra_tpu_torch import profile

    class Old:
        targets = {}

    monkeypatch.setattr(profile, "profiler", Old())
    for m in ("setup_bvh_s", "setup_capture_s"):
        assert read(m, None) is None
