"""The per-layer readers' arithmetic on a small synthetic profiler trace."""
import os
import types

import pytest

from benchmark import harness, peaks, roofline
from benchmark.trace import ITEM, TraceView

METRICS = os.path.join(harness.BENCH_DIR, "metrics")
BVH4_CH = "void bvh4_traverse_kernel<0, false, false, 0, false, false>(Args)"
BVH4_SH = "void bvh4_traverse_kernel<0, true, true, 0, false, false>(Args)"


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic() -> dict:
    """Two passes of 100 us each (ts 0-100 and 100-200): kernels busy 0-30,
    50-60 (a BVH4 closest-hit launch), 55-70 (overlapping), 120-150 (a
    shadow launch) and a copy 180-190; a kernel outside the passes."""
    return {"traceEvents": [
        _ev(ITEM, "user_annotation", 0, 100), _ev(ITEM, "user_annotation", 100, 100),
        _ev("render", "cpu_op", 0, 95), _ev("cudaGraphLaunch", "cuda_runtime", 28, 20),
        _ev("develop", "cpu_op", 72, 40), _ev("sync", "cuda_runtime", 150, 30),
        _ev("k_a", "kernel", 0, 30), _ev(BVH4_CH, "kernel", 50, 10), _ev("k_b", "kernel", 55, 15),
        _ev(BVH4_SH, "kernel", 120, 30), _ev("Memcpy DtoH", "gpu_memcpy", 180, 10),
        _ev("k_late", "kernel", 500, 10),
        {"ph": "f", "name": "ac2g", "ts": 3}]}


def ctx_of(trace, **facts):
    return types.SimpleNamespace(trace=TraceView(trace), facts=facts,
                                 peaks=peaks.for_device("NVIDIA H100 80GB HBM3"))


def read(metric, ctx):
    return harness.load_module(os.path.join(METRICS, f"{metric}.py"), "m_" + metric.replace(
        ".", "_")).read(ctx)


def test_window_busy_and_idle_share():
    ctx = ctx_of(synthetic())
    t = ctx.trace
    assert t.items == 2
    assert t.window_s == pytest.approx(200e-6)
    # union: [0,30] [50,70] [120,150] [180,190] = 30 + 20 + 30 + 10 us
    assert t.busy_s == pytest.approx(90e-6)
    for m in ("device_idle_pct.render", "device_idle_pct.train"):
        assert read(m, ctx) == pytest.approx(100.0 * 110 / 200)


def test_kernel_counts_and_time_per_item():
    ctx = ctx_of(synthetic())
    assert read("kernels_per_frame", ctx) == pytest.approx(4 / 2)  # the copy is no kernel
    assert read("device_ms_per_step.train", ctx) == pytest.approx((30 + 10 + 15 + 30) * 1e-3 / 2)


def test_breakdown_device_ops_and_idle_gaps():
    t = ctx_of(synthetic()).trace
    ops = dict(t.device_ops())
    assert ops[BVH4_SH] == pytest.approx(30e-6) and ops["k_a"] == pytest.approx(30e-6)
    gaps = dict(t.idle_gaps())
    # 30-50 (mid 40): innermost host event is cudaGraphLaunch (28-48);
    # 70-120 (mid 95): develop (72-112); 150-180 (mid 165): sync; 190-200: none
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["develop"] == pytest.approx(50e-6)
    assert gaps["sync"] == pytest.approx(30e-6)
    assert gaps["host: outside any recorded event"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_bvh4_roofline_bytes_and_share():
    assert roofline.bvh4_instance(BVH4_SH) == (True, True, False)
    assert roofline.bvh4_instance("void other_kernel<0, true, true, 0>()") is None
    w = roofline.bvh4_launch(1000, True, num_wide=10, leaf_rows=64, bf16=False)
    assert w["bytes"] == 10 * (96 + 16) + 64 * 40 + 1000 * 28 + 1000 * 8
    assert w["flops"] == 1000 * 48
    ctx = ctx_of(synthetic(), rays_per_launch=1000, num_wide=10, leaf_rows=64)
    least = sum(roofline.least_seconds(roofline.bvh4_launch(1000, tm, 10, 64, False),
                                       ctx.peaks) for tm in (False, True))
    assert read("bvh4_roofline", ctx) == pytest.approx(100.0 * least / 40e-6)


def test_readers_report_nothing_without_data():
    empty = ctx_of({"traceEvents": []})
    for m in ("device_idle_pct.render", "kernels_per_frame", "device_ms_per_step.train"):
        assert read(m, empty) is None
    assert read("bvh4_roofline", ctx_of(synthetic())) is None  # no table facts
    no_bvh4 = synthetic()
    no_bvh4["traceEvents"] = [e for e in no_bvh4["traceEvents"] if "bvh4" not in e["name"]]
    assert read("bvh4_roofline", ctx_of(no_bvh4, rays_per_launch=1, num_wide=1,
                                            leaf_rows=8)) is None
