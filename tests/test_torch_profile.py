"""Port profile.py vs terra_tpu.profile: the same samples give the same
statistics, report and nominal ray counts, exactly; the stage breakdown and
the device trace run on the CPU."""
import dataclasses
import enum

import numpy as np
import pytest
import torch

import terra_tpu as tt
from terra_tpu import profile as jprof
import terra_tpu_torch as ttt
from terra_tpu_torch import profile as tprof


def _samples():
    return [float(x) for x in np.random.default_rng(4).lognormal(-3, 1, 50)]


def test_stats_and_report_match_reference():
    jp, tp = jprof.Profiler(), tprof.Profiler()
    for p in (jp, tp):
        for x in _samples():
            p.add_sample("render", x)
            p.add_sample("render_mrays", 1.0 / x)
        p.stats("empty")
    for name in ("render", "render_mrays"):
        assert tp.stats(name).as_dict() == jp.stats(name).as_dict()
    assert tp.report() == jp.report()
    tp.clear()
    assert tp.report() == ""


@pytest.mark.parametrize("avg", [None, 2.5])
@pytest.mark.parametrize("integrator", [tt.Integrator.SIMPLE, tt.Integrator.DIRECT,
                                        tt.Integrator.DIRECT_MIS,
                                        tt.Integrator.DEBUG_MIS_WEIGHTS])
def test_ray_count_matches_reference(integrator, avg):
    kw = dict(width=37, height=21, samples_per_pixel=6, bounces=3, integrator=integrator)
    plain = {k: int(v) if isinstance(v, enum.Enum) else v for k, v in kw.items()}
    assert tprof.ray_count(ttt.RenderOptions(**plain), avg) == \
        jprof.ray_count(tt.RenderOptions(**kw), avg)


def test_stage_breakdown_and_device_trace_on_cpu(tmp_path):
    scene = ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH)
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=1, bounces=1,
                             integrator=ttt.Integrator.DIRECT)
    tprof.profiler.clear()
    with tprof.device_trace(str(tmp_path)) as prof:
        out = tprof.stage_breakdown(scene, ttt.scenes.cornell_camera(device="cpu"), opts,
                                    probe_lanes=256)
    assert set(out) == {"raycast", "surface", "bounce"}
    assert all(v > 0 for v in out.values())
    assert tprof.profiler.stats("stage/bounce").n == 1
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert prof.key_averages()
    with tprof.device_trace(None) as none:
        assert none is None


def test_stage_breakdown_runs_each_stage_as_a_staged_unit(monkeypatch):
    """Each stage goes through ``graphs.staged_unit`` (a CUDA graph on the
    card; on the CPU the body itself, run eagerly), in the reference's
    order; a body's runs are word-for-word repeatable, as replays of one
    capture must be, and write nothing the next run reads."""
    from terra_tpu_torch import graphs

    bodies = []
    real = graphs.staged_unit

    def spy(body):
        bodies.append(body)
        return real(body)

    monkeypatch.setattr(graphs, "staged_unit", spy)
    scene = ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH)
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=1, bounces=1,
                             integrator=ttt.Integrator.DIRECT)
    out = tprof.stage_breakdown(scene, ttt.scenes.cornell_camera(device="cpu"), opts,
                                probe_lanes=256)
    assert [b.stages for b in bodies] == [("raycast",), ("surface",), ("bounce",)]
    assert list(out) == ["raycast", "surface", "bounce"]
    for b in bodies:
        assert b.inputs.device.type == "cpu" and b.save() is None
        first, again = (_tensors(b.replay(b.stages[0])) for _ in range(2))
        assert first and len(first) == len(again)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def _tensors(obj) -> list:
    """Every tensor in ``obj`` (tensors, tuples, lists, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []
