"""Port render (plain PyTorch on the CPU) vs terra_tpu.render and the NumPy
mirror on the same scene, seed and options. Both draw bit-identical random
numbers, so images are compared lane for lane with test_golden's twin
budgets: tol 2e-3, flip 8e-3 (1.2e-2 for GGX), energy 5e-3."""
import enum
import importlib

import numpy as np
import pytest
import torch

import terra_tpu as tt
from terra_tpu.film import tonemap as j_tonemap
from terra_tpu.testing import mirror
from tests.test_golden import _assert_twin_match
from tests.test_torch_scene import SMALL_COURTYARD, flatten
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch.accel import pallas_traverse as tpt

TOL, FLIP, FLIP_GGX, ENERGY = 2e-3, 8e-3, 1.2e-2, 5e-3


def _opts(**kw):
    """The same options for both packages (port enums from ints)."""
    plain = {k: int(v) if isinstance(v, enum.Enum) else v for k, v in kw.items()}
    return tt.RenderOptions(**kw), ttt.RenderOptions(**plain)


def _port_image(scene, cam, opts, seed):
    return ttt.render(scene, cam, opts, seed=seed).mean().numpy()


def _reference(js, cam, jo, seed, with_mirror=True):
    img = np.asarray(tt.render(js, cam, jo, seed=seed).mean())
    return img, (mirror.render_mirror(js, cam, jo, seed=seed) if with_mirror else None)


CORNELL = dict(width=24, height=24, samples_per_pixel=8, bounces=3, subpixel_jitter=0.5,
               accelerator=tt.Accelerator.BVH)
INTEGRATORS = [tt.Integrator.SIMPLE, tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS]


@pytest.fixture(scope="module")
def cornell_refs():
    """Reference renders of the BVH Cornell box, one per integrator."""
    js = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH)
    cam = tt.scenes.cornell_camera()
    return {i: _reference(js, cam, _opts(**CORNELL, integrator=i)[0], 3) for i in INTEGRATORS}


@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_bvh_cornell_matches_reference_and_mirror(cornell_refs, integrator):
    _, to = _opts(**CORNELL, integrator=integrator)
    img = _port_image(ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH),
                      ttt.scenes.cornell_camera(device="cpu"), to, 3)
    ref, mir = cornell_refs[integrator]
    _assert_twin_match(img, ref, TOL, FLIP, ENERGY)
    _assert_twin_match(img, mir, TOL, FLIP, ENERGY)


def test_persistent_lanes_match_reference(cornell_refs):
    jo, to = _opts(**CORNELL, integrator=tt.Integrator.DIRECT, samples_per_lane=4)
    img = _port_image(ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH),
                      ttt.scenes.cornell_camera(device="cpu"), to, 3)
    ref, _ = _reference(tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH),
                        tt.scenes.cornell_camera(), jo, 3, with_mirror=False)
    _assert_twin_match(img, ref, TOL, FLIP, ENERGY)
    # the same estimator as the fixed-depth wavefront, summed in another order
    np.testing.assert_allclose(img, cornell_refs[tt.Integrator.DIRECT][0], rtol=2e-4, atol=2e-4)


def test_ggx_mis_matches_reference_and_mirror():
    jo, to = _opts(width=16, height=16, samples_per_pixel=8, bounces=2,
                   integrator=tt.Integrator.DIRECT_MIS, accelerator=tt.Accelerator.BVH)
    js = tt.scenes.cornell_box(wall_bsdf=tt.BSDFType.GGX, accelerator=tt.Accelerator.BVH)
    ts = ttt.scenes.cornell_box(device="cpu", wall_bsdf=ttt.BSDFType.GGX,
                                accelerator=ttt.Accelerator.BVH)
    img = _port_image(ts, ttt.scenes.cornell_camera(device="cpu"), to, 11)
    ref, mir = _reference(js, tt.scenes.cornell_camera(), jo, 11)
    _assert_twin_match(img, ref, TOL, FLIP_GGX, ENERGY)
    _assert_twin_match(img, mir, TOL, FLIP_GGX, ENERGY)


def test_brute_cornell_matches_reference_and_mirror():
    jo, to = _opts(width=16, height=16, samples_per_pixel=8, bounces=2,
                   integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5,
                   sampling_method=tt.SamplingMethod.STRATIFIED)
    img = _port_image(ttt.scenes.cornell_box(device="cpu"),
                      ttt.scenes.cornell_camera(device="cpu"), to, 9)
    ref, mir = _reference(tt.scenes.cornell_box(), tt.scenes.cornell_camera(), jo, 9)
    _assert_twin_match(img, ref, TOL, FLIP, ENERGY)
    _assert_twin_match(img, mir, TOL, FLIP, ENERGY)


@pytest.fixture(scope="module")
def courtyard_ref():
    js = tt.scenes.courtyard(**SMALL_COURTYARD)
    jo, _ = _opts(**COURTYARD)
    return js, np.asarray(tt.render(js, tt.scenes.courtyard_camera(), jo, seed=3).mean())


COURTYARD = dict(width=24, height=24, samples_per_pixel=4, bounces=2,
                 integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5,
                 accelerator=tt.Accelerator.BVH)


@pytest.mark.parametrize("source", ["port_commit", "interop"])
def test_textured_courtyard_matches_reference(courtyard_ref, source):
    js, ref = courtyard_ref
    if source == "interop":  # the reference's own committed scene and tree
        ts = interop.scene_from_numpy(flatten(js), device="cpu")
    else:
        ts = ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD)
    _, to = _opts(**COURTYARD)
    img = _port_image(ts, ttt.scenes.courtyard_camera(device="cpu"), to, 3)
    assert np.isfinite(img).all() and img.std() > 1e-3
    _assert_twin_match(img, ref, TOL, FLIP, ENERGY)


TABLE_KINDS = {
    "binary": lambda bvh, *c: tpt.pack_tables(bvh, *c),
    "f32": lambda bvh, *c: tpt.pack_tables_wide(bvh, *c, box_enc="f32"),
    "bf16": lambda bvh, *c: tpt.pack_tables_wide(bvh, *c, box_enc="bf16"),
    "paged4": lambda bvh, *c: tpt.pack_tables_paged(bvh, *c, resident_cap=4),
}


@pytest.mark.parametrize("kind", list(TABLE_KINDS))
def test_courtyard_table_kinds_match_reference(courtyard_ref, kind, monkeypatch):
    """The render walks whichever tables pack_tables_auto hands it; each
    kind gives the reference's image within the twin budgets."""
    _, ref = courtyard_ref
    ts = ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD)
    assert ts.bvh.num_wide > 4
    monkeypatch.setattr(tpt, "pack_tables_auto", TABLE_KINDS[kind])
    _, to = _opts(**COURTYARD)
    img = _port_image(ts, ttt.scenes.courtyard_camera(device="cpu"), to, 3)
    _assert_twin_match(img, ref, TOL, FLIP, ENERGY)


@pytest.mark.parametrize("op", list(tt.Tonemap))
def test_tonemap_matches_reference(op):
    color = np.random.default_rng(int(op)).uniform(0, 4, (16, 16, 3)).astype(np.float32)
    got = ttt.tonemap(torch.as_tensor(color), int(op), exposure=1.3, gamma=2.2).numpy()
    np.testing.assert_allclose(got, np.asarray(j_tonemap(color, op, 1.3, 2.2)), rtol=2e-6,
                               atol=1e-7)


@pytest.mark.parametrize("case", ["phong", "env_on_miss", "debug_integrator"])
def test_unported_features_raise(case):
    """The three features that raised NotImplementedError until the port
    had them (Phong walls, the miss-env add, a debug integrator) now render
    the reference's image within the twin budgets."""
    jo, to = _opts(width=16, height=16, samples_per_pixel=4, bounces=2, subpixel_jitter=0.5,
                   env_on_miss=case == "env_on_miss",
                   integrator=tt.Integrator.DEBUG_DEPTH if case == "debug_integrator"
                   else tt.Integrator.DIRECT)
    wall = tt.BSDFType.PHONG if case == "phong" else tt.BSDFType.DIFFUSE
    env = (0.3, 0.4, 0.5) if case == "env_on_miss" else (0.0, 0.0, 0.0)
    ts = ttt.scenes.cornell_box(device="cpu", wall_bsdf=int(wall), env_value=env)
    img = _port_image(ts, ttt.scenes.cornell_camera(device="cpu"), to, 3)
    ref, _ = _reference(tt.scenes.cornell_box(wall_bsdf=wall, env_value=env),
                        tt.scenes.cornell_camera(), jo, 3, with_mirror=False)
    assert img.mean() > 0.0
    _assert_twin_match(img, ref, TOL, FLIP_GGX if case == "phong" else FLIP, ENERGY)


@pytest.mark.parametrize("split", ["bands", "chunks", "resume"])
def test_split_renders_match_whole_frame(split, monkeypatch):
    """Row bands, sample chunks and a resumed film draw the same samples
    as one whole-frame render (pixel and sample ids stay global)."""
    # (``ttt.render`` is the function; the module holds the lane cap)
    render_mod = importlib.import_module("terra_tpu_torch.render")
    scene, cam = ttt.scenes.cornell_box(device="cpu"), ttt.scenes.cornell_camera(device="cpu")
    opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5)
    whole = ttt.render(scene, cam, opts, seed=4)
    if split == "bands":
        monkeypatch.setattr(render_mod, "MAX_WAVEFRONT_LANES", 12 * 8 * 5)
        assert render_mod._band_rows(opts, 8) == 4
        film = ttt.render(scene, cam, opts, seed=4)
    elif split == "chunks":
        film = ttt.render(scene, cam, opts.replace(samples_per_launch=3), seed=4)
    else:
        half = opts.replace(samples_per_pixel=4)
        film = ttt.render(scene, cam, half, seed=4, film=ttt.render(scene, cam, half, seed=4))
    assert torch.equal(film.samples, whole.samples)
    torch.testing.assert_close(film.acc, whole.acc, rtol=1e-5, atol=1e-5)
