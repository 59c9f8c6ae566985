"""Port renders lit by the environment (env_on_miss, env NEE) and the four
debug integrators, vs terra_tpu.render on the same scene, seed and
options, held to tests/test_golden.py::_assert_twin_match's budgets
(tol 2e-3, flip 8e-3, energy 5e-3)."""
import enum

import numpy as np
import pytest

import terra_tpu as tt
from terra_tpu.scene import ATTR, BSDFType, MaterialTable, commit
from terra_tpu.scenes import make_geometry
from tests.test_envmap import _env_scene
from tests.test_golden import _assert_twin_match
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import flatten
import terra_tpu_torch as ttt
from terra_tpu_torch import interop

BUDGET = (2e-3, 8e-3, 5e-3)


def _render_both(js, cam, seed, **kw):
    plain = {k: int(v) if isinstance(v, enum.Enum) else v for k, v in kw.items()}
    ref = np.asarray(tt.render(js, cam, tt.RenderOptions(**kw), seed=seed).mean())
    ts = interop.scene_from_numpy(flatten(js), device="cpu")
    tc = interop.camera_from_numpy(flatten(cam), device="cpu")
    img = ttt.render(ts, tc, ttt.RenderOptions(**plain), seed=seed).mean().numpy()
    assert np.isfinite(img).all()
    return img, ref


def _sky_texture():
    tex = np.full((32, 64, 3), 0.05, np.float32)
    tex[8:12, 20:28] = 50.0  # a bright "sun" patch
    tex[2:6, 40:60] = (0.3, 0.6, 1.2)
    return tex


FLOOR_CAM = tt.Camera.make(position=(0, 0.5, 1.2), direction=(0, -0.4, -1), up=(0, 1, 0),
                           fov_deg=45.0)


@pytest.mark.parametrize("integrator", [tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS])
@pytest.mark.parametrize("sky", ["texture", "constant"])
def test_env_nee_floor_matches_reference(integrator, sky):
    """test_envmap.py:117's open floor under a lat-long texture or a
    constant sky, with env NEE, at the golden size."""
    js = _env_scene(tex=_sky_texture()) if sky == "texture" else _env_scene()
    img, ref = _render_both(js, FLOOR_CAM, 0, width=24, height=24, samples_per_pixel=8,
                            bounces=2, subpixel_jitter=0.5, integrator=integrator,
                            env_on_miss=True, env_nee=True)
    assert img.mean() > 0.0
    _assert_twin_match(img, ref, *BUDGET)


@pytest.mark.parametrize("integrator", [tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS])
def test_env_visible_in_mirror_under_env_nee(integrator):
    """test_delta_lighting.py:190: under env NEE the miss-env add is gated
    by the specular-bounce flag, not bounce == 0, so a mirror floor under a
    constant env shows env * color = 0.54 exactly."""
    tris = [((8, 0, -8), (-8, 0, -8), (-8, 0, 8)), ((8, 0, -8), (-8, 0, 8), (8, 0, 8))]
    attrs = np.zeros((1, 8, 3), np.float32)
    attrs[0, ATTR.MIRROR_COLOR] = (0.9, 0.9, 0.9)
    mats = MaterialTable(bsdf_type=np.asarray([int(BSDFType.MIRROR)], np.int32), attrs=attrs,
                         attr_tex=np.full((1, 8), -1, np.int32),
                         emissive=np.zeros((1, 3), np.float32),
                         emissive_tex=np.full((1,), -1, np.int32),
                         ior=np.full((1,), 1.5, np.float32))
    js = commit(make_geometry(tris, [0, 0]), mats, env_value=(0.6, 0.6, 0.6))
    cam = tt.Camera.make(position=(0.0, 4.0, -4.0), direction=(0.0, -1.0, 1.0),
                         up=(0.0, 1.0, 0.0), fov_deg=10.0)
    img, ref = _render_both(js, cam, 7, width=6, height=6, samples_per_pixel=4, bounces=2,
                            integrator=integrator, subpixel_jitter=0.5, rr_start_bounce=8,
                            env_on_miss=True, env_nee=True)
    np.testing.assert_allclose(img, 0.54, rtol=1e-3)
    _assert_twin_match(img, ref, *BUDGET)


@pytest.mark.parametrize("integrator", [tt.Integrator.DEBUG_MONO, tt.Integrator.DEBUG_DEPTH,
                                        tt.Integrator.DEBUG_NORMALS,
                                        tt.Integrator.DEBUG_MIS_WEIGHTS])
def test_debug_integrator_matches_reference(integrator):
    img, ref = _render_both(tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH),
                            tt.scenes.cornell_camera(), 3, width=24, height=24,
                            samples_per_pixel=8, bounces=2, subpixel_jitter=0.5,
                            integrator=integrator, accelerator=tt.Accelerator.BVH)
    assert img.max() > 0.0
    _assert_twin_match(img, ref, *BUDGET)
