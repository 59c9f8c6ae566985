"""Port renders with the Phong, Disney, mirror and glass lobes (plain
PyTorch on the CPU) vs terra_tpu.render on the same scene, seed and
options, held to tests/test_golden.py::_assert_twin_match with the
reference tests' own budgets: glass and mirror (test_glass.py:181,
test_delta_lighting.py:144) 2e-3 / 1.5e-2 / 6e-3, Phong (test_golden.py
``test_golden_phong``) 2e-3 / 1.2e-2 / 5e-3, Disney the diffuse goldens'
2e-3 / 8e-3 / 5e-3."""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest

import terra_tpu as tt
from tests.test_golden import _assert_twin_match
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import flatten
import terra_tpu_torch as ttt
from terra_tpu_torch import interop

DELTA = (2e-3, 1.5e-2, 6e-3)
PHONG = (2e-3, 1.2e-2, 5e-3)
GOLDEN = (2e-3, 8e-3, 5e-3)


def _opts(**kw):
    plain = {k: int(v) if isinstance(v, enum.Enum) else v for k, v in kw.items()}
    return tt.RenderOptions(**kw), ttt.RenderOptions(**plain)


def _twin(js, opts, seed, budget, cam=None):
    """Render ``js`` in both packages (the port's scene carried across with
    interop, so both walk the same tree) and compare."""
    cam = cam if cam is not None else tt.scenes.cornell_camera()
    jo, to = _opts(**opts)
    ref = np.asarray(tt.render(js, cam, jo, seed=seed).mean())
    ts = interop.scene_from_numpy(flatten(js), device="cpu")
    tc = interop.camera_from_numpy(flatten(cam), device="cpu")
    img = ttt.render(ts, tc, to, seed=seed).mean().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    _assert_twin_match(img, ref, *budget)
    return img


GLASS = dict(width=20, height=20, samples_per_pixel=8, bounces=4,
             integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5)


@pytest.mark.parametrize("lanes", [1, 4])
def test_glass_cornell_matches_reference(lanes):
    """test_glass.py:181's render; with lanes of 4 it runs the persistent
    wavefront, whose regenerated paths restart the specular-bounce flag."""
    _twin(tt.scenes.cornell_box(block_bsdf=tt.BSDFType.GLASS),
          dict(GLASS, samples_per_lane=lanes), 7, DELTA)


def test_glass_cornell_bvh_matches_port_commit():
    """The port's own commit of the glass box (its SAH tree) renders the
    reference's image too."""
    jo, to = _opts(**GLASS, accelerator=tt.Accelerator.BVH)
    ref = np.asarray(tt.render(tt.scenes.cornell_box(block_bsdf=tt.BSDFType.GLASS,
                                                     accelerator=tt.Accelerator.BVH),
                               tt.scenes.cornell_camera(), jo, seed=7).mean())
    ts = ttt.scenes.cornell_box(device="cpu", block_bsdf=ttt.BSDFType.GLASS,
                                accelerator=ttt.Accelerator.BVH)
    img = ttt.render(ts, ttt.scenes.cornell_camera(device="cpu"), to, seed=7).mean().numpy()
    _assert_twin_match(img, ref, *DELTA)


@pytest.mark.parametrize("integrator", [tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS])
def test_mirror_cornell_matches_reference(integrator):
    """test_delta_lighting.py:144's render under both direct integrators."""
    _twin(tt.scenes.cornell_box(block_bsdf=tt.BSDFType.MIRROR),
          dict(width=20, height=20, samples_per_pixel=8, bounces=3, integrator=integrator,
               subpixel_jitter=0.5), 31, DELTA)


@pytest.mark.parametrize("integrator", [tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS])
def test_phong_walls_match_reference(integrator):
    """test_golden_phong's render, and the same under MIS (the lobe pick
    rides from the sample into the light strategy's pdf)."""
    _twin(tt.scenes.cornell_box(wall_bsdf=tt.BSDFType.PHONG),
          dict(width=16, height=16, samples_per_pixel=8, bounces=2, integrator=integrator),
          5, PHONG)


def _disney_box():
    """The Cornell box with a Disney short block: every principled
    parameter set (base color, specular + tint, sheen + tint, clearcoat +
    gloss, metalness, roughness, anisotropy, subsurface)."""
    js = tt.scenes.cornell_box(block_bsdf=tt.BSDFType.DISNEY)
    a = np.asarray(js.materials.attrs).copy()
    a[4, :6] = [(0.8, 0.5, 0.3), (0.5, 0.3, 0.0), (0.4, 0.5, 0.0), (0.6, 0.7, 0.0),
                (0.3, 0.45, 0.0), (0.5, 0.2, 0.0)]
    return dataclasses.replace(js, materials=dataclasses.replace(js.materials,
                                                                 attrs=jnp.asarray(a)))


@pytest.mark.parametrize("integrator", [tt.Integrator.DIRECT, tt.Integrator.DIRECT_MIS])
def test_disney_block_matches_reference(integrator):
    _twin(_disney_box(), dict(width=24, height=24, samples_per_pixel=8, bounces=3,
                              integrator=integrator, subpixel_jitter=0.5), 3, GOLDEN)
