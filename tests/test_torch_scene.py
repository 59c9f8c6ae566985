"""Port scene commit, shade tables, SAH build and interop vs terra_tpu: the
same raw geometry gives the same tables, exactly."""
import dataclasses

import numpy as np
import pytest
import torch

import terra_tpu as tt
from terra_tpu.accel import lbvh as jlbvh
from terra_tpu.surface import build_shade_tables as j_shade_tables
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch.accel import lbvh as tlbvh
from terra_tpu_torch.surface import build_shade_tables as t_shade_tables

SMALL_COURTYARD = dict(grid=16, columns=4, column_segments=8, column_levels=2, tex_res=16)


def flatten(obj):
    """A JAX scene/camera dataclass as nested dicts of NumPy arrays and
    plain values (the form interop.scene_from_numpy takes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: flatten(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, tuple)):
        return obj
    return np.asarray(obj)


def _scenes(case):
    if case == "cornell_brute":
        return tt.scenes.cornell_box(), ttt.scenes.cornell_box(device="cpu")
    if case == "cornell_bvh":
        return (tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH),
                ttt.scenes.cornell_box(device="cpu", accelerator=ttt.Accelerator.BVH))
    if case == "cornell_ggx":
        return (tt.scenes.cornell_box(wall_bsdf=tt.BSDFType.GGX),
                ttt.scenes.cornell_box(device="cpu", wall_bsdf=ttt.BSDFType.GGX))
    return (tt.scenes.courtyard(**SMALL_COURTYARD),
            ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD))


def _eq(got, ref):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["cornell_brute", "cornell_bvh", "cornell_ggx", "courtyard"])
def test_commit_matches_reference(case):
    js, ts = _scenes(case)
    for part in ("geometry", "textures"):
        for f in dataclasses.fields(getattr(ts, part)):
            _eq(getattr(getattr(ts, part), f.name), getattr(getattr(js, part), f.name))
    for f in ("tri_idx", "area", "cdf", "emissive", "mat_id"):
        _eq(getattr(ts.lights, f), getattr(js.lights, f))
    assert ts.lights.num == int(js.lights.num)
    m, jm = ts.materials, js.materials
    assert (m.types_present, m.tex_slots, m.emissive_textured) == \
        (jm.types_present, jm.tex_slots, jm.emissive_textured)
    for f in ("bsdf_type", "attrs", "attr_tex", "emissive", "emissive_tex", "ior"):
        _eq(getattr(m, f), getattr(jm, f))
    _eq(ts.env_value, js.env_value)
    assert ts.env_tex == int(js.env_tex)
    assert (ts.bvh is None) == (js.bvh is None)
    tab, jtab = t_shade_tables(ts), j_shade_tables(js)
    for f in ("tri", "mat", "light"):
        _eq(getattr(tab, f), getattr(jtab, f))


@pytest.mark.parametrize("case,leaf_size", [("cornell_bvh", 4), ("courtyard", 8),
                                            ("random", 8), ("random", 16)])
def test_sah_build_matches_reference(case, leaf_size):
    if case == "random":
        js = tt.scenes.random_triangles(3000, seed=leaf_size)
        ts = ttt.scenes.random_triangles(3000, device="cpu", seed=leaf_size)
    else:
        js, ts = _scenes(case)
    jb = jlbvh.build(js.geometry, leaf_size=leaf_size)
    tb = tlbvh.build(ts.geometry, leaf_size=leaf_size)
    for f in ("node_min", "node_max", "node_left", "node_right", "leaf_tri", "tri_order"):
        _eq(getattr(tb, f), getattr(jb, f))
    assert (tb.leaf_size, tb.num_leaves, tb.depth) == (jb.leaf_size, jb.num_leaves, jb.depth)


def _assert_tree_equal(got, ref):
    """Every tensor in the port object equals the NumPy leaf it came from."""
    if got is None:
        assert ref is None
    elif isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), ref)
    elif dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _assert_tree_equal(getattr(got, f.name), ref[f.name])
    else:
        assert got == (tuple(ref) if isinstance(got, tuple) else type(got)(ref))


@pytest.mark.parametrize("case", ["cornell_brute", "courtyard"])
def test_interop_round_trip(case):
    js, _ = _scenes(case)
    d = flatten(js)
    scene = interop.scene_from_numpy(d, device="cpu")
    _assert_tree_equal(scene, d)
    assert scene.materials.types_present == js.materials.types_present
    cam = tt.scenes.courtyard_camera()
    _assert_tree_equal(interop.camera_from_numpy(flatten(cam), device="cpu"), flatten(cam))
