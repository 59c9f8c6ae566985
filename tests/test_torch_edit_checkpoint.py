"""Port scene editing and checkpoints vs terra_tpu: twins of
tests/test_components.py's editing tests and of
tests/test_checkpoint_pytree.py, files written by either package loaded by
the other, and the resumed film (render state saved, loaded and rendered
on) against terra_tpu's under test_golden's twin budgets."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import terra_tpu as tt
from terra_tpu import checkpoint as jckpt
from terra_tpu import edit as jedit
from terra_tpu import optim as joptim
import terra_tpu_torch as ttt
from terra_tpu_torch import checkpoint, edit, optim
from terra_tpu_torch.checkpoint import load_pytree, save_pytree, tree_leaves, tree_unflatten
from tests.test_golden import _assert_twin_match
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"


def test_list_and_move_object():
    scene = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BVH, device=CPU)
    objs = edit.list_objects(scene)
    assert len(objs) == 8  # five walls, the light, two blocks
    assert objs == jedit.list_objects(tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH))
    moved = edit.move_object(scene, 6, (0.0, 50.0, 0.0))
    assert float((moved.geometry.positions - scene.geometry.positions).abs().max()) == 50.0
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=4, bounces=1,
                             integrator=ttt.Integrator.DIRECT, accelerator=ttt.Accelerator.BVH)
    img0 = ttt.render(scene, cam, opts, seed=1).mean().numpy()
    img1 = ttt.render(moved, cam, opts, seed=1).mean().numpy()
    assert np.isfinite(img1).all()
    assert np.abs(img0 - img1).max() > 1e-3


def test_moved_object_matches_reference():
    """A move refits the tree exactly as terra_tpu's does on the same tree
    (both built at leaf 8) and renders its image."""
    from terra_tpu.accel import lbvh as jlbvh

    js = tt.scenes.cornell_box()
    js = dataclasses.replace(js, bvh=jlbvh.build(js.geometry, leaf_size=8))
    ts = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BVH, device=CPU)
    jm = jedit.move_object(js, 6, (0.0, 50.0, 0.0))
    tm = edit.move_object(ts, 6, (0.0, 50.0, 0.0))
    np.testing.assert_array_equal(tm.geometry.positions.numpy(), np.asarray(jm.geometry.positions))
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(getattr(tm.bvh, f).numpy(), np.asarray(getattr(jm.bvh, f)))
    jo = tt.RenderOptions(width=12, height=12, samples_per_pixel=4, bounces=1,
                          integrator=tt.Integrator.DIRECT, subpixel_jitter=0.5)
    to = ttt.RenderOptions(width=12, height=12, samples_per_pixel=4, bounces=1,
                           integrator=int(tt.Integrator.DIRECT), subpixel_jitter=0.5)
    ref = np.asarray(tt.render(jm, tt.scenes.cornell_camera(), jo, seed=1).mean())
    img = ttt.render(tm, ttt.scenes.cornell_camera(device=CPU), to, seed=1).mean().numpy()
    _assert_twin_match(img, ref, 2e-3, 8e-3, 5e-3)


def test_move_light_rebuilds_light_table():
    scene = ttt.scenes.cornell_box(device=CPU)
    scaled = edit.transform_object(scene, 5, lambda p: p * torch.tensor([2.0, 1.0, 2.0]))
    # the light's triangles grew, so the table's areas must grow
    assert float(scaled.lights.area.sum()) > float(scene.lights.area.sum()) * 1.5
    ref = jedit.transform_object(tt.scenes.cornell_box(), 5,
                                 lambda p: p * jnp.asarray([2.0, 1.0, 2.0]))
    for f in ("tri_idx", "area", "cdf", "emissive", "mat_id"):
        np.testing.assert_array_equal(getattr(scaled.lights, f).numpy(),
                                      np.asarray(getattr(ref.lights, f)))


def test_pytree_roundtrip_scene_params(tmp_path):
    scene = ttt.scenes.cornell_box(device=CPU)
    params = optim.extract_params(scene, ("attrs", "emissive"))
    p = str(tmp_path / "params.npz")
    save_pytree(p, params)
    back = load_pytree(p, {k: torch.zeros_like(v) for k, v in params.items()})
    for k in params:
        assert torch.equal(back[k], params[k])


def test_pytree_roundtrip_optimizer_state(tmp_path):
    """torch.optim.Adam's per-parameter state after one step survives a
    save and load."""
    scene = ttt.scenes.cornell_box(device=CPU)
    params = optim._trainable(optim.extract_params(scene, ("attrs",)))
    opt = torch.optim.Adam(tree_leaves(params), lr=1e-2)
    params["attrs"].grad = torch.ones_like(params["attrs"])
    opt.step()
    state = opt.state_dict()["state"]
    p = str(tmp_path / "opt.npz")
    save_pytree(p, state)
    back = load_pytree(p, {i: {k: torch.zeros_like(v) for k, v in s.items()}
                           for i, s in state.items()})
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert torch.equal(a, b)


def _adam_state():
    """optax Adam state of the Cornell attrs after one step, and its params."""
    params = joptim.extract_params(tt.scenes.cornell_box(), ("attrs", "emissive"))
    opt = optax.adam(1e-2)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, state = opt.update(grads, state, params)
    return params, state


def _torch_like(tree):
    """A tree of the same structure with torch zeros for leaves."""
    leaves = jax.tree_util.tree_leaves(tree)
    return tree_unflatten(tree, [torch.zeros(np.shape(x)) for x in leaves])


def test_tree_order_matches_jax():
    """Leaves come in jax.tree_util's order: dict keys sorted, NamedTuple
    fields in order, None holding none."""
    params, state = _adam_state()
    tree = {"opt": state, "b": None, "a": (params, [1, 2])}
    ref = jax.tree_util.tree_leaves(tree)
    got = tree_leaves(tree)
    assert len(got) == len(ref)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, ref))


@pytest.mark.parametrize("what", ["params", "adam_state"])
def test_reference_pytree_loads_in_port(tmp_path, what):
    params, state = _adam_state()
    tree = params if what == "params" else state
    p = str(tmp_path / "tree.npz")
    jckpt.save_pytree(p, tree)
    back = load_pytree(p, _torch_like(tree))
    assert type(back) is type(tree)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("what", ["params", "adam_state"])
def test_port_pytree_loads_in_reference(tmp_path, what):
    params, state = _adam_state()
    tree = params if what == "params" else state
    torch_tree = tree_unflatten(tree, [torch.as_tensor(np.array(x))
                                       for x in jax.tree_util.tree_leaves(tree)])
    p = str(tmp_path / "tree.npz")
    save_pytree(p, torch_tree)
    back = jckpt.load_pytree(p, jax.tree_util.tree_map(jnp.zeros_like, tree))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _film(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((6, 5, 3), np.float32), np.full((6, 5), 8, np.int32))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_render_state_loads_across_packages(tmp_path, writer):
    acc, samples = _film()
    p = str(tmp_path / "state.npz")
    meta = {"spp": 8, "scene": "cornell"}
    if writer == "port":
        checkpoint.save_render_state(p, ttt.Film(acc=torch.as_tensor(acc),
                                                 samples=torch.as_tensor(samples)), 11, meta)
        film, seed, got_meta = jckpt.load_render_state(p)
        np.testing.assert_array_equal(np.asarray(film.acc), acc)
        np.testing.assert_array_equal(np.asarray(film.samples), samples)
    else:
        jckpt.save_render_state(p, tt.Film(acc=jnp.asarray(acc), samples=jnp.asarray(samples)),
                                11, meta)
        film, seed, got_meta = checkpoint.load_render_state(p, device=CPU)
        np.testing.assert_array_equal(film.acc.numpy(), acc)
        np.testing.assert_array_equal(film.samples.numpy(), samples)
    assert (seed, got_meta) == (11, meta)
    assert not (tmp_path / "state.npz.tmp.npz").exists()


def test_resumed_film_matches_reference(tmp_path):
    """C2: a film rendered in two halves of four full chunks each (the
    second resumed from a saved render state) adds its chunks in the
    reference's order and matches terra_tpu's resumed film under the
    golden budgets; the sample counts are equal exactly."""
    kw = dict(width=16, height=16, samples_per_pixel=8, samples_per_launch=2, bounces=2,
              subpixel_jitter=0.5)
    jo = tt.RenderOptions(**kw, integrator=tt.Integrator.DIRECT)
    to = ttt.RenderOptions(**kw, integrator=int(tt.Integrator.DIRECT))
    js, jc = tt.scenes.cornell_box(accelerator=tt.Accelerator.BVH), tt.scenes.cornell_camera()
    ts = ttt.scenes.cornell_box(accelerator=ttt.Accelerator.BVH, device=CPU)
    tc = ttt.scenes.cornell_camera(device=CPU)
    p = str(tmp_path / "film.npz")
    checkpoint.save_render_state(p, ttt.render(ts, tc, to, seed=5), 5)
    film, seed, _ = checkpoint.load_render_state(p, device=CPU)
    resumed = ttt.render(ts, tc, to, seed=seed, film=film)
    ref = tt.render(js, jc, jo, seed=5, film=tt.render(js, jc, jo, seed=5))
    np.testing.assert_array_equal(resumed.samples.numpy(), np.asarray(ref.samples))
    _assert_twin_match(resumed.mean().numpy(), np.asarray(ref.mean()), 2e-3, 8e-3, 5e-3)
