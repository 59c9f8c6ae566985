"""Port gradients (torch autograd through the plain PyTorch wavefront) vs
finite differences and vs terra_tpu: the twins of every test in
tests/test_grad.py, on the port alone with the reference's tolerances and
sizes; the port's gradient arrays against ``jax.grad`` of the same loss on
the same scene, key and options; one training step against optax's; a
JAX training run resumed in the port; and the wavefront that refuses a
gradient."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import terra_tpu as tt
from terra_tpu import optim as joptim
from terra_tpu.ops import rng as jrng
import terra_tpu_torch as ttt
from terra_tpu_torch import interop, optim
from terra_tpu_torch.checkpoint import tree_leaves
from terra_tpu_torch.ops import rng as rng_mod
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_scene import flatten

CPU = "cpu"


def _key(seed=0):
    return rng_mod.key_from_seed(seed)


def _jkey(seed=0):
    k0, k1 = jrng.key_from_seed(seed)
    return jnp.array([k0, k1], jnp.uint32)


def _mean_image(scene, cam, opts, key, spp):
    with torch.no_grad():
        return optim.render_mean_image(scene, cam, opts, key, 0, spp)


def _value_and_grad(f, x0: float):
    """(f(x0), df/dx at x0) of a scalar function of a scalar tensor."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    loss = f(x)
    (g,) = torch.autograd.grad(loss, [x])
    return float(loss.detach()), float(g)


def _fd(f, x0: float, h: float) -> float:
    with torch.no_grad():
        return (float(f(torch.tensor(x0 + h))) - float(f(torch.tensor(x0 - h)))) / (2 * h)


def _loss_for_albedo(scene, cam, opts, target):
    """Scalar loss as a function of the white-wall albedo scalar."""

    def f(albedo):
        attrs = scene.materials.attrs.clone()
        attrs[0, 0, :] = albedo
        s = optim.inject_params(scene, {"attrs": attrs})
        img = optim.render_mean_image(s, cam, opts, _key(), 0, opts.samples_per_pixel)
        return torch.mean((img - target) ** 2)

    return f


SMALL = dict(width=12, height=12, samples_per_pixel=8, bounces=2, subpixel_jitter=0.0,
             rr_start_bounce=10)


@pytest.fixture(scope="module")
def small():
    # no roulette, no jitter: the estimator is smooth in the parameters
    scene = ttt.scenes.cornell_box(device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(**SMALL, integrator=ttt.Integrator.DIRECT)
    return scene, cam, opts, _mean_image(scene, cam, opts, _key(1), 8)


def test_grad_albedo_matches_fd(small):
    scene, cam, opts, target = small
    f = _loss_for_albedo(scene, cam, opts, target * 0.5)
    _, g = _value_and_grad(f, 0.73)
    fd = _fd(f, 0.73, 1e-2)
    assert np.isfinite(g)
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-3), (g, fd)


def test_grad_emission_matches_fd(small):
    scene, cam, opts, target = small

    def f(em):
        emissive = scene.materials.emissive.clone()
        emissive[3, :] = em
        s = optim.inject_params(scene, {"emissive": emissive})
        img = optim.render_mean_image(s, cam, opts, _key(), 0, opts.samples_per_pixel)
        return torch.mean((img - target * 0.5) ** 2)

    _, g = _value_and_grad(f, 15.0)
    fd = _fd(f, 15.0, 1e-1)
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-5), (g, fd)


def test_grad_vertex_positions_finite(small):
    """Vertex-position gradients flow through the differentiable surface
    recompute and are finite; the raycast's hit choice carries none."""
    scene, cam, opts, target = small
    loss_fn = optim.make_loss_fn(cam, opts, target * 0.5)
    params = optim._trainable(optim.extract_params(scene, ("positions",)))
    _, (g,) = optim.value_and_grad(loss_fn, params, scene, _key(), 0)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0


@pytest.mark.parametrize("integrator,tol", [
    (ttt.Integrator.DEBUG_DEPTH, 0.01),  # the geometric hit recompute alone
    (ttt.Integrator.DIRECT, 0.03),       # shading-coupled (NEE d^2, cosines, basis)
])
def test_grad_vertex_positions_matches_fd(integrator, tol):
    """Translate the back wall (object 2) along +z; no jitter, no roulette,
    bounces=0, so every sampled ray stays on its triangle and the interior
    gradient is exact (visibility edges carry none, by design)."""
    scene = ttt.scenes.cornell_box(with_blocks=False, device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=4, bounces=0,
                             integrator=integrator, subpixel_jitter=0.0, rr_start_bounce=10)
    target = _mean_image(scene, cam, opts, _key(1), 4)
    wall = scene.geometry.obj_id == 2
    rows = torch.unique(scene.geometry.tri_vidx[wall].reshape(-1)).long()

    def f(dz):
        pos = scene.geometry.positions.clone()
        pos[rows, 2] = pos[rows, 2] + dz
        s = optim.inject_params(scene, {"positions": pos})
        img = optim.render_mean_image(s, cam, opts, _key(), 0, 4)
        return torch.mean((img - target * 0.5) ** 2)

    _, g = _value_and_grad(f, 0.0)
    fd = _fd(f, 0.0, 2.0)  # box units: small against the 556-wide box
    assert np.isfinite(g)
    assert abs(g - fd) < tol * max(abs(fd), 1e-7), (g, fd)


def test_vertex_optimization_refits_bvh():
    """Optimising vertex positions on a BVH scene refits the boxes every
    step: afterwards every leaf box holds its moved triangles."""
    scene = ttt.scenes.random_triangles(200, seed=3, accelerator=ttt.Accelerator.BVH, device=CPU)
    cam = dataclasses.replace(ttt.scenes.cornell_camera(device=CPU),
                              position=torch.tensor([0.0, 0.0, -4.0]),
                              direction=torch.tensor([0.0, 0.0, 1.0]))
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=1,
                             integrator=ttt.Integrator.SIMPLE, rr_start_bounce=8)
    target = _mean_image(scene, cam, opts, _key(), 2)
    scene0 = dataclasses.replace(scene, geometry=dataclasses.replace(
        scene.geometry, positions=scene.geometry.positions + 0.05))
    recovered, losses = optim.recover(scene0, cam, opts, target, fields=("positions",), steps=3,
                                      learning_rate=1e-2, seed=5)
    assert np.isfinite(losses).all()
    bvh = recovered.bvh
    pos = recovered.geometry.positions.numpy()
    vidx = recovered.geometry.tri_vidx.numpy()
    ni = bvh.num_internal
    bmin, bmax, leaf_tri = bvh.node_min.numpy(), bvh.node_max.numpy(), bvh.leaf_tri.numpy()
    for c in range(bvh.num_leaves):
        corners = pos[vidx[leaf_tri[c]]].reshape(-1, 3)
        assert (corners.min(0) >= bmin[ni + c] - 1e-4).all()
        assert (corners.max(0) <= bmax[ni + c] + 1e-4).all()


def test_recover_refits_moved_vertices():
    """Where the loss moves the vertices (the lit Cornell box on a BVH),
    recover refits the tree after every step: the final boxes are the
    refit of the first tree to the final positions."""
    from terra_tpu_torch.accel import lbvh

    scene = ttt.scenes.cornell_box(with_blocks=False, accelerator=ttt.Accelerator.BVH,
                                   device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=1,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=8)
    target = _mean_image(scene, cam, opts, _key(), 2) * 0.5
    recovered, losses = optim.recover(scene, cam, opts, target, fields=("positions",), steps=2,
                                      learning_rate=1.0, seed=5)
    moved = recovered.geometry.positions
    assert np.isfinite(losses).all() and not torch.equal(moved, scene.geometry.positions)
    ref = lbvh.refit(scene.bvh, recovered.geometry)
    assert torch.equal(recovered.bvh.node_min, ref.node_min)
    assert torch.equal(recovered.bvh.node_max, ref.node_max)
    assert not torch.equal(ref.node_min, scene.bvh.node_min)


def _checker_scene(mod, **kw):
    """Cornell box whose white-wall albedo is a bilinear, wrapped 8x8
    checker (test_grad.py's construction), for ``mod`` = terra_tpu or the
    port."""
    scene = mod.scenes.cornell_box(**kw)
    res = 8
    yy, xx = np.mgrid[0:res, 0:res]
    checker = np.where(((xx + yy) % 2 == 0)[..., None], np.float32([0.8, 0.7, 0.2]),
                       np.float32([0.2, 0.3, 0.8])).astype(np.float32)
    attr_tex = np.asarray(scene.materials.attr_tex).copy()
    attr_tex[0, 0] = 0  # white-wall diffuse albedo <- checker
    if mod is tt:
        arr = jnp.asarray
    else:
        arr = torch.as_tensor
    atlas = mod.scene.TextureAtlas(data=arr(checker[None]), size=arr(np.int32([[res, res]])),
                                   filter=arr(np.int32([1])), address=arr(np.int32([0])))
    mats = dataclasses.replace(scene.materials, attr_tex=arr(attr_tex), tex_slots=(0,))
    return dataclasses.replace(scene, textures=atlas, materials=mats)


def test_grad_texture_data_matches_fd():
    """Gradients reach TextureAtlas.data through the bilinear gather: FD
    check on one texel's red channel."""
    scene = _checker_scene(ttt, device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(**SMALL, integrator=ttt.Integrator.DIRECT)
    target = _mean_image(scene, cam, opts, _key(1), 8)

    def f(v):
        data = scene.textures.data.clone()
        data[0, 3, 4, 0] = v
        s = optim.inject_params(scene, {"textures": data})
        img = optim.render_mean_image(s, cam, opts, _key(), 0, 8)
        return torch.mean((img - target * 0.5) ** 2)

    x0 = float(scene.textures.data[0, 3, 4, 0])
    _, g = _value_and_grad(f, x0)
    fd = _fd(f, x0, 5e-2)
    assert np.isfinite(g) and abs(g) > 0.0
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-5), (g, fd)


def test_recover_texture_texel():
    """Recover a uniformly dimmed atlas by descending on 'textures'."""
    scene = _checker_scene(ttt, device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=10, height=10, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=10)
    target = _mean_image(scene, cam, opts, _key(7), 8)
    scene0 = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, data=scene.textures.data * 0.5))
    _, losses = optim.recover(scene0, cam, opts, target, fields=("textures",), steps=30,
                              learning_rate=5e-2, seed=7)
    assert losses[-1] < losses[0] * 0.35, losses[:: max(len(losses) // 8, 1)]


def _camera_case(fov):
    scene = ttt.scenes.cornell_box(with_blocks=False, device=CPU)
    cam = dataclasses.replace(ttt.scenes.cornell_camera(device=CPU), fov_deg=torch.tensor(fov))
    return scene, cam


def test_grad_camera_matches_fd():
    """Camera-pose gradients: FD check of the loss derivative with respect
    to an x-translation of a narrow camera facing the back wall (every hit
    slides on one plane); bounces=0 keeps visibility edges out."""
    scene, cam = _camera_case(12.0)
    opts = ttt.RenderOptions(width=12, height=12, samples_per_pixel=4, bounces=0,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.0,
                             rr_start_bounce=10)
    target = _mean_image(scene, cam, opts, _key(1), 4)

    def f(dx):
        params = optim.extract_params(scene, ("camera",), cam=cam)
        params["camera"]["position"] = params["camera"]["position"] + \
            torch.stack([dx, torch.zeros(()), torch.zeros(())])
        img = optim.render_mean_image(scene, optim.inject_camera(cam, params), opts, _key(), 0, 4)
        return torch.mean((img - target * 0.5) ** 2)

    _, g = _value_and_grad(f, 0.0)
    fd = _fd(f, 0.0, 2.0)
    assert np.isfinite(g) and abs(g) > 0.0
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-7), (g, fd)


def test_recover_camera_pose_x():
    """Recover a 20-unit camera x-translation with Adam (lr 1) against the
    checker-textured wall; the gradient is usable, not only correct."""
    scene = _checker_scene(ttt, device=CPU)
    cam = dataclasses.replace(ttt.scenes.cornell_camera(device=CPU), fov_deg=torch.tensor(14.0))
    opts = ttt.RenderOptions(width=16, height=16, samples_per_pixel=4, bounces=0,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             rr_start_bounce=10)
    target = _mean_image(scene, cam, opts, _key(9), 4)

    def f(dx):
        params = {"camera": {"position": cam.position + torch.tensor([1.0, 0.0, 0.0]) * dx}}
        img = optim.render_mean_image(scene, optim.inject_camera(cam, params), opts, _key(9),
                                      0, 4)
        return torch.mean((img - target) ** 2)

    dx = torch.tensor(20.0, requires_grad=True)
    opt = torch.optim.Adam([dx], lr=1.0)
    loss0 = None
    for i in range(50):
        opt.zero_grad()
        loss = f(dx)
        loss.backward()
        if i == 0:
            loss0 = float(loss.detach())
        opt.step()
    assert float(loss.detach()) < loss0 * 0.1, (loss0, float(loss.detach()))
    assert abs(float(dx.detach())) < 3.0, float(dx.detach())


def test_grad_replay_exact(small):
    """The same key replays the same random decisions: the gradient is
    the same bits on every call."""
    scene, cam, opts, target = small
    f = _loss_for_albedo(scene, cam, opts, target * 0.5)
    assert _value_and_grad(f, 0.7)[1] == _value_and_grad(f, 0.7)[1]


def test_recover_albedo_descends():
    """Perturb the white-wall albedo, recover it."""
    scene = ttt.scenes.cornell_box(with_blocks=False, device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=10, height=10, samples_per_pixel=8, bounces=2,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=10)
    target = _mean_image(scene, cam, opts, _key(7), 8)
    attrs0 = scene.materials.attrs.clone()
    attrs0[0, 0, :] = torch.tensor([0.3, 0.3, 0.3])
    scene0 = optim.inject_params(scene, {"attrs": attrs0})
    recovered, losses = optim.recover(scene0, cam, opts, target, fields=("attrs",), steps=40,
                                      learning_rate=5e-2, seed=7)
    assert losses[-1] < losses[0] * 0.2, losses[:: max(len(losses) // 8, 1)]
    rec = recovered.materials.attrs.numpy()[0, 0]
    assert np.abs(rec - 0.73).max() < 0.15, rec


# --- the port against terra_tpu ---------------------------------------------

# Largest |port - jax.grad| over the field's largest |jax.grad|: the two
# packages draw the same random numbers and take the same decisions, so
# the gradients agree to f32 reassociation (~1e-6 of the largest entry)
# except where a lane's discrete choice flips on a shared edge (a shadow
# ray on the light's coplanar edge; test_golden.py:17-20), which moves a
# few position entries by up to ~1e-2 of the largest (6 of the Cornell
# box's 288 position entries, measured). FLIP_FRAC bounds the share of
# entries beyond the tight tolerance.
GRAD_TOL, GRAD_FLIP_TOL, FLIP_FRAC = 1e-5, 1e-2, 0.05


def _twin_case(field):
    """(terra_tpu scene, port scene, jax cam, port cam, options) of one
    parameter group's gradient twin."""
    kw = dict(**SMALL, integrator=tt.Integrator.DIRECT)
    if field == "camera":
        kw.update(bounces=0, samples_per_pixel=4)
    jo = tt.RenderOptions(**kw)
    to = ttt.RenderOptions(**{k: int(v) if k == "integrator" else v for k, v in kw.items()})
    if field == "textures":
        js, ts = _checker_scene(tt), _checker_scene(ttt, device=CPU)
    else:
        js, ts = tt.scenes.cornell_box(), ttt.scenes.cornell_box(device=CPU)
    jc, tc = tt.scenes.cornell_camera(), ttt.scenes.cornell_camera(device=CPU)
    return js, ts, jc, tc, jo, to


@pytest.mark.parametrize("field", ["attrs", "emissive", "positions", "textures", "camera"])
def test_gradients_match_jax(field):
    """The port's gradient arrays of one parameter group against jax.grad
    of the same loss (same scene, target, key and options)."""
    js, ts, jc, tc, jo, to = _twin_case(field)
    spp = jo.samples_per_pixel
    jtarget = 0.5 * joptim.render_mean_image(js, jc, jo, _jkey(1), jnp.int32(0), spp)
    jparams = joptim.extract_params(js, (field,), cam=jc)
    jg = jax.grad(joptim.make_loss_fn(jc, jo, jtarget))(jparams, js, _jkey(), jnp.int32(0))
    loss_fn = optim.make_loss_fn(tc, to, torch.as_tensor(np.array(jtarget)))
    params = optim._trainable(optim.extract_params(ts, (field,), cam=tc))
    _, grads = optim.value_and_grad(loss_fn, params, ts, _key(), 0)
    for got, ref in zip(grads, jax.tree_util.tree_leaves(jg)):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0.0
        diff = np.abs(got.numpy() - ref) / scale
        assert diff.max() <= GRAD_FLIP_TOL, diff.max()
        assert (diff > GRAD_TOL).mean() <= FLIP_FRAC, (diff > GRAD_TOL).mean()


def test_safe_sqrt_bits_and_gradient():
    """math3.safe_sqrt: torch.sqrt's bits, torch.sqrt's gradient where the
    root is positive, 0 (not inf) where it is 0."""
    from terra_tpu_torch.ops import math3

    x = torch.tensor([0.0, 1e-30, 0.25, 2.0], requires_grad=True)
    y = math3.safe_sqrt(x)
    assert torch.equal(y, torch.sqrt(x.detach()))
    (g,) = torch.autograd.grad(y.sum(), [x])
    ref = 0.5 / torch.sqrt(x.detach()[1:])
    assert g[0] == 0.0 and torch.equal(g[1:], ref)


@pytest.mark.parametrize("kind", ["ggx", "phong"])
def test_sampler_gradient_finite_at_the_pole(kind):
    """A lobe sample within ~1e-6 of its pole rounds sqrt(1 - cos^2) to 0:
    the reference's gradient in the lobe parameters is then non-finite
    (jax.grad), the port's (math3.safe_sqrt) finite, and the sampled
    directions agree with the reference's."""
    from terra_tpu import bsdf as jbsdf
    from terra_tpu_torch import bsdf as tbsdf
    from tests.test_torch_bsdf import _case

    js, ts, wo, e, present = _case(kind)
    n = len(wo)
    e = [np.full(n, 0.5, np.float32) for _ in range(3)]
    e[0 if kind == "ggx" else 1][:] = 1e-9  # the pole of the lobe's sampler
    e[2][:] = 0.999  # the specular lobe

    def jsum(attrs):
        surf = dataclasses.replace(js, attrs=attrs)
        return jnp.sum(jbsdf.sample(surf, *(jnp.asarray(x) for x in e), jnp.asarray(wo),
                                    present)[0])

    jg = np.asarray(jax.grad(jsum)(js.attrs))
    assert not np.isfinite(jg).all()
    attrs = ts.attrs.clone().requires_grad_(True)
    wi, _ = tbsdf.sample(dataclasses.replace(ts, attrs=attrs), *(torch.as_tensor(x) for x in e),
                         torch.as_tensor(wo), present)
    (g,) = torch.autograd.grad(wi.sum(), [attrs])
    assert torch.isfinite(g).all()
    ref = np.asarray(jbsdf.sample(js, *(jnp.asarray(x) for x in e), jnp.asarray(wo), present)[0])
    np.testing.assert_allclose(wi.detach().numpy(), ref, rtol=1e-5, atol=1e-6)


def _config4(mod, **kw):
    """bench.py's config 4 at 12x12: (scene with the wall albedo set to
    [0.3, 0.5, 0.6], camera, options)."""
    scene = mod.scenes.cornell_box(with_blocks=False, **kw)
    opts = mod.RenderOptions(width=12, height=12, samples_per_pixel=8, bounces=2,
                             integrator=mod.Integrator.DIRECT, rr_start_bounce=8)
    return scene, mod.scenes.cornell_camera(**kw), opts


def test_train_step_matches_optax():
    """Two make_train_step steps with torch.optim.Adam against two with
    optax.adam: the same loss (rtol 1e-5) and parameters (rtol 1e-5).
    Adam's first steps are lr * g / |g| per entry, so the comparison holds
    the update's sign and scale and the advance of the sample offset."""
    js, jc, jo = _config4(tt)
    ts, tc, to = _config4(ttt, device=CPU)
    target = joptim.render_mean_image(js, jc, jo, _jkey(7), jnp.int32(0), 8)
    attrs0 = np.asarray(js.materials.attrs).copy()
    attrs0[0, 0] = [0.3, 0.5, 0.6]
    jp = {"attrs": jnp.asarray(attrs0)}
    jopt = optax.adam(3e-2)
    jstate = joptim.TrainState(jp, jopt.init(jp), jnp.int32(0))
    jstep = joptim.make_train_step(jc, jo, target, jopt)
    state = optim.TrainState({"attrs": torch.as_tensor(attrs0)}, None, 0)
    step = optim.make_train_step(tc, to, torch.as_tensor(np.array(target)),
                                 functools.partial(torch.optim.Adam, lr=3e-2))
    for _ in range(2):
        jstate, jloss = jstep(jstate, js, _jkey())
        state, loss = step(state, ts, _key())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(state.params["attrs"].detach().numpy(),
                               np.asarray(jstate.params["attrs"]), rtol=1e-5, atol=1e-7)
    assert state.step == 2


def test_jax_training_run_resumes_in_port():
    """Two optax steps in terra_tpu, then the params and the Adam state
    carried into the port (interop.params_from_numpy,
    adam_state_from_numpy), then one step on each side: the same params
    within rtol 1e-5."""
    js, jc, jo = _config4(tt)
    ts, tc, to = _config4(ttt, device=CPU)
    target = joptim.render_mean_image(js, jc, jo, _jkey(7), jnp.int32(0), 8)
    attrs0 = np.asarray(js.materials.attrs).copy()
    attrs0[0, 0] = [0.3, 0.5, 0.6]
    jp = {"attrs": jnp.asarray(attrs0)}
    jopt = optax.adam(3e-2)
    jstate = joptim.TrainState(jp, jopt.init(jp), jnp.int32(0))
    jstep = joptim.make_train_step(jc, jo, target, jopt)
    for _ in range(2):
        jstate, _ = jstep(jstate, js, _jkey())
    adam = jstate.opt_state[0]  # optax.adam = chain(scale_by_adam, scale_by_learning_rate)
    params = optim._trainable(interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    opt = interop.adam_state_from_numpy(
        {"count": np.asarray(adam.count), "mu": jax.tree_util.tree_map(np.asarray, adam.mu),
         "nu": jax.tree_util.tree_map(np.asarray, adam.nu)}, params, lr=3e-2)
    assert opt.param_groups[0]["params"] == tree_leaves(params)
    state = optim.TrainState(params, opt, int(jstate.step))
    jstate, _ = jstep(jstate, js, _jkey())
    step = optim.make_train_step(tc, to, torch.as_tensor(np.array(target)), None)
    state, _ = step(state, ts, _key())
    np.testing.assert_allclose(state.params["attrs"].detach().numpy(),
                               np.asarray(jstate.params["attrs"]), rtol=1e-5, atol=1e-7)


def test_persistent_lanes_refuse_gradients():
    """trace_persistent (a while loop in the reference) raises when a
    scene tensor requires a gradient instead of returning detached
    radiance; without one it renders."""
    scene, cam, opts = _config4(ttt, device=CPU)
    opts = opts.replace(samples_per_lane=4)
    params = optim._trainable(optim.extract_params(scene, ("attrs",)))
    with pytest.raises(RuntimeError, match="no gradient"):
        optim.render_mean_image(optim.inject_params(scene, params), cam, opts, _key(), 0, 8)
    img = _mean_image(optim.inject_params(scene, params), cam, opts, _key(), 8)
    assert torch.isfinite(img).all() and not img.requires_grad


@pytest.mark.parametrize("fn", ["make_train_step_sharded", "make_grad_fn_sharded", "recover"])
def test_sharded_steps_wait_for_distributed(fn):
    """The sharded steps are not ported yet (ROADMAP queue A11) and say so."""
    scene, cam, opts = _config4(ttt, device=CPU)
    target = torch.zeros((12, 12, 3))
    call = {"recover": lambda: optim.recover(scene, cam, opts, target, mesh=object()),
            "make_train_step_sharded": lambda: optim.make_train_step_sharded(cam, opts, target,
                                                                             None, object()),
            "make_grad_fn_sharded": lambda: optim.make_grad_fn_sharded(cam, opts, target,
                                                                       object())}[fn]
    with pytest.raises(NotImplementedError, match="A11"):
        call()


def test_scene_twin_carries_threads():
    """interop keeps the reference's stackless threads (dfs_next/dfs_skip)."""
    js = tt.scenes.random_triangles(300, seed=3, accelerator=tt.Accelerator.BVH)
    ts = interop.scene_from_numpy(flatten(js), device=CPU)
    for f in ("dfs_next", "dfs_skip"):
        np.testing.assert_array_equal(getattr(ts.bvh, f).numpy(), np.asarray(getattr(js.bvh, f)))
