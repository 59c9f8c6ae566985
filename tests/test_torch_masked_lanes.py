"""Gradients through lanes the wavefront masks out: a lane
that missed still shades triangle 0 (the raycast's id for a miss) under
its own ray, and ``torch.where`` drops its radiance and throughput, but
the backward multiplies its 0 gradient by every factor it formed, so one
infinite factor (0 × inf) would make a whole gradient NaN. Where autograd
records, such a lane shades a finite stand-in surface and continues
with finite factors (``surface.surface_init``'s and ``render._continue``'s
``live``). Held here: ``_continue`` on planted infinite factors; eager
training steps on a small courtyard whose missed lanes meet a zero
interpolated normal (without the stand-in their first step turns every
parameter NaN), against the plain reference of the benchmark
(``benchmark/reference/train.py``) and ``jax.grad``."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import terra_tpu as tt
from terra_tpu import optim as joptim
from terra_tpu.ops import rng as jrng
import terra_tpu_torch as ttt
from terra_tpu_torch import bsdf, optim, surface
from terra_tpu_torch.ops import rng as rng_mod
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)

render_mod = importlib.import_module("terra_tpu_torch.render")
camera_mod = importlib.import_module("terra_tpu_torch.camera")

SEED = 3000000006
SMALL_COURTYARD = dict(grid=6, columns=4, column_segments=6, column_levels=2, tex_res=8)
# triangle 0 shrunk to a horizontal triangle of edge 2e-5 far below the
# terrain: a missed lane's ray meets its plane thousands of units from it,
# its barycentrics pass 2^24 and the f32 interpolated normal cancels to
# exactly zero (the frame built on it is NaN), on every missed lane; at the
# benchmark's full size (384^2 x 8 spp) a few lanes in a million meet that
# on the courtyard's own triangle 0
TRAP = [[0.0, -1000.0, 0.0], [2e-5, -1000.0, 0.0], [0.0, -1000.0, 2e-5]]
FIELDS = ("attrs", "textures", "positions")


def _trapped(mod, accelerator, **kw):
    """The small courtyard of ``mod`` (the port or terra_tpu) with triangle
    0 moved to the trap."""
    scene = mod.scenes.courtyard(**SMALL_COURTYARD, accelerator=accelerator, **kw)
    g = scene.geometry
    vid = np.asarray(g.tri_vidx[0]).astype(np.int64)
    pos = np.array(g.positions, dtype=np.float32)
    assert (np.asarray(g.tri_vidx) == vid[0]).sum() == 1  # its corners are its own
    pos[vid] = TRAP
    pos = torch.as_tensor(pos) if mod is ttt else jnp.asarray(pos)
    return mod.scene.commit(dataclasses.replace(g, positions=pos), scene.materials,
                            scene.textures, accelerator=accelerator)


def _opts(mod, integrator="DIRECT", **kw):
    return mod.RenderOptions(width=12, height=12, samples_per_pixel=2, bounces=2,
                             integrator=getattr(mod.Integrator, integrator),
                             subpixel_jitter=0.5, rr_start_bounce=8, **kw)


def _target():
    return torch.rand(12, 12, 3, generator=torch.Generator().manual_seed(0))


# --- render._continue ------------------------------------------------------

def _surface_case():
    """Four lanes of a small Cornell box's first hits: (surface with its
    attrs a gradient leaf, uniforms, wo, throughput leaf, present)."""
    scene = ttt.scenes.cornell_box(device="cpu")
    cam = ttt.scenes.cornell_camera(device="cpu")
    opts = ttt.RenderOptions(width=4, height=4, samples_per_pixel=1, bounces=1,
                             integrator=ttt.Integrator.DIRECT)
    key = rng_mod.key_from_seed(SEED)
    ids = torch.tensor([5, 6, 9, 10])  # the central pixels, which see the box
    px, py = ids % 4, ids // 4
    r1, r2 = render_mod._pixel_jitter(opts, key, ids, torch.zeros_like(ids))
    o, d = camera_mod.generate_rays(cam, 4, 4, px, py, 0.5, r1, r2)
    ctx = render_mod._context(scene, opts)
    hit = ctx["raycast"](o, d)
    assert bool(hit.hit.all())
    surf = surface.surface_init(scene, ctx["tables"], o, d, hit.tri)
    surf = dataclasses.replace(surf, attrs=surf.attrs.detach().clone().requires_grad_(True))
    u = rng_mod.path_uniform_bundle(key, ids, torch.zeros_like(ids), 1,
                                    render_mod._streams_for(opts.integrator))
    tp = torch.full((4, 3), 0.5).requires_grad_(True)
    return surf, u, -d, tp, ctx["present"]


def _continue_grads(case, live, planted=None, dead=2):
    """(new throughput, d/d throughput, d/d attrs) of ``_continue`` whose
    output the caller keeps on the lanes other than ``dead`` only (as
    ``render._trace`` keeps a bounce's radiance), with ``planted`` ("f",
    "nol" or "pdf") infinite on lane ``dead``."""
    surf, u, wo, tp, present = case

    def at_dead(fn, pos=0):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            first = out[pos] if isinstance(out, tuple) else out
            first = first.clone()
            first[dead] = float("inf")
            return (first,) + out[1:] if isinstance(out, tuple) else first

        return wrapped

    mask = torch.ones(4, dtype=torch.bool)
    mask[dead] = False
    real = {name: getattr(bsdf, name) for name in ("eval_f", "pdf", "continuation_factors")}
    names = {"f": "eval_f", "pdf": "pdf", "nol": "continuation_factors"}
    try:
        if planted is not None:
            setattr(bsdf, names[planted], at_dead(real[names[planted]]))
        _, new_tp, _ = render_mod._continue(surf, u, wo, tp, present, live)
    finally:
        for name, fn in real.items():
            setattr(bsdf, name, fn)
    out = torch.where(mask[..., None], new_tp, 0.0)
    g_tp, g_attrs = torch.autograd.grad((out * torch.arange(1.0, 4.0)).sum(), [tp, surf.attrs])
    return new_tp.detach(), g_tp, g_attrs


@pytest.mark.parametrize("planted", ["f", "nol", "pdf"])
def test_continue_gives_a_masked_lane_with_an_infinite_factor_zero_gradient(planted):
    """A lane the caller masks out whose f, cosine or pdf is infinite: with
    ``live`` its gradient is finite, exactly 0 for that lane, and the live
    lanes' forward words and gradients are those of the lane set without
    the planted factor. Without ``live`` an infinite f or cosine makes
    the gradient non-finite (the fault)."""
    case = _surface_case()
    mask = torch.tensor([True, True, False, True])
    tp0, g_tp0, g_attrs0 = _continue_grads(case, None)
    tp1, g_tp1, g_attrs1 = _continue_grads(case, mask, planted)
    assert torch.isfinite(g_tp1).all() and torch.isfinite(g_attrs1).all()
    assert (g_tp1[2] == 0).all() and (g_attrs1[2] == 0).all()
    assert torch.equal(tp1[mask], tp0[mask])
    assert torch.equal(g_tp1[mask], g_tp0[mask]) and torch.equal(g_attrs1[mask], g_attrs0[mask])
    _, g_tp2, g_attrs2 = _continue_grads(case, mask)  # the guard on a lane set with no inf
    assert torch.equal(g_tp2, g_tp1) and torch.equal(g_attrs2, g_attrs1)
    if planted != "pdf":  # an infinite pdf divides to 0, which the backward survives
        _, g_tp3, _ = _continue_grads(case, None, planted)
        assert not torch.isfinite(g_tp3).all()


# --- training steps ----------------------------------------------------------

def test_the_trap_gives_missed_lanes_a_nan_frame_without_the_stand_in():
    """The case the step tests run: camera rays that miss shade triangle 0
    with a zero normal and a NaN frame, unless they take the stand-in; a
    lane that hit keeps its words."""
    scene = _trapped(ttt, ttt.Accelerator.BVH, device="cpu")
    cam = ttt.scenes.courtyard_camera(device="cpu")
    opts = _opts(ttt)
    pixel_idx, px, py, sample_idx = render_mod._lane_ids(opts, 2, 0, 0, 12, "cpu")
    key = rng_mod.key_from_seed(SEED)
    r1, r2 = render_mod._pixel_jitter(opts, key, pixel_idx, sample_idx)
    o, d = camera_mod.generate_rays(cam, 12, 12, px, py, 0.5, r1, r2)
    ctx = render_mod._context(scene, opts)
    hit = ctx["raycast"](o, d)
    missed = ~hit.hit
    assert 0 < int(missed.sum()) < len(missed)
    bare = surface.surface_init(scene, ctx["tables"], o, d, hit.tri)
    assert not torch.isfinite(bare.tangent[missed]).all()
    stood = surface.surface_init(scene, ctx["tables"], o, d, hit.tri, live=hit.hit)
    for f in dataclasses.fields(stood):
        a, b = getattr(stood, f.name), getattr(bare, f.name)
        assert torch.equal(a[hit.hit], b[hit.hit]), f.name
        if a.is_floating_point():
            assert torch.isfinite(a).all(), f.name


@pytest.mark.parametrize("integrator", ["DIRECT", "DIRECT_MIS"])
def test_eager_steps_stay_finite_with_missed_lanes_on_the_trap(integrator):
    """Three eager ``make_train_step`` steps on attrs, textures and
    positions of the trapped courtyard: every parameter stays finite and
    the loss moves (without the stand-in the first step turns every
    parameter NaN)."""
    scene = _trapped(ttt, ttt.Accelerator.BVH, device="cpu")
    cam = ttt.scenes.courtyard_camera(device="cpu")
    step = optim.make_train_step(cam, _opts(ttt, integrator), _target(),
                                 functools.partial(torch.optim.Adam, lr=0.03))
    state = optim.TrainState(optim.extract_params(scene, FIELDS), None, 0)
    key = rng_mod.key_from_seed(SEED)
    losses = []
    for _ in range(3):
        state, loss = step(state, scene, key)
        losses.append(float(loss))
        for name, p in state.params.items():
            assert torch.isfinite(p).all(), (name, len(losses))
    assert np.isfinite(losses).all() and len(set(losses)) > 1, losses


def test_steps_on_the_trap_agree_with_the_plain_reference(tmp_path):
    """The benchmark's training check on the trapped small courtyard: the
    program's first three steps (losses, first gradient, parameters'
    change, refit boxes) against ``benchmark/reference/train.py``, which
    traces live lanes only, within the small cells' limits."""
    from benchmark import harness
    from benchmark.tests.helpers import SMALL, TRAIN_CELL, small_tree

    root = small_tree(tmp_path)
    # no jitter of the start's positions, which would lift the trap's size
    ctx, traffic, _ = harness.prepare("small.inverse_pos", SEED, root, "cpu",
                                      dict(SMALL, position_jitter=0.0))
    a = ctx.arrays
    vid = a["tri_vidx"][0]
    assert (a["tri_vidx"] == vid[0]).sum() == 1
    a["positions"] = a["positions"].copy()
    a["positions"][vid] = TRAP
    traffic.setup(ctx)
    for name, v in ctx.snap["params"].items():
        assert np.isfinite(v).all(), name
    nums = traffic.numbers(ctx, ctx.snap, traffic.reference_run(ctx))
    assert set(nums) == {"loss_gap", "grad_gap", "change_gap", "box_gap"}
    for k, v in nums.items():
        assert v <= TRAIN_CELL["limits"][k], (k, v)


def test_gradient_is_finite_wherever_jax_grads_is():
    """The port's eager gradient of the loss on attrs, textures and
    positions of the trapped courtyard (brute force on both sides) is
    finite everywhere, so in every entry where ``jax.grad``'s is."""
    js = _trapped(tt, tt.Accelerator.BRUTE)
    ts = _trapped(ttt, ttt.Accelerator.BRUTE, device="cpu")
    jo, to = _opts(tt), _opts(ttt)
    target = _target()
    k0, k1 = jrng.key_from_seed(SEED)
    jparams = joptim.extract_params(js, FIELDS)
    jg = jax.grad(joptim.make_loss_fn(tt.scenes.courtyard_camera(), jo,
                                      jnp.asarray(target.numpy())))(
        jparams, js, jnp.array([k0, k1], jnp.uint32), jnp.int32(0))
    loss_fn = optim.make_loss_fn(ttt.scenes.courtyard_camera(device="cpu"), to, target)
    params = optim._trainable(optim.extract_params(ts, FIELDS))
    loss, grads = optim.value_and_grad(loss_fn, params, ts, rng_mod.key_from_seed(SEED), 0)
    assert torch.isfinite(loss)
    for name, got, ref in zip(sorted(params), grads, jax.tree_util.tree_leaves(jg)):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape, name
        assert np.isfinite(got).all(), name
        assert np.isfinite(got)[np.isfinite(ref)].all(), name
