"""The port's training units (``optim.make_train_step``,
``make_train_step_sharded``, ``make_grad_fn_sharded`` on
``graphs.TrainUnit``) and their capture-safe bodies, on the CPU.

The step body with a tensor key and a device-scalar sample offset against
the eager ``optim.value_and_grad`` bit for bit, per parameter group;
three steps against ``terra_tpu.optim.make_train_step`` with
``optax.adam``; a JAX training state resumed, through a checkpoint file,
into the step; a positions ``recover`` on a BVH scene that builds one body
and reads freshly packed tables after every in-place refit; the sharded
body on 2 gloo ranks against a straightforward eager sharded gradient;
the keys of the unit cache; and the launch bookkeeping of a replay with a
stub graph.

    python tests/test_torch_train_units.py <host:port> <rank> <ranks> <out.npz>
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a rank script
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import terra_tpu as tt  # noqa: E402
import terra_tpu_torch as ttt  # noqa: E402
from terra_tpu import checkpoint as jckpt  # noqa: E402
from terra_tpu import optim as joptim  # noqa: E402
from terra_tpu_torch import graphs, interop, optim  # noqa: E402
from terra_tpu_torch.accel import lbvh  # noqa: E402
from terra_tpu_torch.accel import pallas_traverse as tpt  # noqa: E402
from terra_tpu_torch.checkpoint import load_pytree, tree_leaves  # noqa: E402
from terra_tpu_torch.ops import rng  # noqa: E402
from terra_tpu_torch.render import _set_inputs  # noqa: E402
from tests.test_torch_bsdf import torch_one_thread  # noqa: E402,F401 (autouse fixture)
from tests.test_torch_grad import _config4, _jkey, _twin_case  # noqa: E402

CPU = "cpu"
ADAM = functools.partial(torch.optim.Adam, lr=3e-2)


def _bits(a, b) -> bool:
    """Two f32 tensors hold the same bits."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.fixture(autouse=True)
def fresh_units():
    graphs.clear()
    yield
    graphs.clear()


@pytest.mark.parametrize("field", ["attrs", "emissive", "positions", "textures", "camera"])
def test_step_body_matches_value_and_grad(field):
    """The capture-safe step body, its key a (2,) int64 tensor and its
    sample offset a 0-d tensor in the input buffer, against the eager
    value_and_grad at the same offset: the loss and every gradient array
    bit for bit (the same ops in deterministic mode)."""
    _, scene, _, cam, _, opts = _twin_case(field)
    spp = opts.samples_per_pixel
    with torch.no_grad():
        target = 0.5 * optim.render_mean_image(scene, cam, opts, rng.key_from_seed(1), 0, spp)
    loss_fn = optim.make_loss_fn(cam, opts, target)
    p0 = optim.extract_params(scene, (field,), cam=cam)
    loss_e, grads_e = optim.value_and_grad(loss_fn, optim._trainable(p0), scene,
                                           rng.key_from_seed(0), 8)
    params = optim._trainable(p0)
    body = optim._StepBody(scene, cam, opts, target, spp, params, ADAM(tree_leaves(params)))
    _set_inputs(body.inputs, torch.tensor(rng.key_from_seed(0), dtype=torch.int64),
                torch.tensor(8))
    assert body.inputs.tolist() == [*rng.key_from_seed(0), 8]
    loss = body.replay("forward")
    grads = body.replay("backward")
    assert _bits(loss, loss_e)
    assert len(grads) == len(grads_e) and all(_bits(a, b) for a, b in zip(grads, grads_e))
    assert all(p.grad is g for p, g in zip(tree_leaves(params), grads))


def test_three_steps_match_optax():
    """Three make_train_step steps with torch.optim.Adam against three of
    terra_tpu.optim.make_train_step with optax.adam from the same start:
    the loss of every step and the final parameters within rtol 1e-5
    (test_torch_grad.py::test_train_step_matches_optax's tolerance)."""
    js, jc, jo = _config4(tt)
    ts, tc, to = _config4(ttt, device=CPU)
    target = joptim.render_mean_image(js, jc, jo, _jkey(7), jnp.int32(0), 8)
    field = "attrs"
    start = np.asarray(js.materials.attrs).copy()
    start[0, 0] = [0.3, 0.5, 0.6]
    jp = {field: jnp.asarray(start)}
    jopt = optax.adam(3e-2)
    jstate = joptim.TrainState(jp, jopt.init(jp), jnp.int32(0))
    jstep = joptim.make_train_step(jc, jo, target, jopt)
    state = optim.TrainState({field: torch.as_tensor(start)}, None, 0)
    step = optim.make_train_step(tc, to, torch.as_tensor(np.array(target)), ADAM)
    for _ in range(3):
        jstate, jloss = jstep(jstate, js, _jkey())
        state, loss = step(state, ts, rng.key_from_seed(0))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(state.params[field].detach().numpy(),
                               np.asarray(jstate.params[field]), rtol=1e-5, atol=1e-7)
    assert state.step == 3


def test_jax_train_state_resumes_into_step(tmp_path):
    """Two optax steps in terra_tpu, the TrainState written by
    terra_tpu.checkpoint.save_pytree, read back by the port's load_pytree
    into interop.adam_state_from_numpy (the step counter on the
    parameters' device), then two steps on each side: the same
    parameters within rtol 1e-5."""
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
    path = str(tmp_path / "train_state.npz")
    jckpt.save_pytree(path, jstate)
    like = jax.tree_util.tree_map(lambda x: torch.zeros(np.shape(x)), jstate)
    back = load_pytree(path, like)
    adam = back.opt_state[0]  # optax.adam = chain(scale_by_adam, scale_by_learning_rate)
    params = optim._trainable(back.params)
    opt = interop.adam_state_from_numpy(
        {"count": adam.count.numpy(), "mu": {k: v.numpy() for k, v in adam.mu.items()},
         "nu": {k: v.numpy() for k, v in adam.nu.items()}}, params, lr=3e-2)
    p = tree_leaves(params)[0]
    assert opt.state[p]["step"].device == p.device and float(opt.state[p]["step"]) == 2.0
    assert opt.param_groups[0]["capturable"] is False  # CPU parameters
    state = optim.TrainState(params, opt, int(back.step))
    step = optim.make_train_step(tc, to, torch.as_tensor(np.array(target)), None)
    for _ in range(2):
        jstate, _ = jstep(jstate, js, _jkey())
        state, _ = step(state, ts, rng.key_from_seed(0))
    np.testing.assert_allclose(state.params["attrs"].detach().numpy(),
                               np.asarray(jstate.params["attrs"]), rtol=1e-5, atol=1e-7)
    assert state.step == 4 and len(graphs._TRAIN_UNITS) == 1


def test_capturable_keeps_cpu_optimisers():
    """optim._capturable leaves an optimiser of CPU tensors as it was (a
    capturable step needs a CUDA device) and keeps a counter on its
    parameter's device."""
    p = torch.zeros(3, requires_grad=True)
    opt = optim._capturable(ADAM([p]))
    assert opt.param_groups[0]["capturable"] is False
    p.grad = torch.ones(3)
    opt.step()
    assert optim._capturable(opt).state[p]["step"].device == p.device


def _bvh_case():
    """A BVH Cornell box whose loss moves the vertices (as
    test_torch_grad.py::test_recover_refits_moved_vertices sets it up)."""
    scene = ttt.scenes.cornell_box(with_blocks=False, accelerator=ttt.Accelerator.BVH,
                                   device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(width=8, height=8, samples_per_pixel=2, bounces=1,
                             integrator=ttt.Integrator.DIRECT, rr_start_bounce=8)
    with torch.no_grad():
        target = 0.5 * optim.render_mean_image(scene, cam, opts, rng.key_from_seed(0), 0, 2)
    return scene, cam, opts, target


def test_recover_positions_reads_refit_tables(monkeypatch):
    """recover on positions, 3 steps: one step body for the run, the
    caller's tree left as it was, and the tables every forward after the
    first packs from the tree refit in place equal tables freshly packed
    (pack_tables_auto) from a fresh refit of the caller's tree to the
    positions of the step before."""
    scene, cam, opts, target = _bvh_case()
    boxes0 = scene.bvh.node_min.clone()
    real_pack, real_init = tpt.pack_tables_auto, optim._StepBody.__init__
    packed, bodies, refits = [], [], []

    def pack(bvh, *corners):
        tables = real_pack(bvh, *corners)
        packed.append(tables)
        return tables

    def init(self, *a, **k):
        bodies.append(self)
        real_init(self, *a, **k)

    real_refit = lbvh.refit_

    def refit_(bvh, geometry):
        refits.append(geometry.positions.detach().clone())
        return real_refit(bvh, geometry)

    monkeypatch.setattr(tpt, "pack_tables_auto", pack)
    monkeypatch.setattr(optim._StepBody, "__init__", init)
    monkeypatch.setattr(lbvh, "refit_", refit_)
    recovered, losses = optim.recover(scene, cam, opts, target, fields=("positions",), steps=3,
                                      learning_rate=1.0, seed=5)
    assert np.isfinite(losses).all() and len(bodies) == 1 and len(refits) == 3
    assert torch.equal(scene.bvh.node_min, boxes0)  # the caller's tree
    assert torch.equal(recovered.geometry.positions, refits[-1])
    assert not torch.equal(refits[-1], scene.geometry.positions)
    per_forward = len(packed) // 3
    assert per_forward >= 1 and len(packed) == 3 * per_forward
    for k in (1, 2):
        geom = dataclasses.replace(scene.geometry, positions=refits[k - 1])
        fresh = real_pack(lbvh.refit(scene.bvh, geom), *geom.corners())
        got = packed[k * per_forward]
        for f in dataclasses.fields(fresh):
            a, b = getattr(got, f.name), getattr(fresh, f.name)
            assert (torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b), f.name
    final = lbvh.refit(scene.bvh, recovered.geometry)
    assert torch.equal(recovered.bvh.node_min, final.node_min)


def test_train_unit_keys(monkeypatch):
    """What makes a new training unit: another target, other fields (a new
    optimiser), other options; what does not: an Adam step, clipping in
    place, an in-place refit of the tree's boxes. Another scene tensor
    changed in place does."""
    scene, cam, opts, target = _bvh_case()
    bodies = []
    real_init = optim._StepBody.__init__
    monkeypatch.setattr(optim._StepBody, "__init__",
                        lambda self, *a, **k: bodies.append(1) or real_init(self, *a, **k))
    key = rng.key_from_seed(0)

    def run(step, state, n=1):
        for _ in range(n):
            state, _ = step(state, scene, key)
        return state

    step = optim.make_train_step(cam, opts, target, ADAM)
    state = run(step, optim.TrainState(optim.extract_params(scene, ("attrs",)), None, 0), 2)
    assert len(bodies) == 1
    with torch.no_grad():
        state.params["attrs"].clamp_(min=0.0)
    lbvh.refit_(scene.bvh, scene.geometry)  # in place: the same boxes, a new version
    state = run(step, state)
    assert len(bodies) == 1
    run(optim.make_train_step(cam, opts, target * 0.5, ADAM), state)
    assert len(bodies) == 2
    run(optim.make_train_step(cam, opts.replace(bounces=2), target, ADAM), state)
    assert len(bodies) == 3
    both = run(step, optim.TrainState(optim.extract_params(scene, ("attrs", "emissive")),
                                      None, 0))
    assert len(bodies) == 4
    run(step, both)
    assert len(bodies) == 4
    scene.materials.ior.add_(0.0)  # a tensor the graphs bake in, changed in place
    both = run(step, both)
    assert len(bodies) == 5
    opt = both.opt_state
    opt.load_state_dict(opt.state_dict())  # a new state table: new tensors to read
    run(step, both)
    assert len(bodies) == 6


def test_port_optimizer_state_resumes_into_step(tmp_path):
    """Two steps, the optimiser's state written with save_pytree and read
    back into a new torch.optim.Adam over copies of the parameters, then
    two more steps from each: the same parameter bits."""
    from terra_tpu_torch.checkpoint import save_pytree

    scene, cam, opts = _config4(ttt, device=CPU)
    with torch.no_grad():
        target = optim.render_mean_image(scene, cam, opts, rng.key_from_seed(7), 0, 8)
    attrs = scene.materials.attrs.clone()
    attrs[0, 0] = torch.tensor([0.3, 0.5, 0.6])
    step = optim.make_train_step(cam, opts, target, ADAM)
    key = rng.key_from_seed(0)
    state = optim.TrainState({"attrs": attrs}, None, 0)
    for _ in range(2):
        state, _ = step(state, scene, key)
    path = str(tmp_path / "adam.npz")
    saved = state.opt_state.state_dict()
    save_pytree(path, saved["state"])
    like = {i: {k: torch.zeros_like(v) for k, v in s.items()} for i, s in saved["state"].items()}
    params = optim._trainable(state.params)
    opt = ADAM(tree_leaves(params))
    opt.load_state_dict({"state": load_pytree(path, like), "param_groups": saved["param_groups"]})
    resumed = optim.TrainState(params, opt, state.step)
    for _ in range(2):
        state, _ = step(state, scene, key)
        resumed, _ = step(resumed, scene, key)
    assert _bits(resumed.params["attrs"].detach(), state.params["attrs"].detach())


def test_watched_objects_are_fingerprinted_by_identity():
    """WeakCache.get's fingerprint: watched tensors by identity (written
    in place: a hit; replaced: a miss), moving owner tensors likewise,
    other owner tensors by version too."""
    cache = graphs.WeakCache(4)
    scene, cam, _, _ = _bvh_case()
    group = {"params": [torch.zeros(3)], "lr": 0.1}
    made = []

    def get():
        return cache.get((scene, cam), "k", lambda: made.append(1) or len(made),
                         moving=(scene.bvh.node_min,), watch=[group])

    assert get() == 1 and get() == 1
    group["params"][0].add_(1.0)
    scene.bvh.node_min.add_(0.0)
    assert get() == 1
    group["lr"] = 0.2  # a setting the graphs bake in
    assert get() == 2
    group["params"][0] = group["params"][0].clone()
    assert get() == 3
    scene.bvh.node_max.add_(0.0)  # not moving: its version counts
    assert get() == 4


# --- the sharded body on 2 gloo ranks ----------------------------------------

SHARD_OPTS = dict(width=8, height=8, samples_per_pixel=8, bounces=1)


def _eager_sharded(cam, opts, target, mesh, params, scene, key, offset, chunks):
    """The sharded gradient written out eagerly (the form before training
    units): per-chunk forwards, their band sum all-reduced over the sample
    group, the loss over the row group, each chunk's backward against the
    shared cotangent and its gradient all-reduced right after it."""
    from terra_tpu_torch.parallel.mesh import shard_sizes
    from terra_tpu_torch.render import render_rows

    spp = opts.samples_per_pixel
    rows_per, spp_per = shard_sizes(mesh, opts.height, spp)
    sub = spp_per // chunks
    denom = float(opts.width * opts.height * 3)
    row0 = mesh.row * rows_per
    tgt = target[row0:row0 + rows_per]
    leaves = tree_leaves(params)
    base = offset + mesh.sample * spp_per
    with optim.deterministic():
        accs = [render_rows(optim.inject_params(scene, params), cam, opts, key, base + i * sub,
                            sub, row0, rows_per) for i in range(chunks)]
        acc = accs[0].detach().clone()
        for a in accs[1:]:
            acc = acc + a.detach()
        img = mesh.all_reduce(acc, "samples") / float(spp)
        loss = mesh.all_reduce((torch.sum((img - tgt) ** 2) / denom).reshape(1), "rows")[0]
        cot = 2.0 * (img - tgt) / (denom * float(spp))
        grads = None
        for a in accs:
            g = optim._grads(a, leaves, cot)
            flat = mesh.all_reduce(torch.cat([x.reshape(-1) for x in g]))
            g = [x.reshape(p.shape) for p, x in
                 zip(leaves, torch.split(flat, [x.numel() for x in g]))]
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
    return loss.detach(), grads


def _worker(coord: str, rank: str, nproc: str, out: str) -> None:
    """One rank: make_grad_fn_sharded (grad_chunks 2) twice against the
    eager form at mesh (1, 2), then two make_train_step_sharded steps
    against the eager form and Adam."""
    from terra_tpu_torch.parallel import distributed
    from terra_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    distributed.initialize(coord, int(nproc), int(rank), device=CPU)
    mesh = make_mesh((1, 2), device=CPU)
    scene = ttt.scenes.cornell_box(device=CPU)
    cam = ttt.scenes.cornell_camera(device=CPU)
    opts = ttt.RenderOptions(**SHARD_OPTS, integrator=ttt.Integrator.DIRECT)
    with torch.no_grad():
        target = 0.5 * optim.render_mean_image(scene, cam, opts, rng.key_from_seed(1), 0, 8)
    key = rng.key_from_seed(3)
    params = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
    gf = optim.make_grad_fn_sharded(cam, opts, target, mesh, grad_chunks=2)
    res = {}
    for i, offset in enumerate((0, 8)):
        loss, grads = gf(params, scene, key, offset)
        loss_e, grads_e = _eager_sharded(cam, opts, target, mesh, params, scene, key, offset, 2)
        res[f"grads_bits_{i}"] = np.array(
            [_bits(loss, loss_e)] + [_bits(g, e) for g, e in zip(tree_leaves(grads), grads_e)])
    step = optim.make_train_step_sharded(cam, opts, target, ADAM, mesh, grad_chunks=2)
    state = optim.TrainState(optim.extract_params(scene, ("attrs", "emissive")), None, 0)
    ref = optim._trainable(optim.extract_params(scene, ("attrs", "emissive")))
    ref_opt = ADAM(tree_leaves(ref))
    losses = []
    for i in range(2):
        state, loss = step(state, scene, key)
        loss_e, grads_e = _eager_sharded(cam, opts, target, mesh, ref, scene, key, i * 8, 2)
        for p, g in zip(tree_leaves(ref), grads_e):
            p.grad = g
        ref_opt.step()
        losses.append([float(loss), float(loss_e)])
    res["step_bits"] = np.array([_bits(a.detach(), b.detach())
                                 for a, b in zip(tree_leaves(state.params), tree_leaves(ref))])
    res["losses"] = np.array(losses)
    res["units"] = np.array(len(graphs._TRAIN_UNITS))
    for k, p in state.params.items():
        res[f"param_{k}"] = p.detach().numpy()
    np.savez(out.replace(".npz", f"_{rank}.npz"), **res)


def test_sharded_body_matches_eager_on_two_ranks(tmp_path):
    """On 2 gloo ranks at mesh (1, 2), grad_chunks 2: make_grad_fn_sharded
    (the staged body, replayed with the collectives between stages) equals
    the eager sharded gradient bit for bit at two offsets, on one cached
    unit; two make_train_step_sharded steps equal the eager gradient and
    Adam's step bit for bit; both ranks hold the same parameter bits."""
    from tests.test_torch_sharding import run_ranks

    out = str(tmp_path / "units.npz")
    run_ranks(__file__, 2, out)
    ranks = []
    for r in range(2):
        with np.load(out.replace(".npz", f"_{r}.npz")) as z:
            ranks.append(dict(z))
    for z in ranks:
        assert z["grads_bits_0"].all() and z["grads_bits_1"].all()
        assert z["step_bits"].all()
        assert (z["losses"][:, 0] == z["losses"][:, 1]).all()
        assert int(z["units"]) == 2  # the gradient function's unit and the step's
    for k in ("param_attrs", "param_emissive"):
        assert np.array_equal(ranks[0][k].view(np.int32), ranks[1][k].view(np.int32))


if __name__ == "__main__":
    _worker(*sys.argv[1:])
