"""The plain reference against the program's CPU path at small sizes, and
the reference's independence: it runs with the program, the JAX package
and JAX all unimportable. The whole cells on the card are in
``test_cells_on_the_card``."""
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import pathtrace, train
from benchmark.scenes import cornell, courtyard
from benchmark.tests.helpers import ROOT, SMALL_COURTYARD
from benchmark.traffic import inverse_steps, render_passes

SEED = 2 ** 32 + 77


class Ctx:
    def __init__(self, name, arrays, params, seed=SEED):
        self.config = harness.read_json(os.path.join(ROOT, "benchmark", "configs", f"{name}.json"))
        self.arrays, self.params, self.seed, self.device = arrays, params, seed, "cpu"
        self.facts, self.counters = {}, {}


def _mix(name, **over):
    return dict(harness.read_json(os.path.join(ROOT, "benchmark", "traffic",
                                               f"{name}.json"))["params"], **over)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name,arrays,mix", [
    ("courtyard", lambda: courtyard.generate(SMALL_COURTYARD), "preview_384_8spp"),
    ("courtyard", lambda: courtyard.generate(SMALL_COURTYARD), "preview_384_8spp_sky"),
    ("cornell", lambda: cornell.generate({"wall_bsdf": "ggx", "light_emission": 15.0}),
     "validation_512_16spp_mis"),
])
def test_passes_match_the_program_bit_for_bit(name, arrays, mix):
    """Three progressive passes of the program on the CPU and the
    reference's film at every pixel after each: equal words."""
    ctx = Ctx(name, arrays(), _mix(mix, width=12, height=10))
    scene = render_passes._program_scene(ctx)
    cam, opts = render_passes.camera(ctx), render_passes.options(ctx)
    render = importlib.import_module("terra_tpu_torch.render").render
    develop = importlib.import_module("terra_tpu_torch.film").develop
    film, imgs = None, []
    seeds = [render_passes.pass_seed(SEED, i) for i in range(3)]
    for s in seeds:
        film = render(scene, cam, opts, seed=s, film=film)
        imgs.append(develop(film).numpy().reshape(-1, 3))
    rs = pathtrace.Scene(ctx.arrays, "cpu", ctx.config["accelerator"])
    out = pathtrace.film_values(rs, render_passes.reference_opts(ctx), ctx.config["camera"],
                                seeds, torch.arange(120), int(ctx.params["spp"]), {0, 1, 2})
    for j in range(3):
        assert np.array_equal(out[j].numpy(), imgs[j])
    ctl = pathtrace.film_values(pathtrace.Scene(ctx.arrays, "cpu", ctx.config["accelerator"],
                                                tf32=True), render_passes.reference_opts(ctx),
                                ctx.config["camera"], seeds, torch.arange(120),
                                int(ctx.params["spp"]), {2})
    assert not np.array_equal(ctl[2].numpy(), imgs[2])


def test_train_step_matches_the_program():
    """The first step's loss and gradient of the program's step against
    the reference's."""
    optim = importlib.import_module("terra_tpu_torch.optim")
    rng = importlib.import_module("terra_tpu_torch.ops.rng")
    ctx = Ctx("courtyard", courtyard.generate(SMALL_COURTYARD),
              _mix("inverse_384_8spp", width=10, height=8))
    start, target = inverse_steps.start_arrays(ctx)
    ctx.arrays = start
    scene = render_passes._program_scene(ctx)
    cam, opts = render_passes.camera(ctx), render_passes.options(ctx)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              optim.extract_params(scene, tuple(ctx.params["fields"])).items()}
    loss_fn = optim.make_loss_fn(cam, opts, torch.as_tensor(target))
    key = rng.key_from_seed(SEED)
    loss, grads = optim.value_and_grad(loss_fn, params, scene, key, 0)
    ref_loss, ref_g = train.loss_and_grads(
        start, "bvh", {k: v.detach() for k, v in params.items()},
        render_passes.reference_opts(ctx) | {"spp": 8}, ctx.config["camera"], key, 0,
        torch.as_tensor(target))
    assert abs(float(loss) - ref_loss) <= 1e-6 * abs(ref_loss)
    names = {id(v): k for k, v in params.items()}
    for leaf, g in zip(optim.tree_leaves(params), grads):
        k = names[id(leaf)]
        assert torch.allclose(g, ref_g[k], rtol=1e-4, atol=1e-6 * float(ref_g[k].abs().max())), k


def test_tree_boxes_bound_their_triangles():
    arrays = courtyard.generate(SMALL_COURTYARD)
    tris = arrays["positions"][arrays["tri_vidx"]]
    bvh = pathtrace.Bvh(tris, "cpu")
    nodes = bvh.left.numpy()
    leaf = nodes < 0
    tri = bvh.leaf_tris.numpy()
    for n in np.nonzero(leaf)[0][:50]:
        t = tri[n][tri[n] >= 0]
        assert np.all(bvh.bmin.numpy()[n] <= tris[t].min(axis=(0, 1)))
        assert np.all(bvh.bmax.numpy()[n] >= tris[t].max(axis=(0, 1)))
    held = np.sort(tri[leaf][tri[leaf] >= 0])
    assert np.array_equal(held, np.arange(len(tris)))


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('terra_tpu', 'terra_tpu_torch', 'jax', 'jaxlib', 'flax'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def test_reference_imports_nothing_of_the_program():
    """The reference's modules and a render through them, with the program,
    the JAX package and JAX unimportable."""
    code = BLOCKER + (
        "import torch, json\n"
        "from benchmark.reference import pathtrace, train\n"
        "from benchmark.scenes import cornell\n"
        "a = cornell.generate({'wall_bsdf': 'ggx', 'light_emission': 15.0})\n"
        "s = pathtrace.Scene(a, 'cpu', 'brute')\n"
        "cam = {'position': [278.0, 273.0, -800.0], 'direction': [0.0, 0.0, 1.0],"
        " 'up': [0.0, 1.0, 0.0], 'fov_deg': 39.3}\n"
        "o = dict(width=8, height=8, bounces=2, integrator='direct_mis', subpixel_jitter=0.5)\n"
        "v = pathtrace.film_values(s, o, cam, [1, 2], torch.arange(64), 4, {1})\n"
        "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules"
        " if m.split('.')[0].startswith(('terra', 'jax', 'flax')))), float(v[1].sum()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    mods, total = p.stdout.split()[-2:]
    assert json.loads(mods) == [] and float(total) > 0


def test_reference_sources_import_nothing_of_the_program():
    import ast

    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, f)).read())
            for node in ast.walk(tree):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else []
                for n in names:
                    assert n.split(".")[0] not in ("terra_tpu", "terra_tpu_torch", "jax",
                                                   "jaxlib", "flax"), (f, n)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["courtyard.render", "courtyard.inverse", "cornell.render"])
def test_cells_on_the_card(cell):
    """Each cell as committed, a short window, on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run(cell, SEED, 2.0, False, log=io.StringIO())
    assert r["correct"] is True, r["checks"]
