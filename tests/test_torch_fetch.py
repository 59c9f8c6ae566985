"""The small-table fetches by one-hot product (``surface.fetch_rows``,
``distributions._oh_pick`` and ``_oh_at``) against terra_tpu's on seeded
tables of 1, 4, 29, 512 and 513 rows: values bit for bit through an int32
view (-0.0 entries and ids out of range included, which a product turns
into +0.0 and zero rows), gradients against ``jax.grad`` within 1e-6 of
the largest entry, the branch at 512 rows, the TF32 guard, and the
courtyard training graph, whose backward keeps index accumulates only on
tables of more than 512 rows."""
import collections
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from terra_tpu import surface as jsurface
from terra_tpu.ops import distributions as jdist
import terra_tpu_torch as ttt
from terra_tpu_torch import optim, surface
from terra_tpu_torch.ops import distributions, onehot, rng
from tests.test_torch_bsdf import torch_one_thread  # noqa: F401 (autouse fixture)

ROWS = [1, 4, 29, 512, 513]
N = 2048
GRAD_RTOL = 1e-6

FETCHES = {
    "fetch_rows": (surface.fetch_rows, jsurface.fetch_rows),
    "_oh_pick": (distributions._oh_pick, jdist._oh_pick),
    "_oh_at": (distributions._oh_at, jdist._oh_at),
}


def _table(shape, seed):
    """Normal entries, a fifth of them -0.0, and a first column of
    non-positive entries (where the zeros of a product are -0.0)."""
    gen = np.random.default_rng(seed)
    t = gen.standard_normal(shape).astype(np.float32)
    t[gen.random(shape) < 0.2] = -0.0
    t[..., 0] = -np.abs(t[..., 0])
    return t


def _ids(n, seed, in_range=False):
    """(N,) int32 ids into n rows; up to two out of range on either side
    where the table is fetched by product."""
    lo, hi = (0, n) if in_range or n > onehot.MAX_ROWS else (-2, n + 2)
    return np.random.default_rng(seed).integers(lo, hi, N).astype(np.int32)


def _case(fn, rows, seed, shape_2d=True):
    """(table, ids) numpy inputs of one fetch: a (rows, 26) table (or a
    (rows,) one) for the row fetches, (N, rows) lane rows for ``_oh_at``."""
    if fn == "_oh_at":
        return _table((N, rows), seed), _ids(rows, seed + 1)
    return _table((rows, 26) if shape_2d else (rows,), seed), _ids(rows, seed + 1)


def _words(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fn, shape_2d", [("fetch_rows", True), ("_oh_pick", True),
                                          ("_oh_pick", False), ("_oh_at", True)])
def test_fetch_bits_match_reference(fn, shape_2d, rows):
    table, idx = _case(fn, rows, rows, shape_2d)
    port, ref = FETCHES[fn]
    want = np.asarray(ref(jnp.asarray(table), jnp.asarray(idx)))
    got = port(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_words(got), _words(want))
    if rows <= onehot.MAX_ROWS and fn != "_oh_at":
        outside = (idx < 0) | (idx >= rows)
        assert outside.any() and (got[outside] == 0).all()


@pytest.mark.parametrize("rows", [4, 29, 512, 513])
@pytest.mark.parametrize("fn", sorted(FETCHES))
def test_fetch_gradient_matches_jax(fn, rows):
    """d sum(w * fetch(table, idx)) / d table against jax.grad."""
    table, _ = _case(fn, rows, 3 * rows)
    idx = _ids(rows, 3 * rows + 1, in_range=True)
    w = np.random.default_rng(rows).standard_normal((N, 26) if fn != "_oh_at" else N)
    w = w.astype(np.float32)
    port, ref = FETCHES[fn]
    want = np.asarray(jax.grad(lambda t: jnp.sum(w * ref(t, jnp.asarray(idx))))(
        jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    torch.sum(torch.from_numpy(w) * port(t, torch.from_numpy(idx))).backward()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(t.grad.numpy() - want).max() <= GRAD_RTOL * scale


def _graph(out):
    """(Counter of node names, Counter of the source shapes of the
    IndexBackward0 nodes) of ``out``'s backward graph."""
    seen, stack = set(), [out.grad_fn]
    names, index = collections.Counter(), collections.Counter()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names[type(node).__name__] += 1
        if type(node).__name__ == "IndexBackward0":
            index[tuple(node._saved_self_sym_sizes)] += 1
        stack.extend(f for f, _ in node.next_functions)
    return names, index


@pytest.mark.parametrize("rows, nodes", [(512, 0), (513, 1)])
def test_index_backward_only_above_512_rows(rows, nodes):
    table = torch.from_numpy(_table((rows, 26), rows)).requires_grad_(True)
    idx = torch.from_numpy(_ids(rows, 1, in_range=True))
    assert _graph(surface.fetch_rows(table, idx).sum())[0]["IndexBackward0"] == nodes


MATMUL_FLAGS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@pytest.fixture
def tf32_on():
    """TF32 allowed for float32 products on both backends, as a caller
    might set it; the flags restored after."""
    prev = [f.fp32_precision for f in MATMUL_FLAGS]
    for f in MATMUL_FLAGS:
        f.fp32_precision = "tf32"
    yield
    for f, p in zip(MATMUL_FLAGS, prev):
        f.fp32_precision = p


def _flags():
    return [f.fp32_precision for f in MATMUL_FLAGS]


def test_products_run_in_full_f32_whatever_the_flags(tf32_on, monkeypatch):
    """Inside the guard the flags say IEEE, forward and backward; outside
    they stay the caller's; the fetched bits are the reference's."""
    outside, inside, real = _flags(), [], onehot.full_f32

    @contextlib.contextmanager
    def spy():
        with real():
            inside.append(_flags())
            yield

    monkeypatch.setattr(onehot, "full_f32", spy)
    table, idx = _table((29, 26), 5), _ids(29, 6)
    t = torch.from_numpy(table).requires_grad_(True)
    got = surface.fetch_rows(t, torch.from_numpy(idx))
    got.sum().backward()
    assert inside == [["ieee", "ieee"]] * 2 and _flags() == outside == ["tf32", "tf32"]
    want = np.asarray(jsurface.fetch_rows(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(_words(got.detach().numpy()), _words(want))


def test_courtyard_training_graph_keeps_no_small_table_index():
    """Phase 6c's loss (DIRECT, 2 bounces, attrs, textures and positions)
    on a small courtyard at 32x32x2spp: the index accumulates left in its
    backward are the triangle, atlas, position and light-corner gathers
    (21 nodes), none on a table of at most 512 rows; the material and
    light tables (4 rows each) are fetched by product, once a surface."""
    scene = ttt.scenes.courtyard(grid=60, columns=8, device="cpu")
    cam = ttt.scenes.courtyard_camera(device="cpu")
    opts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=2, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             rr_start_bounce=8)
    loss_fn = optim.make_loss_fn(cam, opts, torch.zeros(32, 32, 3))
    params = optim._trainable(optim.extract_params(scene, ("attrs", "textures", "positions")))
    loss = loss_fn(params, scene, rng.key_from_seed(7), 0)
    names, index = _graph(loss)
    assert sum(index.values()) == 21, index
    assert all(shape[0] > onehot.MAX_ROWS for shape in index), index
    assert scene.materials.num_materials == 4 and scene.lights.tri_idx.shape[0] == 4
    assert names["_ProductBackward"] == 6, names
