"""The row gathers' backward (``ops/row_accumulate.py``): the plain
version against ``index_add_`` into zeros within reassociation (a long run
on row 0, rows no lane names, one-lane rows, runs cut at tile boundaries;
26-, 3- and 1-column tables), its bits over two calls, the sign of zero,
:class:`RowGather`'s gradient against ``jax.grad`` of ``jnp.take`` (on the
CPU and on the card), and ``gather`` without a gradient giving
``table[idx]``'s words with no node. Tests marked ``cuda`` hold the kernel
(``csrc/row_accumulate.cu``) to ``jax.grad`` and to the plain version word
for word on the card; they skip without a CUDA device."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from terra_tpu_torch.ops import row_accumulate as ra

TILE = ra.TILE
GRAD_RTOL = 1e-6  # tests/test_torch_fetch.py's gradient tolerance
F32_EPS = 2.0 ** -24


def _ids(kind, n, rows, seed):
    """(n,) int64 ids into ``rows`` rows of one of the patterns below."""
    gen = np.random.default_rng(seed)
    if kind == "random":
        return gen.integers(0, rows, n)
    if kind == "row0_run":  # 45% of the lanes on row 0, others on every third row
        ids = 3 * gen.integers(1, rows // 3, n)
        ids[gen.random(n) < 0.45] = 0
        return ids
    if kind == "one_lane_rows":  # every id named once, rows past n untouched
        return gen.permutation(rows)[:n]
    if kind == "tile_cuts":  # sorted runs of TILE - 1, TILE, TILE + 1, 3 TILE + 5, ...
        lengths = [TILE - 1, TILE, TILE + 1, 1, 3 * TILE + 5, 2, TILE // 2, 5 * TILE] * 40
        ids = np.concatenate([np.full(m, 2 * r + 1) for r, m in enumerate(lengths)])[:n]
        return gen.permutation(ids % rows)
    raise ValueError(kind)


def _grad(n, cols, seed):
    g = np.random.default_rng(seed + 1).standard_normal((n, cols)).astype(np.float32)
    g[np.random.default_rng(seed + 2).random((n, cols)) < 0.1] = -0.0
    return g


def _words(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _check_sums(got, grad, ids, rows):
    """``got`` against index_add_ in f64, within the error of any order of
    the adds (each partial sum rounds once, at most 80 deep: eight scan
    steps and one carry a level, under ten levels), untouched rows +0.0."""
    g64 = torch.from_numpy(grad).double()
    idx = torch.from_numpy(ids)
    want = torch.zeros((rows, grad.shape[1]), dtype=torch.float64).index_add_(0, idx, g64)
    mag = torch.zeros_like(want).index_add_(0, idx, g64.abs())
    err = (torch.from_numpy(got).double() - want).abs()
    assert bool((err <= 80 * F32_EPS * mag).all()), float((err / mag.clamp(min=1e-30)).max())
    untouched = np.ones(rows, bool)
    untouched[ids] = False
    assert (_words(got[untouched]) == 0).all()


@pytest.mark.parametrize("cols", [26, 3, 1])
@pytest.mark.parametrize("kind, n, rows", [
    ("random", 70001, 5000), ("row0_run", 70001, 241764), ("one_lane_rows", 4099, 9000),
    ("tile_cuts", 30000, 100000), ("random", 200, 3), ("row0_run", TILE * 40, 600)])
def test_plain_sums_match_index_add(kind, n, rows, cols):
    ids = _ids(kind, n, rows, n + cols)
    grad = _grad(n, cols, n)
    got = ra.row_accumulate(torch.from_numpy(grad), torch.from_numpy(ids), rows).numpy()
    assert got.shape == (rows, cols)
    _check_sums(got, grad, ids, rows)


def test_bits_repeat_over_two_calls():
    ids = torch.from_numpy(_ids("row0_run", 70001, 241764, 5))
    grad = torch.from_numpy(_grad(70001, 26, 6))
    a = ra.row_accumulate(grad, ids, 241764).numpy()
    b = ra.row_accumulate(grad.clone(), ids.clone(), 241764).numpy()
    np.testing.assert_array_equal(_words(a), _words(b))


def test_negative_zero_rows_read_positive_zero():
    """A row reached only by -0.0 (a run of three tiles, cut twice, and a
    run of one lane) and a row no lane names read +0.0; a row of -0.0 and
    one 2.5 reads 2.5."""
    n = 3 * TILE + 7
    ids = np.full(n, 4)
    ids[:2] = (1, 7)
    ids[2:5] = 9
    grad = np.full((n, 3), -0.0, np.float32)
    grad[3, 1] = 2.5
    got = ra.row_accumulate(torch.from_numpy(grad), torch.from_numpy(ids), 12).numpy()
    want = np.zeros((12, 3), np.float32)
    want[9, 1] = 2.5
    np.testing.assert_array_equal(_words(got), _words(want))


def test_level_sizes():
    assert ra.level_sizes(0) == [0] and ra.level_sizes(TILE) == [TILE]
    assert ra.level_sizes(TILE + 1) == [TILE + 1, 4]
    assert ra.level_sizes(384 * 384 * 8) == [1179648, 9216, 72]


def test_ids_outside_the_rows_raise():
    grad = torch.ones((3, 2))
    for ids in ([0, 1, 5], [-1, 0, 1]):
        with pytest.raises(ValueError, match="outside"):
            ra.row_accumulate(grad, torch.tensor(ids), 5)


def test_neither_cpu_nor_cuda_raises_before_any_build(monkeypatch):
    """The kernel's wrapper refuses what it does not take before it builds
    or loads the library; the CPU path never loads it."""
    def no_build():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(ra, "load_kernel", no_build)
    before = ra.launches
    with pytest.raises(ValueError, match="CUDA gradient"):
        ra.row_accumulate(torch.ones((4, 2), device="meta"), torch.zeros(4, dtype=torch.long,
                                                                         device="meta"), 3)
    ra.row_accumulate(torch.ones((4, 2)), torch.zeros(4, dtype=torch.long), 3)
    assert ra.launches == before


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("shape, n, kind", [
    ((513, 26), 2048, "random"), ((4096, 3), 70001, "random"), ((9000,), 3000, "random"),
    ((700, 3, 3), 5000, "random"), ((241764, 26), 384 * 384 * 8, "row0_run")])
def test_gradient_matches_jax(shape, n, kind, device, request):
    """d sum(w * gather(table, idx)) / d table against jax.grad of jnp.take,
    on the CPU (the plain version) and on the card (the kernel; skips
    without a CUDA device). Random ids as in test_torch_fetch.py: short
    runs, normal weights, where the two orders of the adds agree to its
    tolerance. The main path's shape (1,179,648 lanes into the 241,764 x 26
    triangle table, 45% of them on row 0): weights are small integers, so
    every partial sum of the long run is exact in f32 and any order of the
    adds gives the same words."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    gen = np.random.default_rng(n)
    table = gen.standard_normal(shape).astype(np.float32)
    idx = _ids(kind, n, shape[0], n)
    if kind == "random":
        w = gen.standard_normal((n, *shape[1:])).astype(np.float32)
    else:
        w = gen.integers(-3, 4, (n, *shape[1:])).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(w * jnp.take(t, jnp.asarray(idx), axis=0)))(
        jnp.asarray(table)))
    t = torch.from_numpy(table).to(device).requires_grad_(True)
    out = ra.gather(t, torch.from_numpy(idx).to(device))
    assert type(out.grad_fn).__name__ == "RowGatherBackward"
    assert out.grad_fn.table_shape == shape
    before = ra.launches
    torch.sum(torch.from_numpy(w).to(device) * out).backward()
    assert ra.launches - before == (len(ra.level_sizes(n)) if device == "cuda" else 0)
    got = t.grad.cpu().numpy()
    scale = np.abs(want).max()
    assert scale > 0 and got.shape == shape
    assert np.abs(got - want).max() <= GRAD_RTOL * scale
    if kind == "row0_run":
        np.testing.assert_array_equal(_words(got), _words(want))


@pytest.mark.parametrize("mode", ["no_grad", "frozen_table", "grad"])
def test_gather_words_and_node(mode):
    """The forward is table[idx] word for word; without a gradient the
    Function records no node of its own in the graph."""
    table = torch.from_numpy(np.random.default_rng(1).standard_normal((600, 26))
                             .astype(np.float32))
    idx = torch.from_numpy(_ids("random", 5000, 600, 2))
    if mode != "frozen_table":
        table.requires_grad_(True)
    with torch.set_grad_enabled(mode != "no_grad"):
        got = ra.gather(table, idx)
        want = table[idx]
    np.testing.assert_array_equal(_words(got.detach()), _words(want.detach()))
    name = type(got.grad_fn).__name__ if got.grad_fn is not None else None
    assert name == ("RowGatherBackward" if mode == "grad" else None)


# --- the kernel on the card, word for word against the plain version.
# Marked ``cuda``: each skips without a CUDA device (decided in the fixture).


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row-accumulate kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [26, 3, 1, 33, 70])
@pytest.mark.parametrize("kind, n, rows", [
    ("random", 70001, 5000), ("row0_run", 300000, 241764), ("one_lane_rows", 4099, 9000),
    ("tile_cuts", 30000, 100000), ("random", 1, 3), ("random", TILE, 50),
    ("random", TILE + 1, 50)])
def test_kernel_matches_plain(cuda, kind, n, rows, cols):
    ids = _ids(kind, n, rows, n + cols)
    grad = _grad(n, cols, n)
    want = ra.row_accumulate(torch.from_numpy(grad), torch.from_numpy(ids), rows).numpy()
    g, i = torch.from_numpy(grad).to(cuda), torch.from_numpy(ids).to(cuda)
    before = ra.launches
    a = ra.row_accumulate(g, i, rows)
    b = ra.row_accumulate(g, i.to(torch.int32), rows)
    torch.cuda.synchronize()
    assert ra.launches - before == 2 * len(ra.level_sizes(n))
    np.testing.assert_array_equal(_words(a.cpu().numpy()), _words(want))
    np.testing.assert_array_equal(_words(b.cpu().numpy()), _words(want))


@pytest.mark.cuda
def test_kernel_gradient_in_a_captured_graph(cuda):
    """RowGather's backward captured in a CUDA graph, replayed after the
    gradient's values change, gives the plain version's words."""
    from terra_tpu_torch import graphs

    rows, n = 241764, 1 << 17
    ids = torch.from_numpy(_ids("row0_run", n, rows, 3)).to(cuda)
    table = torch.zeros((rows, 26), device=cuda, requires_grad=True)
    w = torch.from_numpy(_grad(n, 26, 4)).to(cuda)
    torch.sum(w * ra.gather(table, ids)).backward()  # warm-up: builds and loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    table.grad = None
    with graphs._taken_back() as counts, torch.cuda.graph(graph):
        grad, = torch.autograd.grad(torch.sum(w * ra.gather(table, ids)), table)
    assert counts == [0, 0, 0, len(ra.level_sizes(n))]
    for seed in (5, 6):
        w.copy_(torch.from_numpy(_grad(n, 26, seed)))
        graph.replay()
        want = ra.row_accumulate_plain(w.cpu(), ids.cpu(), rows)
        np.testing.assert_array_equal(_words(grad.cpu().numpy()), _words(want.numpy()))
