"""The tree's refit by device (``accel/lbvh.py``: ``refit_``). CPU
positions take ``_refit_host`` (held to terra_tpu bit for bit by
tests/test_torch_lbvh.py) and count no kernel launch; edge trees (one
leaf, two, three, leaves padded by repetition) against boxes taken from
each node's subtree; the CUDA wrapper refusing what it does not take
before it builds or launches; the kernel source exporting the entry point
``load_kernel`` binds. Tests marked ``cuda`` hold the kernel
(``csrc/bvh_refit.cu``) to ``_refit_host`` on the card: the
241,764-triangle courtyard under both builders after five moves, the edge
trees, a planted NaN vertex, a captured graph, and five ``recover`` steps
whose losses equal a host refit's word for word. They skip without a CUDA
device. Nothing here is imported from ``tests`` (the card's machine has
another package of that name)."""
import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

import terra_tpu_torch as ttt
from terra_tpu_torch import graphs, optim, profile
from terra_tpu_torch.accel import lbvh

BUILDERS = ["sah", "lbvh"]
TREE_FIELDS = ("node_min", "node_max", "node_left", "node_right", "leaf_tri", "tri_order",
               "dfs_next", "dfs_skip", "wide_child", "wide_src")
# tests/test_torch_scene.py's small courtyard
SMALL_COURTYARD = dict(grid=16, columns=4, column_segments=8, column_levels=2, tex_res=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refit kernel runs only on the card")
    return torch.device("cuda")


def _device(request, name):
    return request.getfixturevalue("cuda") if name == "cuda" else torch.device("cpu")


def _moved(geometry, seed, scale=0.05):
    """``geometry`` with every vertex moved by a normal step drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    step = (torch.randn(geometry.positions.shape, generator=gen) * scale)
    return dataclasses.replace(geometry,
                               positions=geometry.positions + step.to(geometry.positions.device))


def _host_boxes(bvh, geometry):
    """The plain twin's (node_min, node_max) from host copies."""
    bmin, bmax = lbvh._refit_host(
        geometry.positions.detach().cpu().numpy(), geometry.tri_vidx.cpu().numpy(),
        bvh.leaf_tri.cpu().numpy(), bvh.node_left.cpu().numpy(), bvh.node_right.cpu().numpy())
    return torch.from_numpy(bmin), torch.from_numpy(bmax)


def _subtree_boxes(bvh, geometry):
    """Each node's box as the min and max over the corners of every slot of
    the leaves below it, found by a walk down from the node."""
    ni = bvh.num_internal
    left, right = bvh.node_left.tolist(), bvh.node_right.tolist()
    corners = geometry.positions.cpu().numpy()[geometry.tri_vidx.cpu().numpy()]  # (T, 3, 3)
    leaf_tri = bvh.leaf_tri.cpu().numpy()
    bmin = np.empty((ni + bvh.num_leaves, 3), np.float32)
    bmax = np.empty_like(bmin)
    for node in range(ni + bvh.num_leaves):
        leaves, stack = [], [node]
        while stack:
            n = stack.pop()
            if n < ni:
                stack += [left[n], right[n]]
            else:
                leaves.append(n - ni)
        pts = corners[leaf_tri[leaves].reshape(-1)].reshape(-1, 3)
        bmin[node], bmax[node] = pts.min(0), pts.max(0)
    return torch.from_numpy(bmin), torch.from_numpy(bmax)


def _refit_counted(bvh, geometry):
    """``refit`` of ``bvh`` to ``geometry`` and the kernel launches it counted."""
    before = profile.kernel_launches.copy()
    out = lbvh.refit(bvh, geometry)
    return out, profile.kernel_launches - before


@pytest.mark.parametrize("builder", BUILDERS)
def test_cpu_refit_takes_the_host_twin(builder, monkeypatch):
    """CPU positions go through ``_refit_host`` once a refit, never load the
    kernel, count no launch, and write the twin's words in place."""
    def no_build():
        raise AssertionError("the refit kernel library was loaded")

    geometry = ttt.scenes.random_triangles(333, device="cpu", seed=4).geometry
    bvh = lbvh.build(geometry, builder=builder)
    moved = _moved(geometry, 1)
    want_min, want_max = _host_boxes(bvh, moved)
    calls = []
    real = lbvh._refit_host
    monkeypatch.setattr(lbvh, "load_kernel", no_build)
    monkeypatch.setattr(lbvh, "_refit_host", lambda *a: calls.append(1) or real(*a))
    node_min = bvh.node_min
    before = profile.kernel_launches.copy()
    assert lbvh.refit_(bvh, moved) is bvh and bvh.node_min is node_min
    assert profile.kernel_launches == before and len(calls) == 1
    np.testing.assert_array_equal(bvh.node_min.numpy().view(np.int32),
                                  want_min.numpy().view(np.int32))
    np.testing.assert_array_equal(bvh.node_max.numpy().view(np.int32),
                                  want_max.numpy().view(np.int32))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("tris, inner", [(5, 0), (12, 1), (17, 2), (41, None)])
def test_edge_trees(tris, inner, builder, device, request):
    """One leaf (no internal node, the leaf is the root), two leaves, three,
    and a few, each with leaves padded by repetition: the refit's boxes
    equal each node's subtree box; on the card the kernel's also equal the
    plain twin's (a zero's sign aside) with two launches counted."""
    dev = _device(request, device)
    geometry = ttt.scenes.random_triangles(tris, device=dev, seed=tris).geometry
    bvh = lbvh.build(geometry, builder=builder)
    ni = bvh.num_internal
    assert inner is None or ni == inner
    assert bvh.num_leaves == ni + 1
    assert any(len(set(row)) < len(row) for row in bvh.leaf_tri.tolist())  # padded
    moved = _moved(geometry, tris)
    got, launches = _refit_counted(bvh, moved)
    assert launches == ({"bvh_refit": 2} if device == "cuda" else {})
    want_min, want_max = _subtree_boxes(bvh, moved)
    assert torch.equal(got.node_min.cpu(), want_min) and torch.equal(got.node_max.cpu(), want_max)
    host_min, host_max = _host_boxes(bvh, moved)
    assert torch.equal(got.node_min.cpu(), host_min) and torch.equal(got.node_max.cpu(), host_max)


def _meta_call(case):
    """A tree and a geometry on the meta device, broken as ``case`` says."""
    geometry = ttt.scenes.random_triangles(40, device="cpu", seed=40).geometry
    bvh = lbvh.build(geometry)
    bvh = dataclasses.replace(bvh, **{f: getattr(bvh, f).to("meta") for f in TREE_FIELDS})
    pos, vidx = geometry.positions.to("meta"), geometry.tri_vidx.to("meta")
    if case == "float64 positions":
        pos = pos.double()
    elif case == "non-contiguous positions":
        pos = torch.empty((3, pos.shape[0]), device="meta").t()
    elif case == "int64 vertex ids":
        vidx = vidx.long()
    elif case == "leaf table one row short":
        bvh = dataclasses.replace(bvh, leaf_tri=bvh.leaf_tri[:-1])
    elif case == "int64 children":
        bvh = dataclasses.replace(bvh, node_left=bvh.node_left.long())
    elif case == "boxes one row short":
        bvh = dataclasses.replace(bvh, node_max=bvh.node_max[:-1])
    elif case == "boxes on the CPU":
        bvh = dataclasses.replace(bvh, node_min=torch.zeros(bvh.node_min.shape))
    return bvh, dataclasses.replace(geometry, positions=pos, tri_vidx=vidx)


@pytest.mark.parametrize("case, match", [
    ("float64 positions", "float32 positions"),
    ("non-contiguous positions", "non-contiguous"),
    ("int64 vertex ids", "int32 tri_vidx"),
    ("leaf table one row short", "leaf_tri of shape"),
    ("int64 children", "int32 node_left"),
    ("boxes one row short", "node_max of shape"),
    ("boxes on the CPU", "device"),
    ("every tensor right, on no card", "CUDA tensors")])
def test_a_call_the_kernel_does_not_take_raises(case, match, monkeypatch):
    """Positions on a device other than the CPU go to the kernel's wrapper,
    which refuses a call it does not take before it builds, loads or
    launches anything; nothing falls back to the host."""
    def no_build():
        raise AssertionError("the refit kernel library was loaded")

    monkeypatch.setattr(lbvh, "load_kernel", no_build)
    monkeypatch.setattr(lbvh, "_refit_host", no_build)
    bvh, geometry = _meta_call(case)
    before = profile.kernel_launches.copy()
    with pytest.raises(ValueError, match=match):
        lbvh.refit_(bvh, geometry)
    assert profile.kernel_launches == before


def test_kernel_source_exports_its_entry_point(monkeypatch):
    """``csrc/bvh_refit.cu`` exports ``terra_bvh_refit`` with C linkage, and
    ``load_kernel`` binds it with one ctypes type per parameter of the
    source's signature (pointers, ``int``, ``int64_t``), returning int."""
    with open(lbvh.KERNEL_SRC) as f:
        src = f.read()
    sig = re.search(r'extern "C" int terra_bvh_refit\(([^)]*)\)', src)
    assert sig is not None
    kinds = {"*": ctypes.c_void_p, "int64_t": ctypes.c_int64, "int": ctypes.c_int}
    want = [next(v for k, v in kinds.items() if k in p) for p in sig.group(1).split(",")]
    lib = types.SimpleNamespace(terra_bvh_refit=types.SimpleNamespace())
    monkeypatch.setattr(lbvh, "kernel_path", lambda: "bvh_refit.so")
    monkeypatch.setattr(lbvh.ctypes, "CDLL", lambda path: lib)
    assert lbvh.load_kernel.__wrapped__() is lib
    assert lib.terra_bvh_refit.argtypes == want and lib.terra_bvh_refit.restype is ctypes.c_int
    assert len(want) == 12


# --- the kernel on the card against the plain twin. Marked ``cuda``: each
# skips without a CUDA device (decided in the fixture).


def _equal_words(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("builder", BUILDERS)
def test_kernel_matches_host_on_the_courtyard(cuda, builder):
    """The 241,764-triangle courtyard's tree after each of five random moves
    of its vertices: the kernel's boxes equal the plain twin's (a zero's
    sign aside), two launches a refit, the same words from a second call."""
    geometry = ttt.scenes.courtyard(device=cuda).geometry
    assert geometry.num_triangles == 241764
    bvh = lbvh.build(geometry, builder=builder)
    for seed in range(5):
        geometry = _moved(geometry, seed, scale=0.01)
        got, launches = _refit_counted(bvh, geometry)
        again = lbvh.refit(bvh, geometry)
        torch.cuda.synchronize()
        assert launches == {"bvh_refit": 2}
        want_min, want_max = _host_boxes(bvh, geometry)
        assert torch.equal(got.node_min.cpu(), want_min)
        assert torch.equal(got.node_max.cpu(), want_max)
        assert _equal_words(got.node_min, again.node_min)
        assert _equal_words(got.node_max, again.node_max)


@pytest.mark.cuda
@pytest.mark.parametrize("builder", BUILDERS)
def test_kernel_propagates_a_nan_vertex(cuda, builder):
    """A NaN coordinate of one vertex makes NaN exactly the boxes the plain
    twin makes NaN (its leaves' and every box above them, on that axis),
    and every other value equal."""
    geometry = ttt.scenes.random_triangles(4097, device=cuda, seed=9).geometry
    bvh = lbvh.build(geometry, builder=builder)
    pos = geometry.positions.clone()
    pos[int(geometry.tri_vidx[1234, 1]), 1] = float("nan")
    geometry = dataclasses.replace(geometry, positions=pos)
    got = lbvh.refit(bvh, geometry)
    want_min, want_max = _host_boxes(bvh, geometry)
    for g, w in ((got.node_min.cpu(), want_min), (got.node_max.cpu(), want_max)):
        nan = torch.isnan(w)
        assert bool(nan[0, 1]) and int(nan.sum()) >= 2 and not bool(nan[:, (0, 2)].any())
        assert torch.equal(torch.isnan(g), nan) and torch.equal(g[~nan], w[~nan])


@pytest.mark.cuda
def test_kernel_refit_in_a_captured_graph(cuda):
    """``refit_`` captured in a CUDA graph (it reads nothing back): each
    replay after the positions change writes the plain twin's boxes."""
    geometry = ttt.scenes.random_triangles(20000, device=cuda, seed=2).geometry
    bvh = lbvh.refit(lbvh.build(geometry), geometry)  # warm-up: builds and loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with profile.launches_taken_back() as counts, torch.cuda.graph(graph):
        lbvh.refit_(bvh, geometry)
    assert counts == {"bvh_refit": 2}
    for seed in (3, 4):
        moved = _moved(geometry, seed)
        geometry.positions.copy_(moved.positions)
        graph.replay()
        want_min, want_max = _host_boxes(bvh, geometry)
        assert torch.equal(bvh.node_min.cpu(), want_min)
        assert torch.equal(bvh.node_max.cpu(), want_max)


@pytest.mark.cuda
def test_recover_losses_equal_a_host_refit(cuda, monkeypatch):
    """Five ``recover`` steps on attributes, textures and positions of a
    small courtyard: with the kernel refit (two launches a step, enqueued
    before the next step's replays) the losses and the final boxes equal,
    word for word, those of a run whose refit is ``_refit_host`` on host
    copies."""
    scene = ttt.scenes.courtyard(device=cuda, **SMALL_COURTYARD)
    cam = ttt.scenes.courtyard_camera(device=cuda)
    opts = ttt.RenderOptions(width=32, height=32, samples_per_pixel=2, bounces=2,
                             integrator=ttt.Integrator.DIRECT, subpixel_jitter=0.5,
                             rr_start_bounce=8)
    target = torch.rand((32, 32, 3), generator=torch.Generator().manual_seed(6)).to(cuda)
    fields = ("attrs", "textures", "positions")

    def host_refit(bvh, geometry):
        node_min, node_max = _host_boxes(bvh, geometry)
        bvh.node_min.copy_(node_min)
        bvh.node_max.copy_(node_max)
        return bvh

    def run():
        return optim.recover(scene, cam, opts, target, fields=fields, steps=5,
                             learning_rate=3e-2, seed=3)

    before = profile.kernel_launches.copy()
    kernel_scene, kernel_losses = run()
    torch.cuda.synchronize()
    assert (profile.kernel_launches - before)["bvh_refit"] == 10
    monkeypatch.setattr(lbvh, "refit_", host_refit)
    host_scene, host_losses = run()
    graphs.clear()
    assert np.isfinite(kernel_losses).all() and kernel_losses == host_losses
    assert not torch.equal(kernel_scene.geometry.positions, scene.geometry.positions)
    assert torch.equal(kernel_scene.bvh.node_min, host_scene.bvh.node_min)
    assert torch.equal(kernel_scene.bvh.node_max, host_scene.bvh.node_max)
