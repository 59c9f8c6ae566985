"""Port BVH4 traversal (overlay, f32 / bf16 / paged tables, step counters)
vs terra_tpu: the overlay and the packed words exactly, the plain walk
against the Pallas kernel in interpret mode and against brute force with
the budgets of test_pallas_traverse.py (hit masks equal, t within rtol
1e-4, >= 99% of hits on the same triangle, occlusion masks equal). JAX
scenes are carried across with interop, so both sides walk one overlay."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import terra_tpu as tt
from terra_tpu import intersect as jint
from terra_tpu.accel import lbvh as jlbvh
from terra_tpu.accel import pallas_traverse as jpt
import terra_tpu_torch as ttt
from terra_tpu_torch import interop
from terra_tpu_torch.accel import lbvh as tlbvh
from terra_tpu_torch.accel import pallas_traverse as tpt
from tests.test_torch_scene import SMALL_COURTYARD, flatten
from tests.test_torch_traverse import _rays


def _twins(tris, seed):
    js = tt.scenes.random_triangles(tris, seed=seed, accelerator=tt.Accelerator.BVH)
    return js, interop.scene_from_numpy(flatten(js), device="cpu")


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("case", ["random33", "random700", "random3000", "courtyard"])
def test_collapse4_matches_reference(case):
    if case == "courtyard":
        jg = tt.scenes.courtyard(**SMALL_COURTYARD).geometry
        tg = ttt.scenes.courtyard(device="cpu", **SMALL_COURTYARD).geometry
    else:
        n = int(case[6:])
        jg = tt.scenes.random_triangles(n, seed=n).geometry
        tg = ttt.scenes.random_triangles(n, device="cpu", seed=n).geometry
    jb = jlbvh.build(jg, leaf_size=8)
    tb = tlbvh.build(tg, leaf_size=8)
    np.testing.assert_array_equal(tb.wide_child.numpy(), np.asarray(jb.wide_child))
    np.testing.assert_array_equal(tb.wide_src.numpy(), np.asarray(jb.wide_src))
    assert (tb.num_wide, tb.wide_depth) == (jb.num_wide, jb.wide_depth)
    assert (tb.wide_src < 0).any() or case == "random33"  # empty slots exist


def test_collapse4_ties_match_reference():
    """Equal areas everywhere: the first slot in list order wins, as in the
    reference."""
    tb = tlbvh.build(ttt.scenes.random_triangles(700, device="cpu", seed=5).geometry, leaf_size=4)
    left, right = tb.node_left.numpy(), tb.node_right.numpy()
    box_min = np.zeros_like(tb.node_min.numpy())
    box_max = np.ones_like(box_min)
    got = tlbvh._collapse4(left, right, box_min, box_max)
    ref = jlbvh._collapse4(left, right, box_min, box_max)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_bf16_bits_match_reference():
    tiny = np.float32(1e-40)  # subnormal
    x = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 1.00390625, -1.00390625,
                  1.0001, -1.0001, 3.3e38, -3.3e38, tiny, -tiny, 1e-45, -1e-45,
                  2.5e-39, -2.5e-39, 123.456, -123.456], np.float32)
    x = np.concatenate([x, np.random.default_rng(0).normal(0, 50, 4096).astype(np.float32)])
    for name in ("_bf16_down_bits", "_bf16_up_bits"):
        got = getattr(tpt, name)(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jpt, name)(jnp.asarray(x))))
    dn = tpt._bf16_down_bits(torch.as_tensor(x)).numpy().view(np.float32)
    up = tpt._bf16_up_bits(torch.as_tensor(x)).numpy().view(np.float32)
    normal = np.abs(x) >= np.finfo(np.float32).tiny  # subnormals truncate, as the reference
    assert (dn <= x)[normal].all() and (up >= x)[normal].all()
    # decode: min from the high half-word, max from the low one, as uint32
    boxes = np.stack([x, x, x, x + 1, x + 2, x + 3], axis=-1)
    words = tpt._bf16_words(torch.as_tensor(boxes))
    u = words.numpy().view(np.uint32)
    expect = np.concatenate([(u & 0xFFFF0000).view(np.float32),
                             (u << np.uint32(16)).view(np.float32)], axis=-1)
    np.testing.assert_array_equal(tpt._bf16_boxes(words).numpy().view(np.int32),
                                  expect.view(np.int32))


@pytest.mark.parametrize("kind", ["f32", "bf16", "paged_bf16", "paged_f32"])
def test_pack_tables_match_reference(kind):
    js, ts = _twins(3000, 77)
    jc, tc = js.geometry.corners(), ts.geometry.corners()
    if kind.startswith("paged"):
        enc = kind[6:]
        nodes, links, jtris, rows = jpt.pack_tables_paged(js.bvh, *jc, resident_cap=4,
                                                          resident_enc=enc)
        tab = tpt.pack_tables_paged(ts.bvh, *tc, resident_cap=4, resident_enc=enc)
        w, s = ts.bvh.num_wide, tab.s_resident
        assert s == 4 and tab.mode == "paged" and tab.box_enc == enc
        # the reference's lane-replicated rows map onto the port's tables
        blocks = np.asarray(rows).reshape(-1, 28, 128)[: w - s]
        np.testing.assert_array_equal(_bits(blocks[:, :24]),
                                      np.broadcast_to(_bits(tab.pboxes.numpy())[..., None],
                                                      (w - s, 24, 128)))
        np.testing.assert_array_equal(blocks[:, 24:], np.broadcast_to(
            tab.plinks.numpy().astype(np.float32)[..., None], (w - s, 4, 128)))
    else:
        nodes, links, jtris = jpt.pack_tables_wide(js.bvh, *jc, box_enc=kind)
        tab = tpt.pack_tables_wide(ts.bvh, *tc, box_enc=kind)
        assert tab.mode == kind and tab.pboxes is None
    np.testing.assert_array_equal(_bits(tab.nodes.reshape(-1).numpy()), _bits(nodes))
    np.testing.assert_array_equal(tab.links.reshape(-1).numpy(), np.asarray(links))
    jt = np.asarray(jtris)
    np.testing.assert_array_equal(tab.tris.numpy(), jt[:, :9])
    np.testing.assert_array_equal(tab.tri_id.numpy(), jt[:, 9].astype(np.int32))


def _assert_hits(bt, bi, ref_t, ref_i, far):
    """Hit masks equal, t within rtol 1e-4, >= 99% same triangle."""
    bt, bi, ref_t, ref_i = (np.asarray(x) for x in (bt, bi, ref_t, ref_i))
    hit = ref_t < far
    np.testing.assert_array_equal(bt < far, hit)
    np.testing.assert_allclose(bt[hit], ref_t[hit], rtol=1e-4)
    assert (bi[hit] == ref_i[hit]).mean() > 0.99


CASES = {"closest": (None, False, "mt"), "t_max": ("t", False, "mt"),
         "t_max_any_hit": ("t", True, "mt"), "watertight": (None, False, "watertight")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("enc", ["f32", "bf16"])
def test_plain4_matches_pallas_and_brute(enc, case):
    use_tmax, any_hit, algo = CASES[case]
    js, ts = _twins(1200 if enc == "bf16" else 3000, 7)
    o, d = _rays(8)
    tm = np.random.default_rng(9).uniform(0.05, 3.0, len(o)).astype(np.float32) \
        if use_tmax else None
    tab = tpt.pack_tables_wide(ts.bvh, *ts.geometry.corners(), box_enc=enc)
    bt, bi = tpt.raycast4_plain(tab, torch.as_tensor(o), torch.as_tensor(d),
                                None if tm is None else torch.as_tensor(tm), any_hit, algo)
    jt, ji = jpt._traverse_pallas(
        js.bvh, *jpt.pack_tables_wide(js.bvh, *js.geometry.corners(), box_enc=enc),
        jnp.asarray(o), jnp.asarray(d), interpret=True, packet_rows=8, ways=1, arity=4,
        box_enc=enc, algo=algo, t_max=None if tm is None else jnp.asarray(tm), any_hit=any_hit)
    brute = jint.raycast_brute(jnp.asarray(o), jnp.asarray(d), *js.geometry.corners(),
                               algo=algo)
    if tm is None:
        _assert_hits(bt, bi, jt, ji, jint.T_FAR)
        _assert_hits(bt, bi, brute.t, brute.tri, jint.T_FAR)
    else:  # occlusion: masks within t_max equal
        occ = bt.numpy() < tm
        np.testing.assert_array_equal(occ, np.asarray(jt) < tm)
        np.testing.assert_array_equal(occ, np.asarray(brute.t) < tm)
        if any_hit:
            assert (bt.numpy()[occ] == 0.0).all()


@pytest.mark.parametrize("cap", [1, 4, 64])
def test_plain4_paged_matches_pallas_and_brute(cap):
    js, ts = _twins(3000, 77)
    assert ts.bvh.num_wide > 64
    o, d = _rays(5)
    jpacked = jpt.pack_tables_paged(js.bvh, *js.geometry.corners(), resident_cap=cap)
    ref = jpt.raycast(js, jnp.asarray(o), jnp.asarray(d), interpret=True, packed=jpacked)
    tab = tpt.pack_tables_paged(ts.bvh, *ts.geometry.corners(), resident_cap=cap)
    got = tpt.raycast(ts, torch.as_tensor(o), torch.as_tensor(d), tables=tab)
    for r in (ref, jint.raycast_brute(jnp.asarray(o), jnp.asarray(d), *js.geometry.corners())):
        _assert_hits(got.t, got.tri, r.t, r.tri, jint.T_FAR)


def test_plain4_paged_occlusion_and_any_hit():
    js, ts = _twins(1500, 15)
    o, d = _rays(16)
    tm = np.random.default_rng(17).uniform(0.05, 3.0, len(o)).astype(np.float32)
    expect = np.asarray(jint.raycast_brute(jnp.asarray(o), jnp.asarray(d),
                                           *js.geometry.corners()).t) < tm
    jpacked = jpt.pack_tables_paged(js.bvh, *js.geometry.corners(), resident_cap=8)
    ref = jpt.raycast(js, jnp.asarray(o), jnp.asarray(d), interpret=True, packed=jpacked,
                      t_max=jnp.asarray(tm), any_hit=True)
    np.testing.assert_array_equal(np.asarray(ref.hit), expect)
    tab = tpt.pack_tables_paged(ts.bvh, *ts.geometry.corners(), resident_cap=8)
    for any_hit in (False, True):
        got = tpt.raycast(ts, torch.as_tensor(o), torch.as_tensor(d), t_max=torch.as_tensor(tm),
                          any_hit=any_hit, tables=tab)
        np.testing.assert_array_equal(got.hit.numpy(), expect)


@pytest.mark.parametrize("kind", ["f32", "bf16", "paged1", "paged_all"])
def test_counted_matches_uncounted_and_decodes(kind):
    _, ts = _twins(1500, 15)
    c = ts.geometry.corners()
    tab = {"f32": lambda: tpt.pack_tables_wide(ts.bvh, *c),
           "bf16": lambda: tpt.pack_tables_wide(ts.bvh, *c, box_enc="bf16"),
           "paged1": lambda: tpt.pack_tables_paged(ts.bvh, *c, resident_cap=1),
           "paged_all": lambda: tpt.pack_tables_paged(ts.bvh, *c)}[kind]()
    o, d = (torch.as_tensor(x) for x in _rays(21, 4000))  # a partial last warp
    bt0, bi0 = tpt.traverse_packed(tab, o, d)
    bt1, bi1, steps = tpt.traverse_packed(tab, o, d, count_steps=True)
    assert torch.equal(bt0, bt1) and torch.equal(bi0, bi1)
    assert steps.shape == (4000, 3) and steps.dtype == torch.int32
    dec = tpt.count_decode(steps)
    assert len(dec["iters"]) == 125
    assert (dec["iters"] > 0).all()
    assert dec["pops"].sum() >= dec["leaves"].sum() > 0
    assert (dec["iters"] <= dec["pops"]).all()
    assert (dec["paged"].sum() > 0) == (kind == "paged1")


def test_interop_round_trips_wide_fields():
    js = tt.scenes.courtyard(**SMALL_COURTYARD, accelerator=tt.Accelerator.BVH)
    bvh = interop.scene_from_numpy(flatten(js), device="cpu").bvh
    np.testing.assert_array_equal(bvh.wide_child.numpy(), np.asarray(js.bvh.wide_child))
    np.testing.assert_array_equal(bvh.wide_src.numpy(), np.asarray(js.bvh.wide_src))
    assert (bvh.num_wide, bvh.wide_depth) == (js.bvh.num_wide, js.bvh.wide_depth)
    assert bvh.wide_child.dtype == torch.int32 and bvh.num_wide > 0


def test_wide_mode_order(monkeypatch):
    """The reference's order of preference: f32 wide, binary, bf16 wide,
    paged, by the bytes each table needs (leaf 8, where the binary table
    is smaller than the f32 overlay)."""
    ts = ttt.scenes.random_triangles(3000, device="cpu", seed=3, accelerator=ttt.Accelerator.BVH)
    bvh = ts.bvh
    f32 = bvh.num_wide * tpt.WIDE_F32_NODE_BYTES
    binary = tpt._binary_bytes(bvh)
    bf16 = bvh.num_wide * tpt.WIDE_BF16_NODE_BYTES
    assert bf16 < binary < f32
    for budget, mode in ((f32, "f32"), (binary, None), (bf16, "bf16"), (bf16 - 1, "paged")):
        monkeypatch.setattr(tpt, "NODE_TABLE_BUDGET", budget)
        assert tpt.wide_mode(bvh) == mode
        tab = tpt.pack_tables_auto(bvh, *ts.geometry.corners())
        assert getattr(tab, "mode", None) == mode


def _bad(case):
    _, ts = _twins(700, 3)
    o, d = (torch.as_tensor(x) for x in _rays(2, 64))
    c = ts.geometry.corners()
    tab = tpt.pack_tables_wide(ts.bvh, *c)
    if case == "device":  # the CUDA wrapper refuses CPU tensors, never falls back
        return lambda: tpt.raycast4_cuda(tab, o, d), ValueError
    if case == "stack":
        tab.wide_depth = tpt.STACK_CAP // 3
        return lambda: tpt.raycast4_plain(tab, o, d), ValueError
    if case == "single_leaf":
        _, one = _twins(5, 5)
        return lambda: tpt.pack_tables_wide(one.bvh, *one.geometry.corners()), ValueError
    if case == "encoding":
        return lambda: tpt.pack_tables_wide(ts.bvh, *c, box_enc="f16"), ValueError
    return lambda: tpt.traverse_packed(tpt.pack_tables(ts.bvh, *c), o, d,
                                       count_steps=True), ValueError


@pytest.mark.parametrize("case", ["device", "stack", "single_leaf", "encoding", "count_binary"])
def test_wide_wrappers_reject_bad_inputs(case):
    fn, exc = _bad(case)
    before = tpt.launches4
    with pytest.raises(exc):
        fn()
    assert tpt.launches4 == before


@pytest.mark.parametrize("kind", ["binary", "f32", "paged"])
def test_stack_cap_boundary(kind):
    """The kernels' per-thread stack holds STACK_CAP entries: the deepest
    tree whose walk fits (depth + 2, or 3 * wide_depth + 2 entries) is
    walked, one level more is refused, by the plain walks as by the CUDA
    wrappers (which share the check)."""
    _, ts = _twins(3000, 77)
    c = ts.geometry.corners()
    tab = {"binary": lambda: tpt.pack_tables(ts.bvh, *c),
           "f32": lambda: tpt.pack_tables_wide(ts.bvh, *c),
           "paged": lambda: tpt.pack_tables_paged(ts.bvh, *c, resident_cap=8)}[kind]()
    wide = kind != "binary"
    walk = tpt.raycast4_plain if wide else tpt.raycast_plain
    field = "wide_depth" if wide else "depth"
    deepest = (tpt.STACK_CAP - 2) // 3 if wide else tpt.STACK_CAP - 2
    o, d = (torch.as_tensor(x) for x in _rays(3, 64))
    ref = walk(tab, o, d)
    setattr(tab, field, deepest)
    got = walk(tab, o, d)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    setattr(tab, field, deepest + 1)
    with pytest.raises(ValueError, match="entry stack"):
        walk(tab, o, d)
