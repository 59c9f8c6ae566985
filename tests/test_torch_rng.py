"""Port RNG: bit-identical to terra_tpu.ops.rng and the NumPy mirror."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terra_tpu.ops import rng as jrng
from terra_tpu.testing import mirror
from terra_tpu_torch import profile
from terra_tpu_torch.ops import rng as trng


def _counters(seed, n=4096):
    r = np.random.default_rng(seed)
    x0 = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x1 = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x0[:4] = (0, 1, 2**31, 2**32 - 1)
    x1[:4] = (0, 2**32 - 1, 7, 2**31)
    return x0, x1


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_threefry_bit_exact(seed):
    k0, k1 = jrng.key_from_seed(seed)
    assert trng.key_from_seed(seed) == (int(k0), int(k1))
    x0, x1 = _counters(seed)
    j0, j1 = jrng.threefry2x32(k0, k1, jnp.asarray(x0), jnp.asarray(x1))
    m0, m1 = mirror.threefry2x32_np(k0, k1, x0, x1)
    t0, t1 = trng.threefry2x32(int(k0), int(k1), torch.as_tensor(x0.astype(np.int64)),
                               torch.as_tensor(x1.astype(np.int64)))
    for ref_a, ref_b in ((j0, j1), (m0, m1)):
        np.testing.assert_array_equal(t0.numpy(), np.asarray(ref_a).astype(np.int64))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(ref_b).astype(np.int64))


STREAMS = (0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("bounce", [0, 3, "lanes"])
def test_path_uniforms_bit_exact(bounce, device, request):
    """On the CPU the plain int64 chain, on the card the threefry kernel
    (int64 lanes; skips without a CUDA device), against JAX's uniforms."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    key = jrng.key_from_seed(7)
    r = np.random.default_rng(3)
    n = 3000
    pixel = r.integers(0, 1 << 22, n).astype(np.int32)
    sample = r.integers(0, 1 << 16, n).astype(np.int32)
    b = r.integers(0, 8, n).astype(np.int32) if bounce == "lanes" else bounce
    jb = jnp.asarray(b) if bounce == "lanes" else b

    def lanes(x):
        return torch.as_tensor(x.astype(np.int64) if device == "cuda" else x, device=device)

    tb = lanes(b) if bounce == "lanes" else b
    tpixel, tsample = lanes(pixel), lanes(sample)
    jkey = jnp.asarray(key, jnp.uint32)
    tkey = trng.key_from_seed(7)
    ref = jrng.path_uniform_bundle(jkey, jnp.asarray(pixel), jnp.asarray(sample), jb, STREAMS)
    got = trng.path_uniform_bundle(tkey, tpixel, tsample, tb, STREAMS)
    for s in STREAMS:
        assert got[s].device.type == device
        np.testing.assert_array_equal(got[s].cpu().numpy(), np.asarray(ref[s]))
        one = trng.path_uniform(tkey, tpixel, tsample, tb, s)
        np.testing.assert_array_equal(one.cpu().numpy(), np.asarray(ref[s]))
    u1, u2 = trng.path_uniform2(tkey, tpixel, tsample, tb, 0)
    np.testing.assert_array_equal(u1.cpu().numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(u2.cpu().numpy(), np.asarray(ref[1]))
    if bounce != "lanes":  # the mirror takes the bounce as a scalar
        for s in STREAMS:
            m = mirror.uniform_np(key, pixel, sample, bounce, s)
            np.testing.assert_array_equal(got[s].cpu().numpy(), m)


@pytest.mark.parametrize("base", [2, 3])
def test_radical_inverse_bit_exact(base):
    idx = np.concatenate([np.arange(0, 4096), np.asarray([2**20 + 3, 2**30 + 11, 2**31 - 1])])
    idx = idx.astype(np.int32)
    ref = jrng.radical_inverse(base, jnp.asarray(idx))
    got = trng.radical_inverse(base, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_lanes_never_load_the_kernel(monkeypatch):
    """Lanes on the CPU take the plain int64 chain: the wrappers neither
    build nor load the threefry library, and count no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the threefry library was asked for on the CPU")

    monkeypatch.setattr(trng, "load_kernel", refuse)
    monkeypatch.setattr(trng, "kernel_path", refuse)
    monkeypatch.setattr(trng, "build_shared", refuse)
    before = profile.kernel_launches.copy()
    pixel = torch.arange(300, dtype=torch.int64)
    sample = pixel * 7
    for key in (trng.key_from_seed(5), torch.tensor(trng.key_from_seed(5))):
        for bounce in (2, torch.full((300,), 2, dtype=torch.int64)):
            got = trng.path_uniform_bundle(key, pixel, sample, bounce, STREAMS)
            ref = trng.path_uniform_bundle_plain(key, pixel, sample, bounce, STREAMS)
            for s in STREAMS:
                assert torch.equal(got[s], ref[s])
                assert torch.equal(trng.path_uniform(key, pixel, sample, bounce, s), ref[s])
            u1, u2 = trng.path_uniform2(key, pixel, sample, bounce, 0)
            assert torch.equal(u1, ref[0]) and torch.equal(u2, ref[1])
    assert profile.kernel_launches == before


_BAD_LAUNCHES = {
    "int32 pixels": lambda p: dict(pixel=p.to(torch.int32)),
    "int32 samples": lambda p: dict(sample=p.to(torch.int32)),
    "samples of another shape": lambda p: dict(sample=p[:-1]),
    "bounces of another shape": lambda p: dict(bounce=p[None, :]),
    "key words as tensors": lambda p: dict(key=(p[0], p[1])),
    "an int32 key": lambda p: dict(key=torch.tensor([1, 2], dtype=torch.int32)),
    "a key of three words": lambda p: dict(key=torch.tensor([1, 2, 3])),
    "nine stream pairs": lambda p: dict(bases=list(range(0, 18, 2))),
    "no stream pair": lambda p: dict(bases=[]),
    "stream base 64": lambda p: dict(bases=[64]),
}


@pytest.mark.parametrize("case", sorted(_BAD_LAUNCHES))
def test_kernel_launch_refuses_what_it_does_not_take(case, monkeypatch):
    """The CUDA launcher's checks raise before the library is asked for."""
    def refuse(*args, **kwargs):
        raise AssertionError("the launcher got past its checks")

    monkeypatch.setattr(trng, "load_kernel", refuse)
    pixel = torch.arange(64, dtype=torch.int64)
    args = dict(key=trng.key_from_seed(1), pixel=pixel, sample=pixel, bounce=0, bases=[2, 4])
    args.update(_BAD_LAUNCHES[case](pixel))
    with pytest.raises(ValueError):
        trng._uniforms_cuda(args["key"], args["pixel"], args["sample"], args["bounce"],
                            args["bases"])


# --- the threefry kernel on the card, word for word against the plain chain
# at pixel, sample and bounce values wider than JAX's 32-bit lanes (the
# kernel against JAX is a case of test_path_uniforms_bit_exact). Marked
# ``cuda``: each skips without a CUDA device (decided in the fixture).


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the threefry kernel runs only on the card")
    return torch.device("cuda")


def _card_lanes(n, dev, seed=20):
    """Pixel ids, samples and bounces of n lanes, as int64 on ``dev``: wide
    values, so that pixel ids pass 2^32 and go negative, and sample << 12
    and bounce << 6 wrap past 32 bits."""
    r = np.random.default_rng(seed)
    pixel = r.integers(-2**40, 2**40, n)
    pixel[: min(n, 3)] = (0, 2**32 - 1, 2**32)[: min(n, 3)]
    sample = r.integers(0, 2**34, n)
    sample[: min(n, 2)] = (2**20 - 1, 2**20)[: min(n, 2)]
    bounce = r.integers(0, 2**27, n)
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=dev)
                 for x in (pixel, sample, bounce))


def _same_words(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 255, 257, 147456])
@pytest.mark.parametrize("key_form", ["ints", "device"])
@pytest.mark.parametrize("bounce_form", ["int", "lanes"])
def test_kernel_bundle_matches_plain_chain(cuda, n, key_form, bounce_form):
    """All 14 assigned streams from one launch equal the plain int64 chain
    word for word; so do path_uniform and path_uniform2 on each pair."""
    pixel, sample, lane_bounce = _card_lanes(n, cuda)
    key = trng.key_from_seed(2**31 + 77)
    if key_form == "device":
        key = torch.tensor(key, dtype=torch.int64, device=cuda)
    bounce = lane_bounce if bounce_form == "lanes" else 2**26 + 3
    before = profile.kernel_launches["threefry"]
    got = trng.path_uniform_bundle(key, pixel, sample, bounce, STREAMS)
    assert profile.kernel_launches["threefry"] == before + (1 if n else 0)
    ref = trng.path_uniform_bundle_plain(key, pixel, sample, bounce, STREAMS)
    for s in STREAMS:
        assert got[s].device.type == "cuda" and _same_words(got[s], ref[s]), s
        assert _same_words(trng.path_uniform(key, pixel, sample, bounce, s), ref[s]), s
    for base in range(0, 16, 2):
        pair = trng.path_uniform2(key, pixel, sample, bounce, base)
        plain = trng.path_uniform2_plain(key, pixel, sample, bounce, base)
        assert all(_same_words(a, b) for a, b in zip(pair, plain)), base


@pytest.mark.cuda
def test_kernel_takes_scalar_tensors(cuda):
    """A 0-d device tensor for the sample or the bounce is one word for
    every lane: the uniforms of that word repeated across the lanes."""
    pixel, lane_sample, lane_bounce = _card_lanes(1000, cuda)
    key = trng.key_from_seed(9)
    one_sample = torch.tensor(2**20 + 5, dtype=torch.int64, device=cuda)
    one_bounce = torch.tensor(7, dtype=torch.int64, device=cuda)
    for sample, bounce in ((one_sample, lane_bounce), (lane_sample, one_bounce),
                           (one_sample, one_bounce)):
        got = trng.path_uniform_bundle(key, pixel, sample, bounce, STREAMS)
        ref = trng.path_uniform_bundle_plain(key, pixel, sample.expand_as(pixel),
                                             bounce.expand_as(pixel), STREAMS)
        assert all(_same_words(got[s], ref[s]) for s in STREAMS)


@pytest.mark.cuda
def test_kernel_in_a_graph_reads_the_key_at_replay(cuda):
    """A captured bundle reads its key words from the input buffer at each
    replay: new words there give the new key's uniforms, word for word,
    with no new capture; a capture records one launch, a replay none."""
    pixel, sample, bounce = _card_lanes(147456, cuda)
    inputs = torch.zeros((4,), dtype=torch.int64, device=cuda)  # k0, k1, offset, row0
    inputs[0:2] = torch.tensor(trng.key_from_seed(1), device=cuda)
    streams = (2, 3, 4, 5, 6, 8, 9)
    trng.path_uniform_bundle(inputs[0:2], pixel, sample, bounce, streams)  # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with profile.launches_taken_back() as counts, torch.cuda.graph(graph):
        out = trng.path_uniform_bundle(inputs[0:2], pixel, sample, bounce, streams)
    assert counts == {"threefry": 1}
    for seed in (2, 2**32 + 5, 3000020):
        key = trng.key_from_seed(seed)
        inputs[0:2].copy_(torch.tensor(key, device=cuda))
        graph.replay()
        ref = trng.path_uniform_bundle_plain(key, pixel, sample, bounce, streams)
        assert all(_same_words(out[s], ref[s]) for s in streams), seed
