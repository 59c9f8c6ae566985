"""Port RNG: bit-identical to terra_tpu.ops.rng and the NumPy mirror."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terra_tpu.ops import rng as jrng
from terra_tpu.testing import mirror
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


@pytest.mark.parametrize("bounce", [0, 3, "lanes"])
def test_path_uniforms_bit_exact(bounce):
    key = jrng.key_from_seed(7)
    r = np.random.default_rng(3)
    n = 3000
    pixel = r.integers(0, 1 << 22, n).astype(np.int32)
    sample = r.integers(0, 1 << 16, n).astype(np.int32)
    b = r.integers(0, 8, n).astype(np.int32) if bounce == "lanes" else bounce
    jb = jnp.asarray(b) if bounce == "lanes" else b
    tb = torch.as_tensor(b) if bounce == "lanes" else b
    jkey = jnp.asarray(key, jnp.uint32)
    tkey = trng.key_from_seed(7)
    ref = jrng.path_uniform_bundle(jkey, jnp.asarray(pixel), jnp.asarray(sample), jb, STREAMS)
    got = trng.path_uniform_bundle(tkey, torch.as_tensor(pixel), torch.as_tensor(sample), tb,
                                   STREAMS)
    for s in STREAMS:
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(ref[s]))
        one = trng.path_uniform(tkey, torch.as_tensor(pixel), torch.as_tensor(sample), tb, s)
        np.testing.assert_array_equal(one.numpy(), np.asarray(ref[s]))
    u1, u2 = trng.path_uniform2(tkey, torch.as_tensor(pixel), torch.as_tensor(sample), tb, 0)
    np.testing.assert_array_equal(u1.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(u2.numpy(), np.asarray(ref[1]))
    if bounce != "lanes":  # the mirror takes the bounce as a scalar
        for s in STREAMS:
            m = mirror.uniform_np(key, pixel, sample, bounce, s)
            np.testing.assert_array_equal(got[s].numpy(), m)


@pytest.mark.parametrize("base", [2, 3])
def test_radical_inverse_bit_exact(base):
    idx = np.concatenate([np.arange(0, 4096), np.asarray([2**20 + 3, 2**30 + 11, 2**31 - 1])])
    idx = idx.astype(np.int32)
    ref = jrng.radical_inverse(base, jnp.asarray(idx))
    got = trng.radical_inverse(base, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
