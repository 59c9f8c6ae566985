"""Counter-based RNG: Threefry-2x32-20 keyed by (pixel, sample, bounce, stream).

PyTorch port of ``terra_tpu/ops/rng.py``. It draws bit-identical uniforms
for every ``(seed, pixel, sample, bounce, stream)``, so the port replays
exactly the random decisions of the JAX renderer and of its NumPy mirror.

PyTorch has no uint32 add or shift on the CPU, so every 32-bit word is an
int64 tensor holding a value in ``[0, 2**32)``; each add and left shift is
masked back to 32 bits. The same code runs on CPU and CUDA tensors.

The key words and the bounce may be python ints or int64 tensors on the
lanes' device. Python ints stay python ints (kernel arguments, never a
host-to-device copy); a (2,) key tensor lets one captured CUDA graph serve
every seed (``graphs.py``), with the same ``& 0xFFFFFFFF`` arithmetic.
"""
from __future__ import annotations

import torch

__all__ = [
    "threefry2x32", "uniform_from_bits", "PathStreams", "path_uniform",
    "path_uniform2", "path_uniform_bundle", "key_from_seed", "radical_inverse",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _u32(x, like=None):
    """A 32-bit word as an int64 tensor (python ints become tensors on
    ``like``'s device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    device = like.device if like is not None else None
    return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _word(x):
    """A 32-bit word kept as it came: an int64 tensor or a python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _rotl32(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32-20 block cipher on broadcastable 32-bit words.

    ``k0``/``k1`` may be python ints or 0-d int64 tensors (the words of a
    (2,) key tensor); ``x0``/``x1`` are integer tensors. Returns two int64
    tensors of words in ``[0, 2**32)``.
    """
    x0 = _u32(x0)
    x1 = _u32(x1, x0)
    k0 = _word(k0)
    k1 = _word(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(group + 2) % 3] + group + 1) & _M32)) & _M32
    return x0, x1


def uniform_from_bits(bits):
    """32-bit word -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_from_seed(seed: int) -> tuple[int, int]:
    """The two threefry key words of a seed (splitmix64 finalizer)."""
    mask = (1 << 64) - 1
    z = (int(seed) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return z & _M32, z >> 32


class PathStreams:
    """Stream ids for every random decision along a path (the ids of
    ``terra_tpu.ops.rng.PathStreams``; 7 stays unassigned)."""

    JITTER_X = 0
    JITTER_Y = 1
    BSDF_E0 = 2
    BSDF_E1 = 3
    BSDF_E2 = 4
    ROULETTE = 5
    LIGHT_PICK = 6
    LIGHT_U = 8
    LIGHT_V = 9
    MIS_E0 = 10
    MIS_E1 = 11
    MIS_E2 = 12
    ENV_U = 13
    ENV_V = 14


def _pack_counter(sample_idx, bounce, stream):
    """Second counter word: sample in the top 20 bits, bounce in 6, stream
    in 6. ``bounce`` may be an int or a per-lane tensor."""
    s = _u32(sample_idx)
    b = _word(bounce)
    return ((s << 12) & _M32) | ((b << 6) & _M32) | int(stream)


def path_uniform(key, pixel_idx, sample_idx, bounce, stream: int):
    """One uniform per lane. Streams 2k and 2k+1 are the two output words
    of one threefry call at counter stream 2k."""
    ctr1 = _pack_counter(sample_idx, bounce, (int(stream) // 2) * 2)
    b0, b1 = threefry2x32(key[0], key[1], pixel_idx, ctr1)
    return uniform_from_bits(b1 if int(stream) % 2 else b0)


def path_uniform2(key, pixel_idx, sample_idx, bounce, stream: int):
    """Uniforms of streams (stream, stream+1), ``stream`` even, from one
    threefry call."""
    ctr1 = _pack_counter(sample_idx, bounce, stream)
    b0, b1 = threefry2x32(key[0], key[1], pixel_idx, ctr1)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams) -> dict:
    """All of a bounce's uniforms from one batched threefry evaluation:
    streams are grouped into even-base pairs, one cipher lane per pair.
    Returns {stream: (N,) float32}."""
    pixel_idx = _u32(pixel_idx)
    bases = sorted({(int(s) // 2) * 2 for s in streams})
    ctrs = torch.stack([_pack_counter(sample_idx, bounce, b) for b in bases], dim=0)
    x0 = pixel_idx[None, :].expand(ctrs.shape)
    b0, b1 = threefry2x32(key[0], key[1], x0, ctrs)
    u0 = uniform_from_bits(b0)
    u1 = uniform_from_bits(b1)
    row = {b: i for i, b in enumerate(bases)}
    return {s: (u1 if int(s) % 2 else u0)[row[(int(s) // 2) * 2]] for s in streams}


def radical_inverse(base: int, index, iters: int = 32):
    """Van der Corput radical inverse (Halton pixel sampler), with the
    reference's uint32 wraparound and float32 accumulation."""
    a = _u32(index)
    seq = torch.zeros_like(a)
    denom = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        live = a > 0
        nxt = a // base
        digit = a - nxt * base
        seq = torch.where(live, (seq * base + digit) & _M32, seq)
        denom = torch.where(live, denom * (1.0 / base), denom)
        a = nxt
    val = seq.to(torch.float32) * denom
    return torch.clamp(val, max=1.0 - 1e-4)
