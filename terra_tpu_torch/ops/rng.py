"""Counter-based RNG: Threefry-2x32-20 keyed by (pixel, sample, bounce, stream).

PyTorch port of ``terra_tpu/ops/rng.py``. It draws bit-identical uniforms
for every ``(seed, pixel, sample, bounce, stream)``, so the port replays
exactly the random decisions of the JAX renderer and of its NumPy mirror.

:func:`path_uniform_bundle`, :func:`path_uniform2` and :func:`path_uniform`
launch the hand-written kernel ``csrc/threefry.cu`` for lanes on a CUDA
device (one launch per call, counted as ``"threefry"`` in
``profile.kernel_launches``) and take their
plain versions (``*_plain``) for lanes on the CPU. There is no fallback:
a CUDA call the kernel does not take raises. The kernel runs the cipher
on uint32 words in registers; the plain versions run it as int64 PyTorch
ops, since PyTorch has no uint32 add or shift on the CPU: every 32-bit
word is an int64 tensor holding a value in ``[0, 2**32)``, and each add
and left shift is masked back to 32 bits. Both give the same words.
:func:`threefry2x32` is the plain cipher on any device.

The key words and the bounce may be python ints or int64 tensors on the
lanes' device. Python ints stay python ints (kernel arguments, never a
host-to-device copy); a (2,) key tensor lets one captured CUDA graph serve
every seed (``graphs.py``): the kernel reads it through its pointer.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from .._build import build_shared, nvcc
from ..profile import kernel_launches

__all__ = [
    "threefry2x32", "uniform_from_bits", "PathStreams", "path_uniform",
    "path_uniform2", "path_uniform_bundle", "path_uniform_plain", "path_uniform2_plain",
    "path_uniform_bundle_plain", "key_from_seed", "radical_inverse", "load_kernel",
    "kernel_path", "MAX_BASES",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                          "threefry.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Stream pairs one launch draws (the kernel's unrolled ciphers a lane).
MAX_BASES = 8


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


def path_uniform_plain(key, pixel_idx, sample_idx, bounce, stream: int):
    """One uniform per lane. Streams 2k and 2k+1 are the two output words
    of one threefry call at counter stream 2k."""
    ctr1 = _pack_counter(sample_idx, bounce, (int(stream) // 2) * 2)
    b0, b1 = threefry2x32(key[0], key[1], pixel_idx, ctr1)
    return uniform_from_bits(b1 if int(stream) % 2 else b0)


def path_uniform2_plain(key, pixel_idx, sample_idx, bounce, stream: int):
    """Uniforms of streams (stream, stream+1), ``stream`` even, from one
    threefry call."""
    ctr1 = _pack_counter(sample_idx, bounce, stream)
    b0, b1 = threefry2x32(key[0], key[1], pixel_idx, ctr1)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def path_uniform_bundle_plain(key, pixel_idx, sample_idx, bounce, streams) -> dict:
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


def kernel_path() -> str:
    """Path of the built threefry kernel library (builds it if needed)."""
    return build_shared([nvcc(), *NVCC_FLAGS], [KERNEL_SRC], "threefry")


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/threefry.cu`` (once per source/flag hash) and load it."""
    lib = ctypes.CDLL(kernel_path())
    p, u32, i64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64
    lib.terra_threefry_uniforms.restype = ctypes.c_int
    lib.terra_threefry_uniforms.argtypes = [p, u32, u32, p, p, i64, u32, p, i64, u32,
                                            ctypes.POINTER(u32), ctypes.c_int, i64, p, p]
    return lib


def _on_cuda(pixel_idx) -> bool:
    return isinstance(pixel_idx, torch.Tensor) and pixel_idx.is_cuda


def _key_words(key, device):
    """(device pointer or None, k0, k1): a (2,) int64 key tensor on
    ``device`` is read by the kernel; python ints are passed as words."""
    if isinstance(key, torch.Tensor):
        if key.device != device or key.dtype != torch.int64 or tuple(key.shape) != (2,) or \
                not key.is_contiguous():
            raise ValueError(f"the threefry kernel takes a key tensor of shape (2,), int64, "
                             f"contiguous, on {device}; got {tuple(key.shape)} {key.dtype} on "
                             f"{key.device}")
        return key.data_ptr(), 0, 0
    k0, k1 = key
    if isinstance(k0, torch.Tensor) or isinstance(k1, torch.Tensor):
        raise ValueError("the threefry kernel takes the key as two python ints or one (2,) "
                         "int64 tensor, not as two tensors")
    return None, int(k0) & _M32, int(k1) & _M32


def _lane_word(x, pixel_idx, name: str):
    """(tensor or None, stride, value) of a per-lane word: an int64 tensor
    shaped like the lanes (read at stride 1), a 0-d int64 tensor on their
    device (stride 0), or a python int (the value)."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & _M32
    if x.device != pixel_idx.device or x.dtype != torch.int64:
        raise ValueError(f"the threefry kernel takes {name} as int64 on {pixel_idx.device}; "
                         f"got {x.dtype} on {x.device}")
    if x.dim() == 0:
        return x, 0, 0
    if x.shape != pixel_idx.shape:
        raise ValueError(f"the threefry kernel takes {name} of the lanes' shape "
                         f"{tuple(pixel_idx.shape)} or 0-d; got {tuple(x.shape)}")
    return x.contiguous(), 1, 0


def _ptr(x):
    return None if x is None else x.data_ptr()


def _uniforms_cuda(key, pixel_idx, sample_idx, bounce, bases) -> torch.Tensor:
    """Launch the threefry kernel on the current stream: (2 * len(bases),
    *pixel_idx.shape) f32 uniforms, rows 2j and 2j + 1 the two words of
    the cipher at counter stream ``bases[j]``. Reads nothing back to the
    host and allocates only its output, so a CUDA graph can capture it."""
    if pixel_idx.dtype != torch.int64:
        raise ValueError(f"the threefry kernel takes int64 pixel ids; got {pixel_idx.dtype}")
    if not 1 <= len(bases) <= MAX_BASES or any(not 0 <= b < 64 for b in bases):
        raise ValueError(f"the threefry kernel takes 1 to {MAX_BASES} stream bases in "
                         f"[0, 64); got {list(bases)}")
    dev = pixel_idx.device
    key_ptr, k0, k1 = _key_words(key, dev)
    sample, s_stride, s_val = _lane_word(sample_idx, pixel_idx, "sample")
    bnc, b_stride, b_val = _lane_word(bounce, pixel_idx, "bounce")
    pixel = pixel_idx.contiguous()
    out = torch.empty((2 * len(bases), *pixel.shape), dtype=torch.float32, device=dev)
    if pixel.numel() == 0:
        return out
    rc = load_kernel().terra_threefry_uniforms(
        key_ptr, k0, k1, pixel.data_ptr(), _ptr(sample), s_stride, s_val, _ptr(bnc), b_stride,
        b_val, (ctypes.c_uint32 * len(bases))(*bases), len(bases), pixel.numel(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry launch failed: cudaError {rc}")
    kernel_launches["threefry"] += 1
    return out


def path_uniform(key, pixel_idx, sample_idx, bounce, stream: int):
    """One uniform per lane: the kernel for lanes on a CUDA device, else
    :func:`path_uniform_plain`."""
    if not _on_cuda(pixel_idx):
        return path_uniform_plain(key, pixel_idx, sample_idx, bounce, stream)
    return _uniforms_cuda(key, pixel_idx, sample_idx, bounce, [(int(stream) // 2) * 2])[
        int(stream) % 2]


def path_uniform2(key, pixel_idx, sample_idx, bounce, stream: int):
    """Uniforms of streams (stream, stream+1), ``stream`` even, from one
    cipher: the kernel for lanes on a CUDA device, else
    :func:`path_uniform2_plain`."""
    if not _on_cuda(pixel_idx):
        return path_uniform2_plain(key, pixel_idx, sample_idx, bounce, stream)
    u = _uniforms_cuda(key, pixel_idx, sample_idx, bounce, [int(stream)])
    return u[0], u[1]


def path_uniform_bundle(key, pixel_idx, sample_idx, bounce, streams) -> dict:
    """All of a bounce's uniforms, {stream: uniforms shaped like the
    lanes}: for lanes on a CUDA device one kernel launch whose rows the
    dict's entries view, else :func:`path_uniform_bundle_plain`."""
    if not _on_cuda(pixel_idx):
        return path_uniform_bundle_plain(key, pixel_idx, sample_idx, bounce, streams)
    bases = sorted({(int(s) // 2) * 2 for s in streams})
    u = _uniforms_cuda(key, pixel_idx, sample_idx, bounce, bases)
    row = {b: 2 * i for i, b in enumerate(bases)}
    return {s: u[row[(int(s) // 2) * 2] + int(s) % 2] for s in streams}


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
