"""Texture atlas sampling (port of ``terra_tpu/textures.py``): wrap, mirror
and clamp addressing, point and bilinear filtering, UVs in [0, 1], and the
lat-long environment lookup."""
from __future__ import annotations

import math

import torch

from .ops import math3
from .ops.row_accumulate import gather
from .scene import TextureAtlas

__all__ = ["sample", "sample_latlong", "FILTER_POINT", "FILTER_BILINEAR", "ADDR_WRAP",
           "ADDR_MIRROR", "ADDR_CLAMP"]

FILTER_POINT = 0
FILTER_BILINEAR = 1
ADDR_WRAP = 0
ADDR_MIRROR = 1
ADDR_CLAMP = 2


def _address(coord, size, mode):
    """Per-lane address mode in integer texel space."""
    size = torch.clamp(size, min=1)
    wrap = torch.remainder(coord, size)
    m = torch.remainder(coord, 2 * size)
    mirror = torch.where(m >= size, 2 * size - 1 - m, m)
    clamp = torch.minimum(torch.clamp(coord, min=0), size - 1)
    return torch.where(mode == ADDR_WRAP, wrap, torch.where(mode == ADDR_MIRROR, mirror, clamp))


def _read(atlas: TextureAtlas, tex_id, x, y):
    """Texels at integer (x, y) of per-lane textures -> (N, 3), fetched by
    one flat index into the row-major atlas (``row_accumulate.gather``)."""
    tex_id = tex_id.long()
    h = atlas.size[tex_id, 0].long()
    w = atlas.size[tex_id, 1].long()
    mode = atlas.address[tex_id]
    x = _address(x, w, mode)
    y = _address(y, h, mode)
    nt, H, W, _ = atlas.data.shape
    flat = (tex_id * H + y) * W + x
    return gather(atlas.data.reshape(nt * H * W, 3), flat)


def sample(atlas: TextureAtlas, tex_id, uv):
    """Sample per-lane textures at uv. tex_id (N,) valid ids, uv (N, 2)."""
    tid = tex_id.long()
    h = atlas.size[tid, 0].to(torch.float32)
    w = atlas.size[tid, 1].to(torch.float32)
    fx = uv[..., 0] * w
    fy = uv[..., 1] * h
    ix = torch.floor(fx).long()
    iy = torch.floor(fy).long()
    n1 = _read(atlas, tid, ix, iy)
    n2 = _read(atlas, tid, ix + 1, iy)
    n3 = _read(atlas, tid, ix, iy + 1)
    n4 = _read(atlas, tid, ix + 1, iy + 1)
    w_u = (fx - ix.to(torch.float32))[..., None]
    w_v = (fy - iy.to(torch.float32))[..., None]
    bilinear = (n1 * (1 - w_u) + n2 * w_u) * (1 - w_v) + (n3 * (1 - w_u) + n4 * w_u) * w_v
    filt = atlas.filter[tid][..., None]
    return torch.where(filt == FILTER_BILINEAR, bilinear, n1)


def sample_latlong(atlas: TextureAtlas, tex_id, direction):
    """Lat-long environment lookup: theta = acos(y), phi = atan2(z, x) + pi,
    uv = (phi / 2pi, theta / pi)."""
    d = math3.normalize(direction)
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0]) + math.pi
    return sample(atlas, tex_id, torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1))
