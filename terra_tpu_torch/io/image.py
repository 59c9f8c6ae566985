"""Image export/import (port of ``terra_tpu/io/image.py``): PNG and Radiance
HDR natively, other LDR formats through Pillow.

LDR export clamps to [0, 1] with an overflow warning and stores 8 bits per
channel; HDR export writes float radiance as RGBE. PNG is read and written
by this module's own codec (``zlib`` and ``struct``), whether or not Pillow
is installed, so one file decodes to the same floats on every machine:

  * written: 8-bit RGB, non-interlaced, filter 0 on every row, with CRCs;
  * read: 8-bit gray, gray + alpha, RGB, RGBA and palette images,
    non-interlaced, with all five row filters; alpha is dropped, as
    Pillow's ``convert("RGB")`` drops it. Other bit depths and interlaced
    files raise ``ValueError``.

``.jpg``, ``.bmp`` and ``.tga`` import Pillow inside the function, as the
reference does.
"""
from __future__ import annotations

import logging
import os
import struct
import zlib

import numpy as np
import torch

__all__ = ["save_image", "save_hdr", "load_image", "load_hdr", "srgb_decode",
           "write_png", "read_png"]

log = logging.getLogger("terra_tpu_torch")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per pixel of each colour type: gray, RGB, palette, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def srgb_decode(img: np.ndarray) -> np.ndarray:
    """Gamma 2.2 decode at load time (terra_texture_finalize,
    Terra.c:484-507)."""
    return np.power(np.clip(img, 0.0, 1.0), 2.2).astype(np.float32)


def _pil(path: str):
    """Pillow's ``Image`` module, for the LDR formats other than PNG."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading or writing {os.path.splitext(path)[1] or 'this format'} needs "
            "Pillow, which is not installed; use .png or .hdr") from e
    return Image


def save_image(path: str, img) -> None:
    """Save a float (H, W, 3) image (a tensor on any device, or an array)
    to PNG/JPG/BMP/TGA (clamped to [0,1], 8-bit) or .hdr.

    Emits the reference's overflow warning when values exceed 1
    (Visualization.cpp:334-341).
    """
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        save_hdr(path, img)
        return
    if (img > 1.0 + 1e-6).any():
        log.warning("image contains values > 1; clamping on LDR export (%s)", path)
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if ext == ".png":
        write_png(path, u8)
        return
    _pil(path).fromarray(u8).save(path)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (filter 0 on
    every row, not interlaced)."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"{path}: PNG export takes (H, W, 3) images, got {u8.shape}")
    h, w, _ = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter(path: str, raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of ``h`` rows of ``stride`` bytes; returns (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    data = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            cur = bytearray(row.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W, 3) uint8 (gray replicated, palette
    looked up, alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(_PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth != 8:
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported (8 only)")
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} is not supported")
    ch = _PNG_CHANNELS[color]
    px = _unfilter(path, zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG has no PLTE chunk")
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def save_hdr(path: str, img: np.ndarray) -> None:
    """Minimal Radiance RGBE (.hdr) writer (flat, non-RLE scanlines)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc > 1e-32
    m, e = np.frexp(np.maximum(maxc, 1e-32))
    exp = np.where(valid, e, 0)
    scale = np.where(valid, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader (flat and RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; next line is the resolution
    head_end = data.find(b"\n\n")
    if head_end < 0:
        raise ValueError("not a Radiance file")
    rest = data[head_end + 2:]
    nl = rest.find(b"\n")
    dims = rest[:nl].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported orientation {dims!r}")
    h, w = int(dims[1]), int(dims[3])
    payload = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if w >= 8 and len(payload) - pos >= 4 and payload[pos] == 2 and payload[pos + 1] == 2:
            # adaptive RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x: x + count - 128, c] = payload[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x: x + count, c] = np.frombuffer(payload, np.uint8, count, pos)
                        pos += count
                        x += count
        else:
            rgbe[y] = np.frombuffer(payload, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def load_image(path: str, srgb: bool = True) -> np.ndarray:
    """Load an LDR/HDR image to float32 (H, W, 3); LDR optionally
    sRGB-decoded like the reference's finalize pass."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".png":
        arr = read_png(path).astype(np.float32) / 255.0
    else:
        with _pil(path).open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return srgb_decode(arr) if srgb else arr
