"""Minimal PNG codec on the standard library (``zlib``) + numpy.

Encodes 8-bit RGB/RGBA with filter 0 (cheap to decode). Decodes
non-interlaced 8-bit grayscale, gray+alpha, RGB and RGBA with any of the
five row filters: the repository's goldens, the port's own files and the
images other writers (PIL included) embed in .glb files. Average and
Paeth rows are unfiltered pixel by pixel in Python, so adaptively
filtered images decode in seconds, not milliseconds.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    a = np.zeros(bpp, np.int32)  # left pixel
    c = np.zeros(bpp, np.int32)  # upper-left pixel
    for x in range(0, line.shape[0], bpp):
        b = prior[x : x + bpp].astype(np.int32)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        line[x : x + bpp] = (line[x : x + bpp].astype(np.int32) + pred) & 0xFF
        a = line[x : x + bpp].astype(np.int32)
        c = b


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    left = np.zeros(bpp, np.int32)
    for x in range(0, line.shape[0], bpp):
        pred = (left + prior[x : x + bpp].astype(np.int32)) // 2
        line[x : x + bpp] = (line[x : x + bpp].astype(np.int32) + pred) & 0xFF
        left = line[x : x + bpp].astype(np.int32)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (gray is replicated, missing alpha
    is 255)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat = 8, []
    width = height = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            width, height, depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or interlace != 0 or color_type not in _CHANNELS:
                raise ValueError(f"unsupported PNG (depth {depth}, type {color_type}, interlace {interlace})")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if width is None:
        raise ValueError("PNG has no IHDR chunk")
    bpp = _CHANNELS[color_type]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = raw[y, 0], raw[y, 1:].copy()
        if kind == 1:  # Sub: a running sum along each channel
            line = (np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.int64) & 0xFF)
            line = line.astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            line = ((line.astype(np.int32) + prior) & 0xFF).astype(np.uint8)
        elif kind == 3:  # Average
            _average_row(line, prior, bpp)
        elif kind == 4:  # Paeth
            _paeth_row(line, prior, bpp)
        elif kind != 0:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = line
        prior = line
    img = out.reshape(height, width, bpp)
    if bpp in (1, 2):
        gray = np.repeat(img[..., :1], 3, axis=-1)
        alpha = img[..., 1:2] if bpp == 2 else np.full_like(img[..., :1], 255)
        return np.concatenate([gray, alpha], axis=-1)
    if bpp == 3:
        return np.concatenate([img, np.full_like(img[..., :1], 255)], axis=-1)
    return img
