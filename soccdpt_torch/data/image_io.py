"""Image files, resizes and CSV columns without OpenCV or pandas.

The JAX package's data layer reads and writes its trees with ``cv2`` and
``pandas``; the machine that runs the port has neither, so this module
keeps their conventions with numpy, ``zlib`` and the host library
(``soccdpt_torch/native.py``):

* ``imread`` / ``imwrite`` for PNG, as ``cv2`` does them: colour images are
  BGR in memory; ``IMREAD_COLOR`` gives 8-bit BGR whatever the file holds
  (grey replicated, 16 bits cut to their high byte, alpha dropped);
  ``IMREAD_GRAYSCALE`` gives 8-bit grey; ``IMREAD_UNCHANGED`` gives the
  file's own channels and depth (a 16-bit grey image as ``uint16 (H,
  W)``). All five row filters are read; Average and Paeth rows are undone
  by ``native.png_unfilter``. Interlaced and sub-byte files are refused.
* ``resize`` with ``cv2.resize``'s three modes the data layer uses:
  ``INTER_LINEAR`` (on ``uint8`` in cv2's fixed point: 11-bit weights, the
  rows then blended as its SIMD loop does; on float32 as ``a + (b - a) t``
  with a fused multiply-add), bit for bit with the OpenCV the tests hold
  it to (float32 with more than one channel within a few units in the
  last place),
  ``INTER_CUBIC`` (a = -0.75, taps clamped at the borders) and
  ``INTER_NEAREST`` (``floor(x * src / dst)``). A same-size resize is a
  copy.
* ``bgr_to_gray``, ``cv2.cvtColor(..., COLOR_BGR2GRAY)`` on ``uint8``.
* ``read_csv_column`` / ``read_csv_columns`` for the BDD index and
  trajectory files (quoted fields may span lines).
"""
from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC = 0, 1, 2

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
RESIZE_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


# --- PNG ------------------------------------------------------------------------


def inflate_png(data: bytes) -> Tuple[Tuple[int, int, int, int], bytes]:
    """PNG bytes -> ((width, height, bit depth, samples per pixel), the
    inflated rows, each led by its filter type)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG file without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {color} at {depth} bits is not supported")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    return (width, height, depth, _CHANNELS[color]), zlib.decompress(b"".join(idat))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the stored samples: (H, W) or (H, W, C), RGB(A) order,
    uint8 or uint16 (native byte order)."""
    from .. import native

    (width, height, depth, channels), raw = inflate_png(data)
    bpp = channels * depth // 8
    rows = native.png_unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    img = rows.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply one PNG filter type to every row of (H, rowbytes) uint8."""
    x = rows.astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        from ..native import _paeth

        pred = _paeth(a, b, c)
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type=0) -> bytes:
    """(H, W) grey or (H, W, 3|4) RGB(A), uint8 or uint16 -> PNG bytes.
    ``filter_type``: one type 0-4 for every row, or a sequence with one
    type per row. zlib at level 1, cv2's default."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG holds uint8 or uint16, not {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * img.dtype.itemsize
    height, width = img.shape[:2]
    bpp = channels * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(height, width * bpp)
    types = np.broadcast_to(np.asarray(filter_type, np.uint8), (height,))
    body = np.empty((height, width * bpp + 1), np.uint8)
    body[:, 0] = types
    for t in np.unique(types):
        sel = types == t
        body[sel, 1:] = _filter_rows(rows, bpp, int(t))[sel]

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 1)) + chunk(b"IEND", b""))


def imread(path: str, flags: int = IMREAD_COLOR):
    """``cv2.imread`` for PNG files; None where the file is missing."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as fh:
        img = decode_png(fh.read())
    if flags == IMREAD_UNCHANGED:
        if img.ndim == 3 and img.shape[2] == 2:
            raise ValueError("grey + alpha PNG files are not supported")
        return img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] in (2, 4):  # alpha dropped
        img = img[..., :-1]
    if flags == IMREAD_GRAYSCALE:
        if img.ndim == 3:
            raise ValueError("IMREAD_GRAYSCALE of a colour PNG is not supported")
        return img
    if flags != IMREAD_COLOR:
        raise ValueError(f"unknown imread flags {flags}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])


def imwrite(path: str, img: np.ndarray, filter_type=0) -> bool:
    """``cv2.imwrite`` for PNG files: (H, W) grey or (H, W, 3|4) BGR(A)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    data = encode_png(img, filter_type)
    with open(path, "wb") as fh:
        fh.write(data)
    return True


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` on uint8: Y = 0.299 R + 0.587 G
    + 0.114 B in 15-bit fixed point, rounded (grey pixels stay as they are)."""
    x = img.astype(np.int32)
    y = x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


# --- resize ---------------------------------------------------------------------


def _taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 bilinear's source index and fraction for each output position,
    as cv2 takes them: ``f = (d + 0.5) * (src / dst) - 0.5`` in float64,
    cast to float32, split into ``floor(f)`` and the rest; an index before
    the first or past the last source pixel is pinned to it with fraction
    0."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    lo, hi = s < 0, s >= src - 1
    f[lo | hi] = 0.0
    s[lo] = 0
    s[hi] = src - 1
    return s, f


def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateCubic`` (a = -0.75): (n, 4) float32 weights of
    the float64 fractions ``f``."""
    A = -0.75
    x1 = f + 1.0
    w0 = ((A * x1 - 5.0 * A) * x1 + 8.0 * A) * x1 - 4.0 * A
    w1 = ((A + 2.0) * f - (A + 3.0)) * f * f + 1.0
    g = 1.0 - f
    w2 = ((A + 2.0) * g - (A + 3.0)) * g * g + 1.0
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=1).astype(np.float32)


def _cubic_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bicubic's first source index and (dst, 4) weights; the fraction in
    float64, as cv2 keeps it."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    return s - 1, _cubic_weights(f - s)


def _resize_linear_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """uint8 bilinear in cv2's fixed point: horizontal sums with 11-bit
    weights (exact in int32), then two rows blended as its SIMD loop does:
    ``(((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2) >> 2``. The
    rows' fractions are not pinned at the borders, their indices are
    clamped instead, as cv2 fetches rows."""
    h, w = img.shape[:2]
    one = np.float32(RESIZE_COEF_SCALE)
    sx, fx = _taps(dw, w)
    shape = (1, dw) + (1,) * (img.ndim - 2)
    ax0 = np.rint((np.float32(1.0) - fx) * one).astype(np.int32).reshape(shape)
    ax1 = np.rint(fx * one).astype(np.int32).reshape(shape)
    x = img.astype(np.int32)
    rows = x[:, sx] * ax0
    rows += x[:, np.minimum(sx + 1, w - 1)] * ax1
    rows >>= 4  # (at most 255 * 2048) >> 4 fits the SIMD loop's int16
    scale = 1.0 / (dh / h)
    fy = ((np.arange(dh, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sy = np.floor(fy).astype(np.int64)
    fy = fy - sy.astype(np.float32)
    bshape = (dh,) + (1,) * (img.ndim - 1)
    by0 = np.rint((np.float32(1.0) - fy) * one).astype(np.int32).reshape(bshape)
    by1 = np.rint(fy * one).astype(np.int32).reshape(bshape)
    out = rows[np.clip(sy, 0, h - 1)] * by0
    out >>= 16
    r1 = rows[np.clip(sy + 1, 0, h - 1)] * by1
    r1 >>= 16
    out += r1
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _lerp_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """Float bilinear's taps: as ``_taps``, with the fraction kept in
    float64 and cast to float32 last."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    lo, hi = s < 0, s >= src - 1
    f[lo | hi] = 0.0
    s[lo] = 0
    s[hi] = src - 1
    return s, f.astype(np.float32)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``a + (b - a) * t`` with one rounding of the multiply-add,
    as a fused multiply-add gives it (the product of two float32 values is
    exact in float64)."""
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def _resize_linear_float(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """float32 bilinear as cv2 computes it: each pass ``a + (b - a) * t``,
    rows first."""
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    sx, fx = _lerp_taps(dw, w)
    rows = _lerp(x[:, sx], x[:, np.minimum(sx + 1, w - 1)],
                 fx.reshape((1, dw) + (1,) * (img.ndim - 2)))
    sy, fy = _lerp_taps(dh, h)
    out = _lerp(rows[sy], rows[np.minimum(sy + 1, h - 1)], fy.reshape((dh,) + (1,) * (img.ndim - 1)))
    return out.astype(img.dtype)


def _resize_cubic_float(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """float32 bicubic, rows first: taps summed left to right in float32,
    each tap's index clamped to the image."""
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    sx, wx = _cubic_taps(dw, w)
    sy, wy = _cubic_taps(dh, h)
    shape = (1, dw) + (1,) * (img.ndim - 2)
    # only the source rows some output row reads
    need = np.unique(np.clip(sy[:, None] + np.arange(4), 0, h - 1))
    xs = x[need]
    acc = xs[:, np.clip(sx, 0, w - 1)] * wx[:, 0].reshape(shape)
    for k in range(1, 4):
        acc = acc + xs[:, np.clip(sx + k, 0, w - 1)] * wx[:, k].reshape(shape)
    rows = np.zeros((h, dw) + img.shape[2:], np.float32)
    rows[need] = acc
    bshape = (dh,) + (1,) * (img.ndim - 1)
    out = rows[np.clip(sy, 0, h - 1)] * wy[:, 0].reshape(bshape)
    for k in range(1, 4):
        out = out + rows[np.clip(sy + k, 0, h - 1)] * wy[:, k].reshape(bshape)
    return out.astype(img.dtype)


def _resize_nearest(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    return img[sy][:, sx]


def resize(img: np.ndarray, dsize: Tuple[int, int], interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=...)``; ``dsize`` is (width,
    height). uint8 and float32 (and, nearest, any dtype); (H, W) or
    (H, W, C)."""
    img = np.asarray(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    if (dh, dw) == img.shape[:2]:
        return img.copy()
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, dw, dh)
    if img.dtype == np.uint8 and interpolation == INTER_LINEAR:
        return _resize_linear_u8(img, dw, dh)
    if img.dtype != np.float32:
        raise ValueError(f"resize mode {interpolation} on {img.dtype} is not supported")
    if interpolation == INTER_LINEAR:
        return _resize_linear_float(img, dw, dh)
    if interpolation == INTER_CUBIC:
        return _resize_cubic_float(img, dw, dh)
    raise ValueError(f"unknown interpolation {interpolation}")


# --- CSV ------------------------------------------------------------------------


def _read_csv(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, rows of strings); quoted fields may span lines."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [r for r in reader if r]
    return header, rows


def read_csv_column(path: str, column) -> List[str]:
    """One column of a CSV file with a header row, by name or position,
    as strings."""
    header, rows = _read_csv(path)
    idx = header.index(column) if isinstance(column, str) else int(column)
    return [r[idx] for r in rows]


def read_csv_columns(path: str) -> Dict[str, List[str]]:
    """Every column of a CSV file with a header row, by name, as strings."""
    header, rows = _read_csv(path)
    return {name: [r[i] for r in rows] for i, name in enumerate(header)}
