"""ctypes binding of the host library: the data pipeline's C++ loops.

The port's counterpart of ``soccdpt_tpu/native/__init__.py``. The library
is built with ``g++`` at first use from ``native/soccdpt_native.cpp`` (its
colour-table and voxelizer loops, shared with the JAX package, which
builds its own copy; the resize and unprojection loops it also holds
have no caller in the port and are not bound) and the port's PNG unfilter
``soccdpt_torch/csrc/host/png.cpp``, into
``build/soccdpt_torch_native/``, named by a hash of the sources so an
edited source is never served by an old library.

Every function has a plain numpy version, ``<name>_plain``, the JAX
module's fallback, which runs when the library cannot be built (no
``g++``). ``AVAILABLE`` says whether the library is in use; reading it
builds the library if needed, importing this module does not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCES = (
    REPO / "native" / "soccdpt_native.cpp",
    REPO / "soccdpt_torch" / "csrc" / "host" / "png.cpp",
)
BUILD_DIR = REPO / "build" / "soccdpt_torch_native"
CXX_FLAGS = ["-O3", "-fopenmp", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error: Optional[str] = None
_lock = threading.Lock()


def _lib_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsoccdpt_torch_native_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile to a file of this process's own, then rename it into place,
    so processes that build at once never load a half-written library."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{proc.stderr}")
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    signatures = {
        "rgb_to_class": ([u8p, i64, u8p, i32, i32p], None),
        "rgb_to_bool_masks": ([u8p, i64, u8p, i32, u8p], None),
        "voxelize_points": ([f32p, i32p, i64, f32p, i32, i32, i32, i32, f32p], None),
        "png_unfilter": ([u8p, i64, i64, i32, u8p], i64),
        "soccdpt_native_version": ([], i32),
    }
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def load() -> Optional[ctypes.CDLL]:
    """The library, built if needed; None if it cannot be built or loaded
    (``build_error()`` says why)."""
    global _lib, _tried, _build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = f"{type(e).__name__}: {e}"
        return _lib


def build_error() -> Optional[str]:
    load()
    return _build_error


def __getattr__(name):
    if name == "AVAILABLE":
        return load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# --- colour tables ------------------------------------------------------------


def rgb_to_class_plain(seg: np.ndarray, colors: np.ndarray) -> np.ndarray:
    seg = np.ascontiguousarray(seg, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    out = np.zeros(seg.shape[:2], np.int32)
    for c in range(len(colors)):
        out[np.all(seg == colors[c], axis=-1)] = c
    return out


def rgb_to_class(seg: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 + (C, 3) uint8 colour table -> (H, W) int32 class
    map, 0 where no colour matches."""
    lib = load()
    if lib is None:
        return rgb_to_class_plain(seg, colors)
    seg = np.ascontiguousarray(seg, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    h, w = seg.shape[:2]
    out = np.zeros(h * w, np.int32)
    lib.rgb_to_class(_ptr(seg, ctypes.c_uint8), h * w, _ptr(colors, ctypes.c_uint8),
                     len(colors), _ptr(out, ctypes.c_int32))
    return out.reshape(h, w)


def rgb_to_bool_masks_plain(seg: np.ndarray, colors: np.ndarray) -> np.ndarray:
    seg = np.ascontiguousarray(seg, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    out = np.zeros((*seg.shape[:2], len(colors)), bool)
    for c in range(len(colors)):
        out[..., c] = np.all(seg == colors[c], axis=-1)
    return out


def rgb_to_bool_masks(seg: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W, C) bool, one mask per colour."""
    lib = load()
    if lib is None:
        return rgb_to_bool_masks_plain(seg, colors)
    seg = np.ascontiguousarray(seg, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    h, w = seg.shape[:2]
    C = len(colors)
    out = np.zeros(h * w * C, np.uint8)
    lib.rgb_to_bool_masks(_ptr(seg, ctypes.c_uint8), h * w, _ptr(colors, ctypes.c_uint8),
                          C, _ptr(out, ctypes.c_uint8))
    return out.reshape(h, w, C).astype(bool)


# --- voxelizer ------------------------------------------------------------------


def voxelize_points_plain(points, semantics, occupancy_shape, grid_size, num_classes):
    points = np.ascontiguousarray(points, np.float32)
    semantics = np.ascontiguousarray(semantics, np.int32)
    grid = np.zeros((*grid_size, num_classes), np.float32)
    ok = np.isfinite(points).all(axis=1)
    pts, sem = points[ok], semantics[ok]
    ijk = (pts / np.asarray(occupancy_shape, np.float32) * np.asarray(grid_size)).astype(int)
    inb = ((ijk > 0) & (ijk < np.asarray(grid_size))).all(axis=1)
    ijk, sem = ijk[inb], sem[inb]
    valid_cls = (sem >= 0) & (sem < num_classes)
    ijk, sem = ijk[valid_cls], sem[valid_cls]
    np.add.at(grid, (ijk[:, 0], ijk[:, 1], ijk[:, 2], sem), 1)
    return grid


def voxelize_points(
    points: np.ndarray,
    semantics: np.ndarray,
    occupancy_shape: Tuple[float, float, float],
    grid_size: Tuple[int, int, int],
    num_classes: int,
) -> np.ndarray:
    """(N, 3) float32 points in meters + (N,) int32 classes -> (gx, gy, gz,
    C) float32 counts. Index 0 of every axis is dropped (``0 < ijk <
    grid``), as the GT pipeline of the reference does."""
    lib = load()
    if lib is None:
        return voxelize_points_plain(points, semantics, occupancy_shape, grid_size, num_classes)
    points = np.ascontiguousarray(points, np.float32)
    semantics = np.ascontiguousarray(semantics, np.int32)
    if points.ndim != 2 or points.shape[1] != 3 or len(semantics) != len(points):
        raise ValueError(f"points {points.shape} and semantics {semantics.shape} do not fit")
    gx, gy, gz = grid_size
    grid = np.zeros((gx, gy, gz, num_classes), np.float32)
    shape = np.asarray(occupancy_shape, np.float32)
    lib.voxelize_points(_ptr(points, ctypes.c_float), _ptr(semantics, ctypes.c_int32),
                        len(points), _ptr(shape, ctypes.c_float),
                        gx, gy, gz, num_classes, _ptr(grid, ctypes.c_float))
    return grid


# --- PNG rows -------------------------------------------------------------------


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_unfilter_plain(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Types None, Sub and Up a row at a time in numpy; Average and Paeth a
    pixel at a time (a recurrence along the row): for small images."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, rowbytes + 1)
    out = np.empty((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            n = rowbytes // bpp
            cur = np.cumsum(line.reshape(n, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.zeros(rowbytes + bpp, np.int64)  # bpp zeros of left border first
            up = np.concatenate([np.zeros(bpp, np.int64), prev.astype(np.int64)])
            src = line.astype(np.int64)
            for i in range(0, rowbytes, bpp):
                a, b, c = cur[i:i + bpp], up[i + bpp:i + 2 * bpp], up[i:i + bpp]
                pred = (a + b) >> 1 if ftype == 3 else _paeth(a, b, c)
                cur[i + bpp:i + 2 * bpp] = (src[i:i + bpp] + pred) & 255
            cur = cur[bpp:].astype(np.uint8)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def png_unfilter(raw, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG data, ``height * (1 + rowbytes)`` bytes -> the
    (height, rowbytes) uint8 rows with every filter undone."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size != height * (rowbytes + 1):
        raise ValueError(f"PNG data holds {buf.size} bytes, expected {height * (rowbytes + 1)}")
    lib = load()
    if lib is None:
        return png_unfilter_plain(raw, height, rowbytes, bpp)
    out = np.empty((height, rowbytes), np.uint8)
    bad = lib.png_unfilter(_ptr(buf, ctypes.c_uint8), height, rowbytes, bpp,
                           _ptr(out, ctypes.c_uint8))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out
