"""Build, load, call and register the hand-written CUDA kernels: the one
binding every kernel module goes through.

Each ``soccdpt_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a plain-C shared library (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes`` at first use. All sources build
in parallel, one ``nvcc`` process each. Libraries go to
``build/soccdpt_torch_kernels/`` at the root of the checkout, named by a
hash of their source and of the headers (``csrc/*.cuh``) so an edited
source is never served by an old library.

* :class:`Entry` declares a C entry point once, with its argument types.
  Every entry takes the CUDA stream last and returns
  ``cudaGetLastError()`` after its launch; a call raises on a nonzero code.
* :func:`op` makes a kernel the custom op ``soccdpt::<name>``
  (``torch.library``, in the one ``Library`` fragment below): its CUDA
  implementation is the module's launcher, its CPU implementation the
  plain version, and a fake implementation gives the outputs' shapes, so
  CUDA graphs capture a call, ``torch.export`` records it as one node and
  ``torch.library.opcheck`` can test it.
* :func:`launches` counts the calls of each op's CUDA implementation (Python
  calls: a CUDA graph counts at its capture, not at its replays), and
  :func:`fallbacks` the card's calls that the layer above left to the plain
  path, as :func:`count_fallback` reports them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "soccdpt_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
SMS = 132  # streaming multiprocessors of an H100 SXM, which the launch planners fill

_libs: Dict[str, ctypes.CDLL] = {}
_build_seconds: Dict[str, float] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Build every source in ``csrc/`` that has no current library, all
    ``nvcc`` processes at once; return seconds per source built."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            out = _lib_path(src)
            if out.exists() or src.stem in _build_seconds:
                continue
            log = open(BUILD_DIR / f"{src.stem}.log", "w")
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT,
            )
            pending[src.stem] = (proc, tmp, out, log)
        failed = []
        for name, (proc, tmp, out, log) in pending.items():
            rc = proc.wait()
            log.close()
            _build_seconds[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            logs = "\n".join(
                (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return dict(_build_seconds)


def library_path(name: str) -> Path:
    """The shared library that ``csrc/<name>.cu`` builds to (it exists
    once :func:`build_all` or :func:`load` has run)."""
    return _lib_path(CSRC / f"{name}.cu")


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (registers, spills)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not _lib_path(src).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(src)))
        lib.soccdpt_error_string.restype = ctypes.c_char_p
        lib.soccdpt_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


# argument types of the C entries: a device or host pointer, an int, a
# 64-bit int, a float; a host array passes as a pointer to its element type
PTR, INT, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Entry:
    """The C entry point ``symbol`` of ``csrc/<lib>.cu``, declared once with
    the types of its arguments before the stream, which every entry takes
    last. ``what`` names the kernel in an error."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence, what: str):
        self.lib, self.symbol, self.what = lib, symbol, what
        self.argtypes = [*argtypes, PTR]

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream. A tensor passes its data
        pointer and ``None`` a null pointer; ints, floats and ctypes arrays
        pass as they are. Raises on a nonzero CUDA error code."""
        lib = load(self.lib)
        fn = getattr(lib, self.symbol)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = lib.soccdpt_error_string(rc).decode()
            raise RuntimeError(f"{self.what}: CUDA error {rc} ({msg})")


# The ops, registered through ``torch.library.Library``: cheaper to call than
# through ``torch.library.custom_op``, whose Python wrappers run on every
# call (PERF.md §6)
_LIB = torch.library.Library("soccdpt", "FRAGMENT")
_launches: Dict[str, int] = {}
_fallbacks: Dict[str, int] = {"upsample2x": 0, "unproject_slots": 0}


def op(schema: str, cuda: Callable, cpu: Callable, fake: Callable):
    """Define ``soccdpt::<schema>``: on CUDA tensors ``cuda`` (the launcher),
    each call counted under the op's name once it returns; on CPU tensors
    ``cpu`` (the plain version); ``fake`` gives the outputs' shapes and
    dtypes; autograd passes through to them. A device with no
    implementation raises. Returns the op's
    overload, ``torch.ops.soccdpt.<name>.default``."""
    name = schema[:schema.index("(")]

    def launch(*args):
        out = cuda(*args)
        _launches[name] += 1
        return out

    _LIB.define(schema)
    _LIB.impl(name, launch, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    # autograd passes through to the implementation: a caller that needs a
    # gradient goes through an ``autograd.Function`` or gets the plain
    # version's own graph, and the dispatch skips autograd's fallback
    _LIB.impl(name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"soccdpt::{name}", fake, lib=_LIB)
    _launches[name] = 0
    return getattr(torch.ops.soccdpt, name).default


def launches() -> Dict[str, int]:
    """Each op's CUDA-implementation calls so far, by op name in order."""
    return dict(sorted(_launches.items()))


def fallbacks() -> Dict[str, int]:
    """The card's calls left to the plain path so far: ``upsample2x``, the
    bilinear ``align_corners=True`` resizes that did not take the upsample
    kernel (``ops/resize.py``); ``unproject_slots``, the geometry tails that
    did not take the geometry kernel (``ops/geometry.py``)."""
    return dict(_fallbacks)


def count_fallback(name: str) -> None:
    """Count a card's call of ``name``'s function that the plain path took."""
    _fallbacks[name] += 1
