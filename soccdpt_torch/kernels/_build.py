"""Build and load the CUDA kernels at first use.

Each ``soccdpt_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a plain-C shared library (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``. All sources build in
parallel, one ``nvcc`` process each. Libraries go to
``build/soccdpt_torch_kernels/`` at the root of the checkout, named by a
hash of their source and of the headers (``csrc/*.cuh``) so an edited
source is never served by an old library. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` turns a nonzero
code into an exception.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "soccdpt_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

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


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.soccdpt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
