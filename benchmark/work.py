"""The yardstick of the kernels: the chip's peaks and the bytes and
operations each kernel's work needs at given shapes. The calls a request
makes at a configuration's sizes are its trunk family's
(``benchmark/reference/<family>.py``: ``k1_calls``, ``k6_calls``).

The counts are those of ``chip_smoke.py`` (``k1_bytes_flops``,
``k6_bytes_flops``, ``k2_bytes``, ``bound``), copied
so that the benchmark does not depend on the program's scripts: each
input byte read once, each output byte written once.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, at the 700 W limit


def bound(nbytes: float, flops: float, dtype_name: str = "bfloat16") -> Tuple[float, str]:
    """(least seconds the work needs, "bytes" or "operations": which bounds it)."""
    byte_s = nbytes / HBM_BYTES_PER_S
    flop_s = flops / PEAK_FLOPS[dtype_name]
    return max(byte_s, flop_s), "bytes" if byte_s >= flop_s else "operations"


def k1_bytes_flops(Bw: int, H: int, N: int, d: int, nW: int, itemsize: int):
    """K1, window attention of Bw windows of N tokens: q, k, v and the
    output, the f32 (H, N, N) bias and, when shifted, the f32 (nW, N, N)
    mask; two products."""
    nbytes = 4 * Bw * H * N * d * itemsize + H * N * N * 4 + (nW * N * N * 4 if nW else 0)
    return nbytes, 4 * Bw * H * N * N * d


def k6_bytes_flops(B: int, H: int, T: int, d: int, itemsize: int, bias_itemsize: int):
    """K6, global attention: q, k, v, the output and the (H, T, T) bias of
    ``bias_itemsize`` bytes an element (0: a call without a bias)."""
    return 4 * B * H * T * d * itemsize + H * T * T * bias_itemsize, 4 * B * H * T * T * d


def k2_bytes(rows: int, kept: int, num_slots: int, C: int) -> int:
    """K2, the voxelizer's segment sum: the int32 key of every row, the f32
    values of the kept rows, ``num_slots`` rows of C f32 written (the
    whole grid, or the cells the kept rows reduce into)."""
    return rows * 4 + kept * C * 4 + num_slots * C * 4
