"""K2: dense segment-sum, the occupancy voxelizer's accumulation.

Replaces the TPU kernel of ``soccdpt_tpu/ops/sorted_segment_sum.py``
(``sorted_segment_sum_tpu``: ``_kernel`` with its on-device ``_schedule``,
used by ``segment_sum_sorted_pallas`` and
``ops/geometry.py::_accumulate_sort``). The CUDA source is
``csrc/segment_sum.cu``.

Contract: ``out[s, c] = sum over rows n with lin[n] == s of vals[n, c]``
into ``(S, C)`` f32; rows with ``lin >= S`` or ``lin < 0`` are dropped.

Bound on the H100: memory. Per 1080p frame into the 256x256x32 grid the
kernel reads 2,073,600 int32 keys and f32 (N, 3) values (33 MB) and
writes the 2,097,152 x 3 f32 grid (25 MB): about 17 us at 3.35 TB/s.
The TPU's sort and one-hot matmuls worked around its serial scatter;
here a direct f32 atomicAdd per (row, channel) into a zeroed output
reads each input once and touches each cell in L2, with no sort.
Atomics change the add order, so results match a serial sum to f32
rounding, not to bits.

``segment_sum`` launches the kernel for CUDA tensors and runs
``segment_sum_plain`` for CPU tensors; ``segment_sum.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def segment_sum_plain(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` over the kept rows."""
    keep = (lin >= 0) & (lin < num_slots)
    out = torch.zeros((num_slots, vals.shape[-1]), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, lin[keep].long(), vals[keep].float())


def _launch(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    if lin.dim() != 1 or vals.dim() != 2 or vals.shape[0] != lin.shape[0]:
        raise ValueError(
            f"segment sum takes lin (N,) and vals (N, C), got {tuple(lin.shape)} "
            f"and {tuple(vals.shape)}"
        )
    if lin.device != vals.device:
        raise ValueError("lin and vals must be on one device")
    lin = lin.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    n_rows, C = vals.shape
    out = torch.zeros((num_slots, C), dtype=torch.float32, device=vals.device)
    lib = _build.load("segment_sum")
    fn = lib.soccdpt_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        lin.data_ptr(), vals.data_ptr(), out.data_ptr(), n_rows, C, num_slots,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    _build.check(lib, rc, "segment sum kernel")
    segment_sum.launches += 1
    return out


def segment_sum(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(num_slots, C) f32 sums of ``vals`` rows into slot ``lin``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if vals.device.type == "cuda":
        return _launch(lin, vals, num_slots)
    if vals.device.type != "cpu":
        raise ValueError(f"segment sum runs on cuda or cpu, not {vals.device}")
    return segment_sum_plain(lin, vals, num_slots)


segment_sum.launches = 0
