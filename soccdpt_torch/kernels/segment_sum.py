"""K2: dense segment-sum, the occupancy voxelizer's accumulation, and its
gradient.

Replaces the TPU kernel of ``soccdpt_tpu/ops/sorted_segment_sum.py``
(``sorted_segment_sum_tpu``: ``_kernel`` with its on-device ``_schedule``,
used by ``segment_sum_sorted_pallas`` and
``ops/geometry.py::_accumulate_sort``). The CUDA source is
``csrc/segment_sum.cu``.

Contract: ``out[s, c] = sum over rows n with lin[n] == s of vals[n, c]``
into ``(S, C)`` f32; rows with ``lin >= S`` or ``lin < 0`` are dropped
and their values never read. ``vals`` is ``(N, C)`` or ``(B, N, C)`` at
any strides, with ``lin`` holding its B*N keys in row order: the served
voxelizer hands over a channel-major view of the segmentation, read in
place.

Bound on the H100: memory. Per 1080p frame into the 256x256x32 grid the
kernel reads 2,073,600 int32 keys and the kept rows' f32 values and
writes the 2,097,152 x 3 f32 grid (25 MB): about 16 us at 3.35 TB/s.
The TPU's sort and one-hot matmuls worked around its serial scatter;
here a memset zeroes the grid and one kernel scatters into it: a warp
sums the runs of equal slots among 128 consecutive rows in registers
(the rows come in pixel order, and neighbouring pixels share voxels) and
sends one f32 reduction a run and channel into the L2. Atomics change
the add order, so results match a serial sum to f32 rounding, not to
bits. Two CUDA launches a call: the memset and the kernel.

Gradient. ``segment_sum`` is an ``autograd.Function``: the gradient of
``vals`` gathers the cotangent at each kept row's slot and is 0 on a
dropped row (JAX's ``_accumulate_sort_bwd``); ``lin`` has none. On CUDA
the gather is a kernel of its own (``segment_sum_backward``); the forward
saves ``lin`` only.

``segment_sum`` and ``segment_sum_backward`` call the ops
``soccdpt::segment_sum`` and ``soccdpt::segment_sum_backward``
(``_build.op``), which launch the kernels for CUDA tensors and run
``segment_sum_plain`` / ``segment_sum_backward_plain`` for CPU tensors;
``kernels.ops.launches()`` counts each op's launches.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import I64, INT, PTR


def segment_sum_plain(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` over the kept rows (f32,
    f64 for f64 values)."""
    lin, vals = lin.reshape(-1), vals.reshape(-1, vals.shape[-1])
    keep = (lin >= 0) & (lin < num_slots)
    dtype = torch.promote_types(vals.dtype, torch.float32)
    out = torch.zeros((num_slots, vals.shape[-1]), dtype=dtype, device=vals.device)
    return out.index_add_(0, lin[keep].long(), vals[keep].to(dtype))


def segment_sum_backward_plain(lin: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """The plain gradient: ``(lin.numel(), C)``, the cotangent row of each
    kept row's slot (``index_select``), 0 on a dropped row."""
    lin = lin.reshape(-1)
    keep = (lin >= 0) & (lin < cot.shape[0])
    if cot.shape[0] == 0:
        return cot.new_zeros((lin.numel(), cot.shape[1]))
    taken = cot.index_select(0, torch.where(keep, lin, 0).long())
    return torch.where(keep[:, None], taken, 0.0)


def _keys(lin: torch.Tensor, rows: int, device: torch.device) -> torch.Tensor:
    if lin.numel() != rows or lin.device != device:
        raise ValueError(f"segment sum takes {rows} keys on {device}, got "
                         f"{tuple(lin.shape)} on {lin.device}")
    return lin.reshape(-1).to(torch.int32).contiguous()


def _launch(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    if vals.dim() not in (2, 3) or vals.dtype != torch.float32:
        raise ValueError(f"segment sum takes f32 vals (N, C) or (B, N, C), got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    v = vals if vals.dim() == 3 else vals.unsqueeze(0)
    B, N, C = v.shape
    if B * N >= 2**31 or not 0 <= num_slots < 2**31:
        raise ValueError(f"segment sum takes fewer than 2^31 rows and slots, got {B * N} "
                         f"rows and {num_slots} slots")
    lin = _keys(lin, B * N, vals.device)
    out = torch.empty((num_slots, C), dtype=torch.float32, device=vals.device)
    _FORWARD(vals.device, lin, v, out, B, N, C, *v.stride(), num_slots)
    return out


def _launch_backward(lin: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    if cot.dim() != 2:
        raise ValueError(f"the segment-sum gradient takes a (S, C) cotangent, got "
                         f"{tuple(cot.shape)}")
    cot = cot.float().contiguous()
    lin = _keys(lin, lin.numel(), cot.device)
    S, C = cot.shape
    grad = torch.empty((lin.numel(), C), dtype=torch.float32, device=cot.device)
    _BACKWARD(cot.device, lin, cot, grad, lin.numel(), C, S)
    return grad


_FORWARD = _build.Entry("segment_sum", "soccdpt_segment_sum",
                        [PTR] * 3 + [INT] * 3 + [I64] * 3 + [INT], "segment sum kernel")
_BACKWARD = _build.Entry("segment_sum", "soccdpt_segment_sum_backward",
                         [PTR] * 3 + [I64, INT, INT], "segment sum backward kernel")
_segment_sum_op = _build.op(
    "segment_sum(Tensor lin, Tensor vals, int num_slots) -> Tensor", _launch, segment_sum_plain,
    lambda lin, vals, num_slots: vals.new_empty(
        (num_slots, vals.shape[-1]), dtype=torch.promote_types(vals.dtype, torch.float32)))
_segment_sum_backward_op = _build.op(
    "segment_sum_backward(Tensor lin, Tensor cot) -> Tensor", _launch_backward,
    segment_sum_backward_plain, lambda lin, cot: cot.new_empty((lin.numel(), cot.shape[1])))


def segment_sum_backward(lin: torch.Tensor, cot: torch.Tensor) -> torch.Tensor:
    """The gradient of ``vals`` from the (S, C) cotangent, ``(lin.numel(),
    C)``: the gather kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cot.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment sum runs on cuda or cpu, not {cot.device}")
    return _segment_sum_backward_op(lin, cot)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lin, vals, num_slots):
        ctx.save_for_backward(lin)
        ctx.vals_shape = vals.shape
        return _segment_sum_op(lin, vals, num_slots)

    @staticmethod
    def backward(ctx, cot):
        (lin,) = ctx.saved_tensors
        grad = segment_sum_backward(lin, cot).reshape(ctx.vals_shape)
        return None, grad, None


def segment_sum(lin: torch.Tensor, vals: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(num_slots, C) sums of ``vals`` rows into slot ``lin``: the CUDA
    kernel for CUDA tensors (f32), the plain version for CPU tensors.
    Differentiable with respect to ``vals``."""
    if vals.device.type == "cuda":
        vals = vals.float()  # cast outside the Function: the gradient keeps vals' dtype
    elif vals.device.type == "cpu":
        vals = vals.to(torch.promote_types(vals.dtype, torch.float32))
    else:
        raise ValueError(f"segment sum runs on cuda or cpu, not {vals.device}")
    return _SegmentSum.apply(lin, vals, num_slots)
