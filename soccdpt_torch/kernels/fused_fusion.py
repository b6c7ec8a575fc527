"""K4: the tail of a DPT fusion block, fused.

Replaces the TPU kernel of ``soccdpt_tpu/ops/fused_fusion.py``
(``fused_rcu_tail``); the function to match is that file's
``xla_fusion_tail``. That module's docstring also names a
``fused_rcu_add`` for the block's skip branch, but the file defines none:
there is nothing more to port. The CUDA source is ``csrc/fused_fusion.cu``.

Contract: ``out = out_conv1x1(upsample2x(s + RCU(s)))`` as ``(B, 2H, 2W, C)``
over NHWC ``s (B, H, W, C)``: the residual conv unit of K3 (residual
included), a 2x bilinear upsample with ``align_corners=True`` and a 1x1
conv with ``out_w`` ``(1, 1, C, C)`` or ``(C, C)`` (in, out) and ``out_b``
``(C,)``. It is the tail of ``models/dpt.py::FeatureFusionBlock`` (its
``res_conv_unit2``, ``out_conv`` and upsample) when the block has no
BatchNorm and upsamples exactly 2x.

Order of the 1x1 conv and the upsample: the kernel and the plain version
run the conv first, at input resolution, as the port's and the JAX
package's ``FeatureFusionBlock`` do; the Pallas kernel and
``xla_fusion_tail`` run it after the upsample. Both are linear maps, one
per pixel and one per channel, so they commute: the same function, with
a quarter of the conv's work (0.54 against 2.15 GFLOP at the flagship's
``refinenet1``), rounded at other places in bf16.

Bound on the H100: operations (the RCU's two 3x3 convs). Two routes:

* bf16: five launches. The preparation of K3 (here of three weights);
  K3's two tensor-core convolutions, the second storing
  ``m = s + RCU(s)``; the same kernel as a 1x1 conv with the out-conv's
  bias; then the decoder's upsample kernel (``kernels/upsample.py``)
  with the clamped neighbour indices of the f32 route. ``tile`` raises here.
* f32: one launch on CUDA cores; everything between ``s`` and the output
  stays in shared memory; ``tile`` (8 or 4) fixes its square tile of ``s``.

``fused_rcu_tail`` calls the op ``soccdpt::fused_rcu_tail``
(``_build.op``), which launches the kernels for CUDA tensors and runs
``fused_rcu_tail_plain`` for CPU tensors;
``kernels.ops.launches()["fused_rcu_tail"]`` counts its calls on the card.
Forward only, as in JAX; a standalone op.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, upsample
from ._build import INT, PTR
from ._conv import (
    CO,
    EPI_BIAS,
    EPI_CONV1,
    EPI_RESIDUAL,
    KC,
    Scratch,
    activation,
    check_activation,
    check_no_grad,
    check_shape,
    check_tile,
    conv_bf16,
    kernel_param,
    pick_tile,
    plan_conv,
    prepare_bf16,
    wgmma_bias,
)
from .fused_rcu import fused_rcu_plain


def smem_bytes(tile: int, C: int) -> int:
    """Shared memory of one block of the f32 route (``csrc/fused_fusion.cu``,
    ``launch``)."""
    halos = (tile + 4) ** 2 + (tile + 2) ** 2
    return 9 * KC * CO * 4 + ((tile + 6) ** 2 * KC + halos * (C + 8)) * 4


def fused_rcu_tail_plain(s, w1, b1, w2, b2, out_w, out_b):
    """The plain PyTorch version, in s's dtype: the RCU, the 1x1 conv, then
    ``F.interpolate`` (bilinear, ``align_corners=True``)."""
    C = s.shape[-1]
    m = fused_rcu_plain(s, w1, b1, w2, b2).permute(0, 3, 1, 2)
    wo = out_w.reshape(C, C).t().reshape(C, C, 1, 1).to(s.dtype)
    y = F.conv2d(m, wo, out_b.to(s.dtype))
    y = F.interpolate(y, size=(2 * s.shape[1], 2 * s.shape[2]), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def _check(s, w1, b1, w2, b2, out_w, out_b):
    check_activation(s, "fused_rcu_tail")
    C = s.shape[-1]
    for w, name in ((w1, "w1"), (w2, "w2")):
        check_shape(w, [(3, 3, C, C)], name)
    for b, name in ((b1, "b1"), (b2, "b2"), (out_b, "out_b")):
        check_shape(b, [(C,)], name)
    check_shape(out_w, [(1, 1, C, C), (C, C)], "out_w")


def _launch_f32(s, w1, b1, w2, b2, out_w, out_b, tile):
    B, H, W, C = s.shape
    tile = pick_tile(B, H, W, lambda t: smem_bytes(t, C), tile)
    params = [kernel_param(w1, (9, C, C), s), kernel_param(b1, (C,), s),
              kernel_param(w2, (9, C, C), s), kernel_param(b2, (C,), s),
              kernel_param(out_w, (C, C), s), kernel_param(out_b, (C,), s)]
    out = torch.empty((B, 2 * H, 2 * W, C), dtype=s.dtype, device=s.device)
    _F32(s.device, s, *params, out, B, H, W, C, tile)
    return out


def _launch_bf16(s, w1, b1, w2, b2, out_w, out_b):
    B, H, W, C = s.shape
    plan3, plan1 = plan_conv(B, H, W, C, taps=9), plan_conv(B, H, W, C, taps=1)
    scratch = Scratch([plan3, plan3, plan1], s.device)
    w1, w2, wo = prepare_bf16("fused_fusion", s, [w1, w2, out_w.reshape(1, 1, C, C)], scratch)
    b1, b2, bo = wgmma_bias(b1, s), wgmma_bias(b2, s), wgmma_bias(out_b, s)
    mid, m, y = (torch.empty_like(s) for _ in range(3))
    conv_bf16("fused_fusion", plan3, scratch, s, w1, b1, mid, EPI_CONV1)
    conv_bf16("fused_fusion", plan3, scratch, mid, w2, b2, m, EPI_RESIDUAL, residual=s)
    conv_bf16("fused_fusion", plan1, scratch, m, wo, bo, y, EPI_BIAS)
    return upsample.launch(y)


def _launch(s, w1, b1, w2, b2, out_w, out_b, tile):
    check_no_grad("fusion-block tail", s, w1, b1, w2, b2, out_w, out_b)
    s = activation(s)
    if s.dtype == torch.bfloat16:
        return _launch_bf16(s, w1, b1, w2, b2, out_w, out_b)
    return _launch_f32(s, w1, b1, w2, b2, out_w, out_b, tile)


def _fused_rcu_tail_fake(s, w1, b1, w2, b2, out_w, out_b, tile):
    B, H, W, C = s.shape
    return s.new_empty((B, 2 * H, 2 * W, C))


_F32 = _build.Entry("fused_fusion", "soccdpt_fused_fusion", [PTR] * 8 + [INT] * 5,
                    "fusion-block tail kernel")
_fused_rcu_tail_op = _build.op(
    "fused_rcu_tail(Tensor s, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor out_w, "
    "Tensor out_b, int? tile) -> Tensor", _launch,
    lambda s, w1, b1, w2, b2, out_w, out_b, tile: fused_rcu_tail_plain(
        s, w1, b1, w2, b2, out_w, out_b), _fused_rcu_tail_fake)


def fused_rcu_tail(
    s: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    out_w: torch.Tensor,
    out_b: torch.Tensor,
    tile: Optional[int] = None,
) -> torch.Tensor:
    """The fused fusion-block tail: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors. Returns (B, 2H, 2W, C) in s's dtype.
    ``tile`` (8 or 4, f32 only) fixes the f32 route's square tile of ``s``;
    a bf16 call with a ``tile`` raises ``ValueError``."""
    check_tile(s, tile, "fused_rcu_tail")
    if s.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_rcu_tail runs on cuda or cpu, not {s.device}")
    _check(s, w1, b1, w2, b2, out_w, out_b)
    return _fused_rcu_tail_op(s, w1, b1, w2, b2, out_w, out_b, tile)
