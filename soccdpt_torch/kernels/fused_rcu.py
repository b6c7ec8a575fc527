"""K3: the DPT decoder's residual conv unit, fused.

Replaces the TPU kernel of ``soccdpt_tpu/ops/fused_rcu.py`` (``fused_rcu``);
the function to match is that file's ``xla_rcu``, which is
``models/dpt.py::ResidualConvUnit`` with ``use_bn=False``. The CUDA source
is ``csrc/fused_rcu.cu``.

Contract: ``out = x + conv3x3(relu(conv3x3(relu(x)) + b1)) + b2`` over NHWC
``x (B, H, W, C)``, both convolutions with zero padding 1, HWIO weights
``(3, 3, C, C)`` and biases ``(C,)`` (the JAX layout; ``_conv.conv_weights``
takes a port ``nn.Conv2d`` there). Inputs f32 or bf16, C a multiple of 8,
any H and W; the output has x's dtype; sums are f32.

Bound on the H100: operations. At the flagship's widths (C = 256) one RCU
at 64 x 64 does 2 x 9 x 256 x 256 multiply-adds per pixel, 9.7 GFLOP,
against 4 MB of bf16 activations and weights. Two routes:

* bf16: three launches. One prepares the call (both weights to bf16 in
  the kernel's layout, the split-K counters to zero); then two of the
  tensor-core convolution (``csrc/conv_wgmma.cuh``; wgmma fed by TMA),
  planned by ``_conv.plan_conv``. conv1 takes relu(x) and stores the
  intermediate ``mid`` in bf16 (8 MB at 128 x 128 x 256, held by the 50 MB
  L2); conv2 reads it through the TMA box that zero-fills its padding and
  adds b2 and x. ``tile`` raises here.
* f32: one launch on CUDA cores, the intermediate kept in shared memory,
  conv1 recomputed on a 1-pixel halo; ``tile`` (8 or 4) fixes its square
  tile. The tensor cores would round f32 to TF32, about three digits,
  where the Pallas tests hold f32 to 2e-4.

``fused_rcu`` launches the kernels for CUDA tensors and runs
``fused_rcu_plain`` for CPU tensors; ``fused_rcu.launches`` counts calls
of the op on the card. Like the Pallas kernel it is forward only: a CUDA
call that would need a gradient raises. The JAX package wires it into no
model, and neither does the port: it is a standalone op.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._conv import (
    CO,
    EPI_CONV1,
    EPI_RESIDUAL,
    KC,
    Scratch,
    activation,
    call,
    check_activation,
    check_no_grad,
    check_shape,
    check_tile,
    conv_bf16,
    kernel_param,
    oihw,
    pick_tile,
    plan_conv,
    prepare_bf16,
    wgmma_bias,
)


def smem_bytes(tile: int, C: int) -> int:
    """Shared memory of one block of the f32 route (``csrc/fused_rcu.cu``,
    ``launch``)."""
    return 9 * KC * CO * 4 + ((tile + 4) ** 2 * KC + (tile + 2) ** 2 * (C + 8)) * 4


def fused_rcu_plain(x, w1, b1, w2, b2):
    """The plain PyTorch version: ``F.conv2d`` in x's dtype, as the port's
    ``ResidualConvUnit`` runs it."""
    h = x.permute(0, 3, 1, 2)
    y = F.conv2d(F.relu(h), oihw(w1, x.dtype), b1.to(x.dtype), padding=1)
    y = F.conv2d(F.relu(y), oihw(w2, x.dtype), b2.to(x.dtype), padding=1)
    return (y + h).permute(0, 2, 3, 1)


def _check(x, w1, b1, w2, b2):
    check_activation(x, "fused_rcu")
    C = x.shape[-1]
    for w, name in ((w1, "w1"), (w2, "w2")):
        check_shape(w, [(3, 3, C, C)], name)
    for b, name in ((b1, "b1"), (b2, "b2")):
        check_shape(b, [(C,)], name)


def _launch_f32(x, w1, b1, w2, b2, tile):
    B, H, W, C = x.shape
    tile = pick_tile(B, H, W, lambda t: smem_bytes(t, C), tile)
    params = [kernel_param(w1, (9, C, C), x), kernel_param(b1, (C,), x),
              kernel_param(w2, (9, C, C), x), kernel_param(b2, (C,), x)]
    out = torch.empty_like(x)
    lib = _build.load("fused_rcu")
    rc = call(lib, "soccdpt_fused_rcu", [x, *params, out], [B, H, W, C, tile],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fused RCU kernel")
    return out


def _launch_bf16(x, w1, b1, w2, b2, plan):
    """The bf16 route with both convolutions launched as ``plan`` says
    (``plan_conv`` of x's shape; chip_smoke.py times its neighbours)."""
    C = x.shape[-1]
    lib = _build.load("fused_rcu")
    scratch = Scratch([plan, plan], x.device)
    w1, w2 = prepare_bf16(lib, x, [w1, w2], scratch)
    b1, b2 = wgmma_bias(b1, x), wgmma_bias(b2, x)
    mid, out = torch.empty_like(x), torch.empty_like(x)
    conv_bf16(lib, plan, scratch, x, w1, b1, mid, EPI_CONV1)
    conv_bf16(lib, plan, scratch, mid, w2, b2, out, EPI_RESIDUAL, residual=x)
    return out


def _launch(x, w1, b1, w2, b2, tile):
    check_no_grad("fused RCU", x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    x = activation(x)
    if x.dtype == torch.bfloat16:
        out = _launch_bf16(x, w1, b1, w2, b2, plan_conv(*x.shape, taps=9))
    else:
        out = _launch_f32(x, w1, b1, w2, b2, tile)
    fused_rcu.launches += 1
    return out


def fused_rcu(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    tile: Optional[int] = None,
) -> torch.Tensor:
    """The fused residual conv unit: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors. Returns (B, H, W, C) in x's dtype.
    ``tile`` (8 or 4, f32 only) fixes the f32 route's square tile; by
    default it is the largest that fits and still gives every SM a block.
    A bf16 call with a ``tile`` raises ``ValueError``."""
    check_tile(x, tile, "fused_rcu")
    if x.device.type == "cuda":
        return _launch(x, w1, b1, w2, b2, tile)
    if x.device.type != "cpu":
        raise ValueError(f"fused_rcu runs on cuda or cpu, not {x.device}")
    _check(x, w1, b1, w2, b2)
    return fused_rcu_plain(x, w1, b1, w2, b2)


fused_rcu.launches = 0
