"""K5: the tail of the DPT depth head, fused.

Replaces the TPU kernel of ``soccdpt_tpu/ops/fused_head.py``
(``_fused_head_tail_fwd``, behind ``fused_head_tail``); the function to
match is that file's ``xla_head_tail``. The CUDA source is
``csrc/fused_head.cu``.

Contract: ``relu(conv1x1(relu(conv3x3(upsample2x(x)) + b2)) + b3)`` as
``(B, 2H, 2W)`` over NHWC ``x (B, H, W, Ci)``: a 2x bilinear upsample with
``align_corners=True``, a 3x3 conv ``w2 (3, 3, Ci, Cm)`` with zero padding
at output resolution and bias ``b2 (Cm,)``, a ReLU, a 1x1 conv to one
channel ``w3`` ``(Cm,)`` or ``(1, 1, Cm, 1)`` with ``b3`` a scalar or
``(1,)``, and a final ReLU. That is ``models/heads.py::DepthHead`` after
its ``conv1`` when ``non_negative`` is set: K5 is the tail of a
non-negative head only. Ci a multiple of 8, Cm of 4.

Bound on the H100: operations (9 Ci Cm multiply-adds per output pixel).
Two routes, by dtype:

* bf16, on the tensor cores: three CUDA launches. One prepares the call
  (``_conv.prepare_head_bf16``: w2 to bf16 in the kernel's layout, b2,
  w3 and b3 rounded to bf16, from the weights as they lie, any strides);
  the upsample pass writes ``u`` in bf16 (``kernels/upsample.py``, the
  decoder's and K4's); the 3x3 conv runs as ``csrc/conv_wgmma.cuh``'s
  implicit GEMM over ``u``, planned by ``_conv.plan_head``, with the
  head's epilogue (the ReLU, the 1x1 conv to one channel, its bias and
  the final ReLU) in registers.
* f32: one launch on CUDA cores; the upsampled map never reaches device
  memory (the kernel blends the tile it convolves straight from ``x``
  into shared memory); f32 products, which the f32 bound (2e-5) needs.

``fused_head_tail`` calls the op ``soccdpt::fused_head_tail``
(``_build.op``), which launches the kernels for CUDA tensors and runs
``fused_head_tail_plain`` for CPU tensors;
``kernels.ops.launches()["fused_head_tail"]`` counts its calls on the card.
Gradient: as JAX's ``_fht_bwd`` recomputes through XLA, a call whose inputs
need a gradient is a ``torch.autograd.Function`` whose forward is the op
and whose backward recomputes through the plain version and returns its
autograd gradients (no kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, upsample
from ._build import INT, PTR
from ._conv import (
    activation,
    check_activation,
    check_shape,
    head_columns,
    kernel_param,
    oihw,
    plan_head,
    prepare_head_bf16,
)


def fused_head_tail_plain(x, w2, b2, w3, b3):
    """The plain PyTorch version, in x's dtype, as the port's ``DepthHead``
    runs it after ``conv1``."""
    Cm = w2.shape[-1]
    u = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * x.shape[1], 2 * x.shape[2]),
                      mode="bilinear", align_corners=True)
    y = F.relu(F.conv2d(u, oihw(w2, x.dtype), b2.to(x.dtype), padding=1))
    z = F.conv2d(y, w3.reshape(1, Cm, 1, 1).to(x.dtype), b3.reshape(1).to(x.dtype))
    return F.relu(z)[:, 0]


def _check(x, w2, b2, w3, b3):
    check_activation(x, "fused_head_tail")
    Ci, Cm = x.shape[-1], w2.shape[-1]
    check_shape(w2, [(3, 3, Ci, Cm)], "w2")
    if Cm % 4:
        raise ValueError(f"fused_head_tail: Cm must be a multiple of 4, got {Cm}")
    check_shape(b2, [(Cm,)], "b2")
    check_shape(w3, [(Cm,), (1, 1, Cm, 1)], "w3")
    check_shape(b3, [(), (1,)], "b3")


def _launch_f32(x, w2, b2, w3, b3):
    B, H, W, Ci = x.shape
    Cm = w2.shape[-1]
    params = [kernel_param(w2, (9, Ci, Cm), x), kernel_param(b2, (Cm,), x),
              kernel_param(w3, (Cm,), x), kernel_param(b3, (1,), x)]
    out = torch.empty((B, 2 * H, 2 * W), dtype=x.dtype, device=x.device)
    _F32(x.device, x, *params, out, B, H, W, Ci, Cm)
    return out


def _launch_bf16(x, w2, b2, w3, b3):
    """Three launches: the preparation, the upsample, the head conv."""
    B, H, W, Ci = x.shape
    Cm = w2.shape[-1]
    plan = plan_head(B, 2 * H, 2 * W, Ci, Cm)
    w, vec = prepare_head_bf16(x, w2, [b2, w3, b3])
    u = upsample.launch(x)
    out = torch.empty((B, 2 * H, 2 * W), dtype=x.dtype, device=x.device)
    _CONV_BF16(x.device, u, w, vec, out, B, 2 * H, 2 * W, Ci, Cm, head_columns(Cm), plan.config,
               plan.walk)
    return out


def _launch(x, w2, b2, w3, b3):
    x = activation(x)
    launch = _launch_bf16 if x.dtype == torch.bfloat16 else _launch_f32
    return launch(x, w2, b2, w3, b3)


def _fused_head_tail_fake(x, w2, b2, w3, b3):
    B, H, W, _ = x.shape
    return x.new_empty((B, 2 * H, 2 * W))


_F32 = _build.Entry("fused_head", "soccdpt_fused_head_f32", [PTR] * 6 + [INT] * 5,
                    "depth-head tail kernel")
_CONV_BF16 = _build.Entry("fused_head", "soccdpt_head_conv_bf16", [PTR] * 4 + [INT] * 8,
                          "depth-head conv kernel")
_fused_head_tail_op = _build.op(
    "fused_head_tail(Tensor x, Tensor w2, Tensor b2, Tensor w3, Tensor b3) -> Tensor", _launch,
    fused_head_tail_plain, _fused_head_tail_fake)


class _FusedHeadTail(torch.autograd.Function):
    """Forward: the kernel (the plain version on CPU tensors). Backward: a
    recompute through the plain version, as the JAX package's."""

    @staticmethod
    def forward(ctx, x, w2, b2, w3, b3):
        ctx.save_for_backward(x, w2, b2, w3, b3)
        return _fused_head_tail_op(x, w2, b2, w3, b3)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needed = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in needed) for i, t in enumerate(inputs)]
            out = fused_head_tail_plain(*leaves)
            grads = torch.autograd.grad(out, [leaves[i] for i in needed], g.to(out.dtype))
        result = [None] * 5
        for i, grad in zip(needed, grads):
            result[i] = grad
        return tuple(result)


def fused_head_tail(
    x: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
) -> torch.Tensor:
    """The fused depth-head tail: the CUDA kernels for CUDA tensors (bf16 on
    the tensor cores, f32 on CUDA cores), the plain version for CPU tensors. Returns (B, 2H, 2W) in x's dtype. When
    an input needs a gradient the call is recorded for autograd (see the
    module docstring); otherwise it is the bare forward."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_head_tail runs on cuda or cpu, not {x.device}")
    _check(x, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w2, b2, w3, b3)):
        return _FusedHeadTail.apply(x, w2, b2, w3, b3)
    return _fused_head_tail_op(x, w2, b2, w3, b3)
