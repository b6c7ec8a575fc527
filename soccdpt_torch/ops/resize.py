"""Image resize with torch interpolation semantics.

The JAX package builds host-side interpolation matrices that reproduce
``torch.nn.functional.interpolate`` (its ``ops/resize.py``); here the
function itself is called. Modes used by the model:

* bilinear, ``align_corners=True``: DPT fusion and head 2x upsampling;
* bicubic (a = -0.75), ``align_corners=False``: preprocessing to net
  size (a non-antialiased downscale, as the JAX matrices are) and the
  output resize to camera resolution;
* nearest (torch's legacy ``floor(i * in / out)``): segmentation upsample.

Which call goes where. A 2x bilinear ``align_corners=True`` resize of an
NHWC bf16 tensor on the card, that no autograd graph records, runs the
port's own kernel (``soccdpt::upsample2x``, ``kernels/upsample.py``): the
served decoder's refinenets and both heads' upsamples, wherever their size
is exactly 2x. A strided input is made contiguous first, since the kernel
reads contiguous NHWC; the served decoder hands it none. While
``torch.export`` traces, the same calls on the CPU become that op too, so
the program launches the kernel where it runs on the card (on the CPU the
op is ``F.interpolate``). Everything else goes to ``F.interpolate``, as
the kernel cannot compute it: f32 (the training path, whose f32 bounds the
bf16 kernel could not hold), the CPU, calls that autograd records (the
kernel has no backward), any other size or mode, and
``align_corners=False``. At the served shapes the kernel runs about ten
times faster than aten's (PERF.md, section 6). A bilinear
``align_corners=True`` call on the card that falls back is counted in
``kernels.ops.fallbacks()["upsample2x"]``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import count_fallback
from ..kernels.upsample import upsample2x


def _interpolate(x_nchw: torch.Tensor, size, method: str, align_corners: bool):
    if method == "nearest":
        return F.interpolate(x_nchw, size=size, mode="nearest")
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize method {method!r}")
    return F.interpolate(
        x_nchw, size=size, mode=method, align_corners=align_corners,
        antialias=False,
    )


def takes_kernel(x: torch.Tensor, size, method: str, align_corners: bool) -> bool:
    """Whether ``resize_hw(x, size, method, align_corners)`` runs the upsample
    kernel (the module docstring)."""
    return (method == "bilinear" and align_corners and x.dim() == 4
            and tuple(size) == (2 * x.shape[1], 2 * x.shape[2])
            and x.dtype == torch.bfloat16
            and (x.is_cuda or torch.compiler.is_exporting())
            and not (x.requires_grad and torch.is_grad_enabled()))


def resize_hw(
    x: torch.Tensor,
    size: Tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the (H, W) axes of an NHWC tensor ``(B, H, W, C)``."""
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
    if takes_kernel(x, size, method, align_corners):
        if not x.is_contiguous():
            x = x.clone(memory_format=torch.contiguous_format)
        return upsample2x(x)
    if x.is_cuda and method == "bilinear" and align_corners:
        count_fallback("upsample2x")
    out = _interpolate(x.permute(0, 3, 1, 2), tuple(size), method, align_corners)
    return out.permute(0, 2, 3, 1)


def resize_nchw(
    x: torch.Tensor,
    size: Tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the trailing (H, W) axes of ``(..., H, W)``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-2]
    x4 = x.reshape(-1, 1, *x.shape[-2:])
    out = _interpolate(x4, tuple(size), method, align_corners)
    return out.reshape(*lead, *out.shape[-2:])


def subsampled_resize_nchw(
    x: torch.Tensor,
    size: Tuple[int, int],
    step: int,
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """``resize_nchw(x, size, ...)[..., ::step, ::step]``: a level of the
    SSI loss's pyramid, taken from the net-resolution prediction. (The JAX
    package folds the subsampling into its resize matrices, a rewrite for
    the TPU of this same function.)"""
    out = resize_nchw(x, size, method, align_corners)
    return out if step == 1 else out[..., ::step, ::step]


def upsample2x_hw(
    x: torch.Tensor, method: str = "bilinear", align_corners: bool = True
) -> torch.Tensor:
    """2x spatial upsample of NHWC (the DPT fusion-block default)."""
    return resize_hw(x, (x.shape[-3] * 2, x.shape[-2] * 2), method, align_corners)
