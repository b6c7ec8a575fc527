"""Image resize with torch interpolation semantics.

The JAX package builds host-side interpolation matrices that reproduce
``torch.nn.functional.interpolate`` (its ``ops/resize.py``); here the
function itself is called. Modes used by the model:

* bilinear, ``align_corners=True``: DPT fusion and head 2x upsampling;
* bicubic (a = -0.75), ``align_corners=False``: preprocessing to net
  size (a non-antialiased downscale, as the JAX matrices are) and the
  output resize to camera resolution;
* nearest (torch's legacy ``floor(i * in / out)``): segmentation upsample.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _interpolate(x_nchw: torch.Tensor, size, method: str, align_corners: bool):
    if method == "nearest":
        return F.interpolate(x_nchw, size=size, mode="nearest")
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize method {method!r}")
    return F.interpolate(
        x_nchw, size=size, mode=method, align_corners=align_corners,
        antialias=False,
    )


def resize_hw(
    x: torch.Tensor,
    size: Tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the (H, W) axes of an NHWC tensor ``(B, H, W, C)``."""
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
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


def upsample2x_hw(
    x: torch.Tensor, method: str = "bilinear", align_corners: bool = True
) -> torch.Tensor:
    """2x spatial upsample of NHWC (the DPT fusion-block default)."""
    return resize_hw(x, (x.shape[-3] * 2, x.shape[-2] * 2), method, align_corners)
