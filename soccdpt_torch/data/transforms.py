"""On-device preprocessing of camera frames."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.resize import resize_hw


def device_preprocess(
    image_u8: torch.Tensor,
    net_size: Tuple[int, int],
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized (B, 3, net_h, net_w) in ``dtype``.

    ``/255``, then ``(x - 0.5) / 0.5``, then a non-antialiased bicubic
    resize to net size, then NCHW: the JAX package's
    ``data/transforms.py::device_preprocess``.
    """
    dtype = dtype or torch.float32
    net_w, net_h = net_size
    x = image_u8.to(dtype) / 255.0
    x = (x - 0.5) / 0.5
    x = resize_hw(x, (net_h, net_w), "bicubic", align_corners=False)
    return x.permute(0, 3, 1, 2)
