"""Output heads for the DPT trunk (the port of ``soccdpt_tpu/models/heads.py``).

NHWC in and out. The depth head runs the plain order upsample-then-conv
(the JAX package's ``_UpConv`` is a TPU rewrite of the same function).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample2x_hw
from .layers import batch_norm_eval_nhwc, conv_nhwc


def scaled_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 * tanh(x) + 0.5."""
    return 0.5 * torch.tanh(x) + 0.5


class DepthHead(nn.Module):
    """conv3x3 -> 2x bilinear (align_corners) -> conv3x3 -> relu -> conv1x1
    -> [relu]: (B, H, W, F) -> (B, 2H, 2W, 1) inverse depth."""

    def __init__(
        self,
        in_features: int = 256,
        head_features_1: int = 256,
        head_features_2: int = 32,
        non_negative: bool = True,
    ):
        super().__init__()
        self.non_negative = non_negative
        self.conv1 = nn.Conv2d(in_features, head_features_1 // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(head_features_1 // 2, head_features_2, 3, padding=1)
        self.conv3 = nn.Conv2d(head_features_2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(self.conv1, x)
        x = upsample2x_hw(x, "bilinear", align_corners=True)
        x = F.relu(conv_nhwc(self.conv2, x))
        x = conv_nhwc(self.conv3, x)
        return F.relu(x) if self.non_negative else x


class SegHead(nn.Module):
    """conv3x3 (no bias) -> BN (running stats) -> relu -> dropout (a no-op
    at inference) -> conv1x1 -> 2x bilinear (align_corners) -> sigmoid or
    scaled tanh: (B, H, W, F) -> (B, 2H, 2W, C)."""

    def __init__(self, num_classes: int = 3, features: int = 256, sigmoid: bool = True):
        super().__init__()
        self.sigmoid = sigmoid
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(features, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm_eval_nhwc(self.bn, conv_nhwc(self.conv1, x)))
        x = upsample2x_hw(conv_nhwc(self.conv2, x), "bilinear", align_corners=True)
        return torch.sigmoid(x) if self.sigmoid else scaled_tanh(x)


class IdentityHead(nn.Module):
    """Pass-through head (SOccDPT V2's shared trunk)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class OccupancyHead(nn.Module):
    """The occupancy refiner in its identity form (the flagship's
    ``occupancy_head=False``): (B, gx, gy, gz, C) passes through."""

    def __init__(self, num_classes: int = 3, identity: bool = True):
        super().__init__()
        if not identity:
            raise NotImplementedError(
                "the 3-D OccupancyHead is not ported to soccdpt_torch yet (see ROADMAP.md)"
            )

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        return g
