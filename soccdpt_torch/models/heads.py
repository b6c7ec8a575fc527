"""Output heads for the DPT trunk (the port of ``soccdpt_tpu/models/heads.py``).

NHWC in and out. The depth head runs the plain order upsample-then-conv
(the JAX package's ``_UpConv`` is a TPU rewrite of the same function).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample2x_hw
from .layers import batch_norm_nhwc, conv3d, conv_nhwc, dropout


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

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """``generator`` is unused: every head takes the seg head's call."""
        x = conv_nhwc(self.conv1, x)
        x = upsample2x_hw(x, "bilinear", align_corners=True)
        x = F.relu(conv_nhwc(self.conv2, x))
        x = conv_nhwc(self.conv3, x)
        return F.relu(x) if self.non_negative else x


class SegHead(nn.Module):
    """conv3x3 (no bias) -> BN -> relu -> dropout -> conv1x1 -> 2x bilinear
    (align_corners) -> sigmoid or scaled tanh: (B, H, W, F) ->
    (B, 2H, 2W, C). In training mode BN takes the batch's statistics and
    the dropout mask is drawn from ``generator``. ``in_features`` (default
    ``features``) is the width it reads: 64 behind LeViT's stem transpose."""

    def __init__(
        self,
        num_classes: int = 3,
        features: int = 256,
        sigmoid: bool = True,
        dropout_rate: float = 0.1,
        in_features: Optional[int] = None,
    ):
        super().__init__()
        self.sigmoid = sigmoid
        self.dropout_rate = dropout_rate
        self.conv1 = nn.Conv2d(in_features or features, features, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(features, num_classes, 1)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = F.relu(batch_norm_nhwc(self.bn, conv_nhwc(self.conv1, x)))
        x = dropout(x, self.dropout_rate, self.training, generator)
        x = upsample2x_hw(conv_nhwc(self.conv2, x), "bilinear", align_corners=True)
        return torch.sigmoid(x) if self.sigmoid else scaled_tanh(x)


class IdentityHead(nn.Module):
    """Pass-through head (SOccDPT V2's shared trunk)."""

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return x


def _max_pool_222(x: torch.Tensor, split_ties: bool) -> torch.Tensor:
    """Non-overlapping 2x2x2 max pool of (B, C, X, Y, Z). With
    ``split_ties``, pairwise ``torch.maximum`` over z, y, then x pairs: the
    JAX package's ``_max_pool_222_split`` order, so the gradient of a tie
    is split as JAX's is (half to each side of a pair). Without, one
    ``max_pool3d``, whose gradient sends a tie to one cell of its window.
    The values are the same."""
    if not split_ties:
        return F.max_pool3d(x, 2)
    x = torch.maximum(x[..., 0::2], x[..., 1::2])
    x = torch.maximum(x[..., 0::2, :], x[..., 1::2, :])
    return torch.maximum(x[:, :, 0::2], x[:, :, 1::2])


class OccupancyHead(nn.Module):
    """3-D conv occupancy refiner: (B, gx, gy, gz, C) accumulated grid ->
    (B, gx, gy, gz, C) probabilities. ``identity`` (the flagship's
    ``occupancy_head=False``) passes the grid through.

    conv3x3x3(C, 8) -> relu -> 2x2x2 max pool -> conv(8, 16) -> relu ->
    2x2x2 max pool -> conv(16, 32) -> relu -> conv(32, C) -> f32 logits ->
    trilinear upsample back to the grid (``align_corners=False``) ->
    sigmoid. The JAX package evaluates the same function through 2-D
    convs over a depth-folded layout, a TPU rewrite; here the convs are
    plain 3-D ones, and the parameter tree (``conv1`` .. ``conv4``) is the
    same. An accumulated grid is mostly empty cells that tie in a pool
    window. Where the grid's own gradient is taken, the pools are the JAX
    package's pairwise maxima (z, then y, then x), whose gradient splits a
    tie between the two cells at each level, so the grid's gradient is
    JAX's. Otherwise (the occupancy trainer, serving) they are
    ``max_pool3d``, which routes a tie to one cell: a tie's cells read
    equal patches, so the weights' gradients are the same, and a flagship
    step launches 90 fewer kernels and spends 0.7 ms less device time on
    an H100 (PERF.md).
    """

    def __init__(self, num_classes: int = 3, identity: bool = True):
        super().__init__()
        self.identity = identity
        if not identity:
            self.conv1 = nn.Conv3d(num_classes, 8, 3, padding=1)
            self.conv2 = nn.Conv3d(8, 16, 3, padding=1)
            self.conv3 = nn.Conv3d(16, 32, 3, padding=1)
            self.conv4 = nn.Conv3d(32, num_classes, 3, padding=1)

    def forward(self, g: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``dtype`` is the compute dtype of the convs; the logits, the
        upsample and the sigmoid are f32 either way."""
        if self.identity:
            return g
        x = g.to(dtype).permute(0, 4, 1, 2, 3)  # channels first for the convs
        split = g.requires_grad
        x = _max_pool_222(F.relu(conv3d(self.conv1, x)), split)
        x = _max_pool_222(F.relu(conv3d(self.conv2, x)), split)
        x = F.relu(conv3d(self.conv3, x))
        x = conv3d(self.conv4, x).float()
        x = F.interpolate(x, size=tuple(g.shape[1:4]), mode="trilinear", align_corners=False)
        return torch.sigmoid(x).permute(0, 2, 3, 4, 1)
