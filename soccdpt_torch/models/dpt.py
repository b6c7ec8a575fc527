"""DPT trunk: reassemble ("scratch") convs and the RefineNet-style fusion
decoder (the port of ``soccdpt_tpu/models/dpt.py``). Tensors are NHWC at
module boundaries; fusion upsampling is bilinear with align_corners=True.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_hw, upsample2x_hw
from .layers import batch_norm_nhwc, conv_nhwc


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> [bn] -> relu -> conv3x3 -> [bn], + skip. In
    training mode the BatchNorms take the batch's statistics."""

    def __init__(self, features: int, use_bn: bool = False):
        super().__init__()
        self.use_bn = use_bn
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        if use_bn:
            self.bn1 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
            self.bn2 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_nhwc(self.conv1, F.relu(x))
        if self.use_bn:
            out = batch_norm_nhwc(self.bn1, out)
        out = conv_nhwc(self.conv2, F.relu(out))
        if self.use_bn:
            out = batch_norm_nhwc(self.bn2, out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """Fuse an upper path with a lateral skip, then upsample.

    The 1x1 ``out_conv`` runs before the bilinear upsample, as in the JAX
    package: both are linear maps, one per pixel and one per channel, so
    they commute (the reference applies it after).
    """

    def __init__(
        self,
        features: int,
        use_bn: bool = False,
        with_skip: bool = True,
        size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.size = size
        if with_skip:
            self.res_conv_unit1 = ResidualConvUnit(features, use_bn)
        self.res_conv_unit2 = ResidualConvUnit(features, use_bn)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(
        self,
        x: torch.Tensor,
        skip: Optional[torch.Tensor] = None,
        size: Optional[Tuple[int, int]] = None,
    ) -> torch.Tensor:
        out = x
        if skip is not None:
            out = out + self.res_conv_unit1(skip)
        out = conv_nhwc(self.out_conv, self.res_conv_unit2(out))
        target = size if size is not None else self.size
        if target is None:
            return upsample2x_hw(out, "bilinear", align_corners=True)
        return resize_hw(out, tuple(target), "bilinear", align_corners=True)


class DPT(nn.Module):
    """Backbone + scratch reassemble + fusion decoder + head.

    ``backbone`` and ``head`` are module factories. The backbone returns
    3 or 4 NHWC stage features of widths ``in_channels``. ``stem_transpose``
    (LeViT's) is a factory of a module applied to the fused features after
    ``refinenet1`` and before the head, given ``features`` input channels.
    With ``return_features`` the pre-head feature map, the stem's output
    where there is one, is returned beside the head output (SOccDPT V3).
    ``generator`` feeds the backbone's stochastic depth and the head's
    dropout (SOccDPT V1's seg head) in training mode.
    """

    def __init__(
        self,
        backbone: Callable[..., nn.Module],
        in_channels: Sequence[int],
        head: Callable[..., nn.Module],
        features: int = 256,
        use_bn: bool = False,
        return_features: bool = False,
        size_refinenet3: Optional[Tuple[int, int]] = None,
        stem_transpose: Optional[Callable[[int], nn.Module]] = None,
    ):
        super().__init__()
        self.n = len(in_channels)
        self.return_features = return_features
        self.backbone = backbone()
        for i, c in enumerate(in_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        if self.n == 4:
            self.refinenet4 = FeatureFusionBlock(features, use_bn, with_skip=False)
        self.refinenet3 = FeatureFusionBlock(
            features, use_bn, with_skip=self.n == 4, size=size_refinenet3
        )
        self.refinenet2 = FeatureFusionBlock(features, use_bn)
        self.refinenet1 = FeatureFusionBlock(features, use_bn)
        if stem_transpose is not None:
            self.stem_transpose = stem_transpose(features)
        self.head = head()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        layers = self.backbone(x, generator=generator)
        if len(layers) != self.n:
            raise ValueError(f"backbone gave {len(layers)} features, expected {self.n}")
        rn = [conv_nhwc(getattr(self, f"layer{i + 1}_rn"), f) for i, f in enumerate(layers)]
        if self.n == 4:
            path = self.refinenet4(rn[3], size=tuple(rn[2].shape[1:3]))
            path = self.refinenet3(path, rn[2], size=tuple(rn[1].shape[1:3]))
        else:
            path = self.refinenet3(rn[2], size=tuple(rn[1].shape[1:3]))
        path = self.refinenet2(path, rn[1], size=tuple(rn[0].shape[1:3]))
        path = self.refinenet1(path, rn[0])
        if hasattr(self, "stem_transpose"):
            path = self.stem_transpose(path)
        out = self.head(path, generator)
        if self.return_features:
            return out, path
        return out
