"""MidasNet v2.1 (legacy MiDaS): the ResNeXt-101 encoder and the legacy
fusion decoder (the port of ``soccdpt_tpu/models/midas.py``).

The reference scores ``midas_v21`` through its baseline harness
(eval_others.py, via torch.hub); the JAX package makes it a standalone
model, the BASELINE config "MiDaS v21 depth-only, single image at 256",
with no call site in the package: its tests build it. So does the port.

Legacy decoder (reference blocks.py:276-345): a residual conv unit
without BatchNorm (ReLU, conv, ReLU, conv, skip), and a fusion block that
adds ``rcu1(skip)`` to its input before ``rcu2``, then upsamples 2x
(bilinear, ``align_corners=True``); the depth head is conv3x3(128), 2x
bilinear (``align_corners=False``), conv3x3(32), ReLU, conv1x1(1), ReLU
when ``non_negative``. The convolutions are plain ``nn.Conv2d`` on
cuDNN, as the JAX package's are XLA convs: kernels K3-K5 are not routed
into it.

``model(x)`` takes (B, 3, H, W) normalized images and returns inverse
depth (B, H, W). The network runs in ``dtype`` (f32 or bf16), BatchNorm
in f32. Submodules carry the flax scope names, so
``weights.load_jax_variables`` maps a JAX tree onto the model.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample2x_hw
from .backbones.resnext import make_resnext_backbone
from .layers import conv_nhwc


class LegacyRCU(nn.Module):
    """ReLU, conv, ReLU, conv, then the skip (reference blocks.py:276-311)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv1, F.relu(x))
        h = conv_nhwc(self.conv2, F.relu(h))
        return h + x


class LegacyFusionBlock(nn.Module):
    """Input (+ rcu1(skip)), rcu2, 2x upsample (reference blocks.py:314-345).
    ``skip`` says whether the block takes a lateral input (all but
    ``refinenet4``), as flax makes ``rcu1`` only where it is called."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.rcu1 = LegacyRCU(features)
        self.rcu2 = LegacyRCU(features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None) -> torch.Tensor:
        out = x
        if skip is not None:
            out = out + self.rcu1(skip)
        out = self.rcu2(out)
        return upsample2x_hw(out, "bilinear", align_corners=True)


class MidasNetV21(nn.Module):
    """Depth-only model; ``forward`` returns inverse depth (B, H, W)."""

    def __init__(self, features: int = 256, non_negative: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.non_negative, self.dtype = non_negative, dtype
        factory, chans = make_resnext_backbone("resnext101_wsl")
        self.backbone = factory()
        for i, c in enumerate(chans):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        self.refinenet4 = LegacyFusionBlock(features, skip=False)
        self.refinenet3 = LegacyFusionBlock(features)
        self.refinenet2 = LegacyFusionBlock(features)
        self.refinenet1 = LegacyFusionBlock(features)
        self.head_conv1 = nn.Conv2d(features, 128, 3, padding=1)
        self.head_conv2 = nn.Conv2d(128, 32, 3, padding=1)
        self.head_conv3 = nn.Conv2d(32, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).to(self.dtype)  # NCHW -> NHWC
        feats = self.backbone(x)
        rn = [conv_nhwc(getattr(self, f"layer{i + 1}_rn"), f) for i, f in enumerate(feats)]
        path = self.refinenet4(rn[3])
        path = self.refinenet3(path, rn[2])
        path = self.refinenet2(path, rn[1])
        path = self.refinenet1(path, rn[0])
        h = conv_nhwc(self.head_conv1, path)
        h = upsample2x_hw(h, "bilinear", align_corners=False)
        h = F.relu(conv_nhwc(self.head_conv2, h))
        h = conv_nhwc(self.head_conv3, h)
        if self.non_negative:
            h = F.relu(h)
        return h[..., 0]
