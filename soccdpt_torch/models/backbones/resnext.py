"""ResNeXt-101 32x8d, the MiDaS v2.1 encoder (the port of
``soccdpt_tpu/models/backbones/resnext.py``).

The reference reaches this encoder through torch.hub
(``resnext101_32x8d_wsl``, reference blocks.py:219-236). Standard ResNeXt:
a 7x7/2 stem, BatchNorm, ReLU and a 3x3/2 max-pool, then four bottleneck
stages (3, 4, 23, 3 blocks; grouped 3x3 convs, 32 groups of width 8) with
channels (256, 512, 1024, 2048) at strides (4, 8, 16, 32).

``forward`` takes NHWC images and returns the four stage outputs, NHWC,
in the input's dtype. Convolutions run on cuDNN, as the JAX package's run
on XLA; BatchNorm computes in f32 and casts back (``batch_norm_nhwc``),
with flax's ``momentum=0.9`` as torch's 0.1. In training mode (``.train()``)
it normalises by the batch's statistics and moves the running ones.

Submodules are named after the flax scopes (``stem_conv``,
``stage2_block17.conv2``, ``downsample_bn``, ...) so
``weights.load_jax_variables`` maps one tree onto the other; the grouped
conv's flax kernel (3, 3, in / groups, out) is the torch weight (out,
in / groups, 3, 3) transposed, as every conv's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import batch_norm_nhwc, conv_nhwc


@dataclass(frozen=True)
class ResNeXtConfig:
    stage_blocks: Tuple[int, int, int, int] = (3, 4, 23, 3)
    groups: int = 32
    width_per_group: int = 8
    stem_width: int = 64

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.stem_width * 4 * (2**s) for s in range(len(self.stage_blocks)))


RESNEXT_CONFIGS = {
    "resnext101_wsl": ResNeXtConfig(),
    # Tiny config for fast unit tests on CPU.
    "resnexttest_64": ResNeXtConfig(
        stage_blocks=(1, 1, 1, 1), groups=4, width_per_group=4, stem_width=16
    ),
}


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 reduce, grouped 3x3 (the stride), 1x1 expand, each with
    BatchNorm; a strided 1x1 projection of the skip where the shape
    changes; ReLU after the sum."""

    def __init__(self, cin: int, mid: int, out: int, groups: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=1, groups=groups, bias=False)
        self.bn2 = _bn(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = _bn(out)
        if cin != out or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, out, 1, stride=stride, bias=False)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(batch_norm_nhwc(self.bn1, conv_nhwc(self.conv1, x)))
        h = F.relu(batch_norm_nhwc(self.bn2, conv_nhwc(self.conv2, h)))
        h = batch_norm_nhwc(self.bn3, conv_nhwc(self.conv3, h))
        if hasattr(self, "downsample_conv"):
            x = batch_norm_nhwc(self.downsample_bn, conv_nhwc(self.downsample_conv, x))
        return F.relu(x + h)


class ResNeXtBackbone(nn.Module):
    """The stem and four bottleneck stages; returns each stage's output."""

    def __init__(self, cfg: ResNeXtConfig, in_chans: int = 3):
        super().__init__()
        self.cfg = cfg
        w = cfg.stem_width
        self.stem_conv = nn.Conv2d(in_chans, w, 7, stride=2, padding=3, bias=False)
        self.stem_bn = _bn(w)
        # the JAX package pads with -inf, then pools 3x3/2 without padding
        self.stem_pool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = w
        base = cfg.groups * cfg.width_per_group  # 256 for 32x8d
        for s, depth in enumerate(cfg.stage_blocks):
            out, mid = cfg.stage_dims[s], base * (2**s)
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", Bottleneck(
                    cin, mid, out, cfg.groups, stride=2 if (s > 0 and b == 0) else 1))
                cin = out

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        h = F.relu(batch_norm_nhwc(self.stem_bn, conv_nhwc(self.stem_conv, x)))
        h = self.stem_pool(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        feats = []
        for s, depth in enumerate(self.cfg.stage_blocks):
            for b in range(depth):
                h = getattr(self, f"stage{s}_block{b}")(h)
            feats.append(h)
        return tuple(feats)


def make_resnext_backbone(backbone: str, hooks: Optional[Sequence[int]] = None):
    """Returns (module factory, stage channel widths). ``hooks`` is taken
    for the registry's signature and ignored: every stage is returned, as
    in the JAX package."""
    cfg = RESNEXT_CONFIGS[backbone]
    return functools.partial(ResNeXtBackbone, cfg=cfg), cfg.stage_dims
