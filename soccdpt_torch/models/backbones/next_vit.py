"""Next-ViT-Large backbone (the port of ``soccdpt_tpu/models/backbones/next_vit.py``).

The official block structure, with the JAX package's module names:

* a 4-conv stem (strides 2, 1, 1, 2 -> /4), conv-BN-ReLU each;
* per-stage plans ``[NCB] * k + [NTB]`` (``NextViTConfig.plan``: 40
  blocks for Large, stage 2 repeating [384, 384, 384, 384, 512] six
  times), widths rounded by ``make_divisible``;
* NCB = PatchEmbed -> +MHCA -> +Mlp(BN(x)); MHCA = grouped 3x3 conv (one
  group per 32 channels) + BN + ReLU + 1x1 projection;
* NTB = PatchEmbed to the MHSA width -> +E_MHSA(BN(x)) -> a 1x1-projected
  MHCA branch -> channel concat ``[x, y]`` -> +Mlp(BN(concat)); its
  branches' stochastic-depth rates are scaled by ``mix_block_ratio`` and
  ``1 - mix_block_ratio``;
* E_MHSA is global attention whose keys and values are average-pooled
  over the *flattened* token sequence (``sr_ratio ** 2`` tokens at a
  time, not a 2-D pool), then BatchNorm; the scale is ``head_dim ** -0.5``.

All BatchNorms have eps 1e-5; the attention runs in plain PyTorch (the
JAX package runs no kernel here), logits in f32. Stochastic depth, where
a config asks for it (Large's rate is 0), draws from the ``generator``
argument. Hooks (2, 6, 36, 39) are each stage's last block.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import batch_norm_nhwc, conv_nhwc, dense, drop_path_mask


def make_divisible(v: float, divisor: int = 32) -> int:
    """The mobilenet rounding Next-ViT uses for hidden and branch widths."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclass(frozen=True)
class NextViTConfig:
    stem_chs: Tuple[int, int, int] = (64, 32, 64)
    depths: Tuple[int, int, int, int] = (3, 4, 30, 3)
    strides: Tuple[int, int, int, int] = (1, 2, 2, 2)
    sr_ratios: Tuple[int, int, int, int] = (8, 4, 2, 1)
    head_dim: int = 32
    mix_block_ratio: float = 0.75
    divisor: int = 32
    drop_path_rate: float = 0.0
    # per-stage output widths; None -> the official Large rule
    stage_out_channels: Optional[Tuple[Tuple[int, ...], ...]] = None

    def plan(self) -> List[Tuple[str, int, int, int, float]]:
        """Flat block plan: (type, out_ch, stride, sr_ratio, drop-path rate)."""
        d = self.depths
        if self.stage_out_channels is not None:
            out_chs = [list(s) for s in self.stage_out_channels]
        else:
            out_chs = [
                [96] * d[0],
                [192] * (d[1] - 1) + [256],
                [384, 384, 384, 384, 512] * (d[2] // 5),
                [768] * (d[3] - 1) + [1024],
            ]
        types = [
            ["ncb"] * d[0],
            ["ncb"] * (d[1] - 1) + ["ntb"],
            ["ncb", "ncb", "ncb", "ncb", "ntb"] * (d[2] // 5),
            ["ncb"] * (d[3] - 1) + ["ntb"],
        ]
        dpr = np.linspace(0, self.drop_path_rate, sum(d))
        plan, i = [], 0
        for s in range(4):
            for b in range(d[s]):
                stride = 2 if (self.strides[s] == 2 and b == 0) else 1
                plan.append((types[s][b], out_chs[s][b], stride, self.sr_ratios[s], float(dpr[i])))
                i += 1
        return plan


NEXT_VIT_CONFIGS = {
    "next_vit_large_6m": NextViTConfig(),
    "nextvittest_64": NextViTConfig(
        stem_chs=(8, 4, 8), depths=(1, 2, 5, 2), sr_ratios=(2, 2, 1, 1), head_dim=8,
        divisor=8, stage_out_channels=((16,), (24, 32), (24, 24, 24, 24, 32), (48, 64)),
    ),
}

NEXT_VIT_HOOKS = {
    "next_vit_large_6m": (2, 6, 36, 39),
    "nextvittest_64": (0, 2, 7, 9),
}


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class ConvBNReLU(nn.Module):
    """The stem's conv3x3 (no bias) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.norm = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm_nhwc(self.norm, conv_nhwc(self.conv, x)))


class PatchEmbed(nn.Module):
    """Stride 2: 2x2 average pool, then 1x1 conv + BN; a change of width:
    1x1 conv + BN; else the identity (no parameters)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.identity = stride == 1 and in_ch == features
        if not self.identity:
            self.conv = nn.Conv2d(in_ch, features, 1, bias=False)
            self.norm = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return x
        if self.stride == 2:
            if x.shape[1] % 2 or x.shape[2] % 2:
                raise ValueError(f"a stride-2 patch embed needs even maps, got {tuple(x.shape)}")
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return batch_norm_nhwc(self.norm, conv_nhwc(self.conv, x))


class MHCA(nn.Module):
    """Multi-head conv attention: grouped 3x3 conv (one group a head) + BN
    + ReLU + 1x1 projection."""

    def __init__(self, features: int, head_dim: int = 32):
        super().__init__()
        groups = max(features // head_dim, 1)
        self.group_conv3x3 = nn.Conv2d(features, features, 3, padding=1, groups=groups,
                                       bias=False)
        self.norm = _bn(features)
        self.projection = nn.Conv2d(features, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(batch_norm_nhwc(self.norm, conv_nhwc(self.group_conv3x3, x)))
        return conv_nhwc(self.projection, h)


class Mlp(nn.Module):
    """1x1-conv MLP with biases; hidden width rounded by ``make_divisible``."""

    def __init__(self, features: int, mlp_ratio: float, divisor: int = 32):
        super().__init__()
        hidden = make_divisible(features * mlp_ratio, divisor)
        self.conv1 = nn.Conv2d(features, hidden, 1)
        self.conv2 = nn.Conv2d(hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x)))


def _drop(h: torch.Tensor, rate: float, training: bool, generator) -> torch.Tensor:
    if not training or rate == 0.0:
        return h
    return h * drop_path_mask(h.shape[0], rate, h.device, h.dtype, generator)


class NCB(nn.Module):
    """Next Convolution Block: PatchEmbed -> +MHCA -> +Mlp(BN(x))."""

    def __init__(self, in_ch: int, features: int, stride: int, head_dim: int, divisor: int,
                 drop_path_rate: float, mlp_ratio: float = 3.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.patch_embed = PatchEmbed(in_ch, features, stride)
        self.mhca = MHCA(features, head_dim)
        self.norm = _bn(features)
        self.mlp = Mlp(features, mlp_ratio, divisor)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        rate, train = self.drop_path_rate, self.training
        x = self.patch_embed(x)
        x = x + _drop(self.mhca(x), rate, train, generator)
        return x + _drop(self.mlp(batch_norm_nhwc(self.norm, x)), rate, train, generator)


class E_MHSA(nn.Module):
    """Efficient global MHSA on (B, N, C) tokens: keys and values from the
    sequence average-pooled ``sr_ratio ** 2`` tokens at a time, then BN."""

    def __init__(self, features: int, head_dim: int = 32, sr_ratio: int = 1):
        super().__init__()
        self.heads = max(features // head_dim, 1)
        self.scale = head_dim**-0.5
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(features, features)
        self.k = nn.Linear(features, features)
        self.v = nn.Linear(features, features)
        self.proj = nn.Linear(features, features)
        if sr_ratio > 1:
            self.norm = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        heads = self.heads
        q = dense(self.q, x).reshape(B, N, heads, -1).transpose(1, 2)
        kv = x
        if self.sr_ratio > 1:
            r2 = self.sr_ratio**2
            if N % r2:
                raise ValueError(f"{N} tokens do not pool by {r2}")
            kv = batch_norm_nhwc(self.norm, x.reshape(B, N // r2, r2, C).mean(dim=2))
        M = kv.shape[1]
        k = dense(self.k, kv).reshape(B, M, heads, -1).transpose(1, 2)
        v = dense(self.v, kv).reshape(B, M, heads, -1).transpose(1, 2)
        attn = (q.float() @ k.float().transpose(-2, -1)) * self.scale
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return dense(self.proj, out)


class NTB(nn.Module):
    """Next Transformer Block: PatchEmbed to the MHSA width -> +E_MHSA(BN(x))
    -> 1x1-projected MHCA branch -> concat [x, y] -> +Mlp(BN(concat))."""

    def __init__(self, in_ch: int, features: int, stride: int, sr_ratio: int, head_dim: int,
                 mix_block_ratio: float, divisor: int, drop_path_rate: float,
                 mlp_ratio: float = 2.0):
        super().__init__()
        c_mhsa = make_divisible(features * mix_block_ratio, divisor)
        c_mhca = features - c_mhsa
        self.drop_path_rate, self.mix_block_ratio = drop_path_rate, mix_block_ratio
        self.patch_embed = PatchEmbed(in_ch, c_mhsa, stride)
        self.norm1 = _bn(c_mhsa)
        self.e_mhsa = E_MHSA(c_mhsa, head_dim, sr_ratio)
        self.projection = PatchEmbed(c_mhsa, c_mhca, 1)
        self.mhca = MHCA(c_mhca, head_dim)
        self.norm2 = _bn(features)
        self.mlp = Mlp(features, mlp_ratio, divisor)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        rate, ratio, train = self.drop_path_rate, self.mix_block_ratio, self.training
        x = self.patch_embed(x)
        B, H, W, C = x.shape
        h = self.e_mhsa(batch_norm_nhwc(self.norm1, x).reshape(B, H * W, C)).reshape(B, H, W, C)
        x = x + _drop(h, rate * ratio, train, generator)
        y = self.projection(x)
        y = y + _drop(self.mhca(y), rate * (1.0 - ratio), train, generator)
        z = torch.cat([x, y], dim=-1)
        return z + _drop(self.mlp(batch_norm_nhwc(self.norm2, z)), rate, train, generator)


class NextViTBackbone(nn.Module):
    """Returns the hooked blocks' outputs (NHWC), four of them."""

    def __init__(
        self,
        cfg: NextViTConfig,
        hooks: Sequence[int] = (2, 6, 36, 39),
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cfg, self.hooks = cfg, tuple(hooks)
        s0, s1, s2 = cfg.stem_chs
        widths = (3, s0, s1, s2, s2)
        for i, stride in enumerate((2, 1, 1, 2)):
            setattr(self, f"stem{i}", ConvBNReLU(widths[i], widths[i + 1], stride))
        plan = cfg.plan()
        ch = s2
        for blk, (btype, out, stride, sr, dpr) in enumerate(plan):
            if btype == "ntb":
                mod = NTB(ch, out, stride, sr, cfg.head_dim, cfg.mix_block_ratio, cfg.divisor, dpr)
            else:
                mod = NCB(ch, out, stride, cfg.head_dim, cfg.divisor, dpr)
            setattr(self, f"features{blk}", mod)
            ch = out
        self.n_blocks = len(plan)
        if any(not 0 <= h < self.n_blocks for h in self.hooks):
            raise ValueError(f"hooks {self.hooks} outside the {self.n_blocks} blocks")

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        for i in range(4):
            x = getattr(self, f"stem{i}")(x)
        feats = {}
        for blk in range(self.n_blocks):
            x = getattr(self, f"features{blk}")(x, generator)
            if blk in self.hooks:
                feats[blk] = x
        return tuple(feats[h] for h in self.hooks)


def make_next_vit_backbone(backbone: str, hooks: Optional[Sequence[int]] = None):
    """Returns (module factory, stage channel widths)."""
    cfg = NEXT_VIT_CONFIGS[backbone]
    hooks = tuple(hooks) if hooks is not None else NEXT_VIT_HOOKS[backbone]
    plan = cfg.plan()
    factory = functools.partial(NextViTBackbone, cfg=cfg, hooks=hooks)
    return factory, tuple(plan[h][1] for h in hooks)
