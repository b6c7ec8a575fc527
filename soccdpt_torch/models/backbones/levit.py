"""LeViT-384 backbone and the DPT stem transpose (the port of
``soccdpt_tpu/models/backbones/levit.py``).

A 16x conv stem (four stride-2 conv-BN, hardswish after the first three)
makes a 14x14 token grid at 224 px; three attention stages at grids 14, 7
and 4 (ceil divisions) with subsample attention between them. Every
norm is a BatchNorm: ``BNDense`` normalises the flattened tokens
``(B * N, C)``, as the JAX module does. Attention adds a learned per-head
bias (``attn_bias``) gathered by relative |offset| (``attn_bias_index``)
and folded at bind through ``models/bias_cache.py``; logits and bias are
f32, then softmax, as in the JAX package, which runs no kernel here.
The subsample attention takes its queries at stride 2 on the ceil grid,
has ``embed_dims[s] // key_dim`` heads and twice the value ratio, and no
residual.

The hooks count the flattened block sequence (attention and MLP
residuals one each, the subsample pair included): (3, 11, 21) capture
stages 0, 1 and 2 mid-way, reshaped to NHWC.

``StemTranspose`` is the 4x transposed-conv upsampling DPT inserts
before the head for LeViT: 256 -> 128 -> 64 channels, 2x each. Its
BatchNorms always read their running statistics: the JAX package's DPT
calls it without ``deterministic``, so flax's ``use_running_average``
stays True in training too (ROADMAP.md, departures). Here the module
stays in eval mode whatever ``train()`` asks.

Submodules carry the flax scope names (``s0_attn0.qkv.linear``,
``downsample0_attn.kv.bn``, ``stem0.conv``, ``stem_transpose.up1``, ...).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bias_cache import cached_bias
from ..layers import batch_norm_nhwc, conv_nhwc, conv_transpose_nhwc, dense


@dataclass(frozen=True)
class LeViTConfig:
    img_size: int = 224
    embed_dims: Tuple[int, int, int] = (384, 512, 768)
    num_heads: Tuple[int, int, int] = (6, 9, 12)
    depths: Tuple[int, int, int] = (4, 4, 4)
    key_dim: int = 32
    mlp_ratio: float = 2.0
    attn_ratio: float = 2.0


LEVIT_CONFIGS = {
    "levit_384": LeViTConfig(),
    "levittest_64": LeViTConfig(
        img_size=64, embed_dims=(32, 48, 64), num_heads=(2, 3, 4),
        depths=(2, 2, 2), key_dim=16,
    ),
}

LEVIT_HOOKS = {
    "levit_384": (3, 11, 21),
    "levittest_64": (1, 7, 13),
}


@functools.lru_cache(maxsize=32)
def attn_bias_index(gh: int, gw: int, qh: int, qw: int, q_stride: int) -> np.ndarray:
    """(N_q, N_kv) index into the per-head bias table of |offset| pairs:
    ``|dh| * gw + |dw|`` between a query at ``q_stride`` times its grid
    position and a key on the (gh, gw) grid."""
    kv = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")).reshape(2, -1)
    q = np.stack(
        np.meshgrid(np.arange(qh) * q_stride, np.arange(qw) * q_stride, indexing="ij")
    ).reshape(2, -1)
    offs = np.abs(q[:, :, None] - kv[:, None, :])  # (2, Nq, Nkv)
    return (offs[0] * gw + offs[1]).astype(np.int64)


class BNDense(nn.Module):
    """Linear (no bias) + BatchNorm over the flattened tokens."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        self.bn = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_nhwc(self.bn, dense(self.linear, x))


class LeViTAttention(nn.Module):
    """Attention on a (gh, gw) token grid; ``q_stride`` 2 is the subsample
    attention (separate ``kv`` and strided ``q``), 1 the fused ``qkv``."""

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        num_heads: int,
        key_dim: int,
        attn_ratio: float,
        grid: Tuple[int, int],
        q_stride: int = 1,
    ):
        super().__init__()
        H, kd, vd = num_heads, key_dim, int(attn_ratio * key_dim)
        self.heads, self.kd, self.vd = H, kd, vd
        self.grid, self.q_stride = tuple(grid), q_stride
        gh, gw = self.grid
        self.q_grid = (-(-gh // q_stride), -(-gw // q_stride))
        if q_stride > 1:
            self.kv = BNDense(dim_in, H * (kd + vd))
            self.q = BNDense(dim_in, H * kd)
        else:
            self.qkv = BNDense(dim_in, H * (2 * kd + vd))
        self.attn_bias = nn.Parameter(torch.zeros(H, gh * gw))
        self.proj = BNDense(H * vd, dim_out)
        index = attn_bias_index(gh, gw, *self.q_grid, q_stride)
        self.register_buffer(
            "bias_index", torch.from_numpy(index.reshape(-1)), persistent=False
        )
        self.register_buffer("bias_cache", None, persistent=False)
        self._bias_key = None

    def bias_params(self):
        return (self.attn_bias,)

    def compute_bias(self) -> torch.Tensor:
        """(H, N_q, N_kv) f32 attention bias."""
        qh, qw = self.q_grid
        return self.attn_bias[:, self.bias_index].reshape(self.heads, qh * qw, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        H, kd, vd = self.heads, self.kd, self.vd
        (gh, gw), (qh, qw), s = self.grid, self.q_grid, self.q_stride
        if s > 1:
            k, v = self.kv(x).reshape(B, N, H, kd + vd).split([kd, vd], dim=-1)
            xq = x.reshape(B, gh, gw, -1)[:, ::s, ::s].reshape(B, qh * qw, -1)
            q = self.q(xq).reshape(B, qh * qw, H, kd)
        else:
            q, k, v = self.qkv(x).reshape(B, N, H, 2 * kd + vd).split([kd, kd, vd], dim=-1)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # (B, H, n, d)
        attn = (q.float() @ k.float().transpose(-2, -1)) * kd**-0.5
        attn = torch.softmax(attn + cached_bias(self).float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, qh * qw, H * vd)
        return self.proj(F.hardswish(out))


class LeViTMLP(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.fc1 = BNDense(dim, int(dim * mlp_ratio))
        self.fc2 = BNDense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.hardswish(self.fc1(x)))


class ConvBN(nn.Module):
    """conv3x3, stride 2, no bias, then BatchNorm (NHWC)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=2, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_nhwc(self.bn, conv_nhwc(self.conv, x))


class LeViTBackbone(nn.Module):
    """Returns 3 feature maps (NHWC) at grids g, ceil(g/2), ceil(g/4)."""

    def __init__(
        self,
        cfg: LeViTConfig,
        hooks: Sequence[int] = (3, 11, 21),
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cfg, self.hooks = cfg, tuple(hooks)
        H, W = input_size or (cfg.img_size, cfg.img_size)
        self.input_size = (H, W)
        c0 = cfg.embed_dims[0]
        chans = (3, c0 // 8, c0 // 4, c0 // 2, c0)
        for i in range(4):
            setattr(self, f"stem{i}", ConvBN(chans[i], chans[i + 1]))
        grid = (H, W)
        for _ in range(4):  # each stride-2 conv with padding 1: ceil(n / 2)
            grid = (-(-grid[0] // 2), -(-grid[1] // 2))
        # (module name, grid after it, width after it) of the flat sequence
        self.sequence = []
        for s in range(3):
            dim = cfg.embed_dims[s]
            for d in range(cfg.depths[s]):
                setattr(self, f"s{s}_attn{d}", LeViTAttention(
                    dim, dim, cfg.num_heads[s], cfg.key_dim, cfg.attn_ratio, grid))
                setattr(self, f"s{s}_mlp{d}", LeViTMLP(dim, cfg.mlp_ratio))
                self.sequence += [(f"s{s}_attn{d}", grid, dim), (f"s{s}_mlp{d}", grid, dim)]
            if s < 2:
                new_grid = (-(-grid[0] // 2), -(-grid[1] // 2))
                nxt = cfg.embed_dims[s + 1]
                # timm's down_ops: embed_dims[s] // key_dim heads, not num_heads[s + 1]
                setattr(self, f"downsample{s}_attn", LeViTAttention(
                    dim, nxt, dim // cfg.key_dim, cfg.key_dim, 2 * cfg.attn_ratio, grid,
                    q_stride=2))
                setattr(self, f"downsample{s}_mlp", LeViTMLP(nxt, cfg.mlp_ratio))
                self.sequence += [(f"downsample{s}_attn", new_grid, nxt),
                                  (f"downsample{s}_mlp", new_grid, nxt)]
                grid = new_grid
        if any(not 0 <= h < len(self.sequence) for h in self.hooks):
            raise ValueError(f"hooks {self.hooks} outside the {len(self.sequence)} blocks")

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        """``generator`` is unused: LeViT draws nothing in training mode."""
        if tuple(x.shape[1:3]) != self.input_size:
            raise ValueError(f"backbone built for {self.input_size}, got {tuple(x.shape[1:3])}")
        B = x.shape[0]
        for i in range(4):
            x = getattr(self, f"stem{i}")(x)
            if i < 3:
                x = F.hardswish(x)
        tokens = x.reshape(B, -1, x.shape[-1])
        feats = {}
        for blk, (name, (fh, fw), dim) in enumerate(self.sequence):
            out = getattr(self, name)(tokens)
            # the subsample attention changes the grid: no residual
            tokens = out if name.endswith("_attn") and name.startswith("downsample") else tokens + out
            if blk in self.hooks:
                feats[blk] = tokens.reshape(B, fh, fw, dim)
        return tuple(feats[h] for h in self.hooks)


class StemTranspose(nn.Module):
    """Two stride-2 3x3 transposed convs (no bias), each with BatchNorm and
    hardswish: (B, H, W, C) -> (B, 4H, 4W, 64).

    flax's ``ConvTranspose(3, stride 2, "SAME")`` pads the dilated input by
    2 before and 1 after; ``ConvTranspose2d(padding=0)`` pads 2 on both
    sides, which adds one last row and column, dropped here."""

    out_channels = 64

    def __init__(self, in_channels: int):
        super().__init__()
        self.up1 = nn.ConvTranspose2d(in_channels, 128, 3, stride=2, bias=False)
        self.bn1 = nn.BatchNorm2d(128, eps=1e-5, momentum=0.1)
        self.up2 = nn.ConvTranspose2d(128, self.out_channels, 3, stride=2, bias=False)
        self.bn2 = nn.BatchNorm2d(self.out_channels, eps=1e-5, momentum=0.1)
        super().train(False)

    def train(self, mode: bool = True) -> "StemTranspose":
        """Stays in eval mode: the BatchNorms read their running statistics
        and leave them as they are, in training too, as in the JAX package."""
        return super().train(False)

    def _up(self, conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        return conv_transpose_nhwc(conv, x)[:, : 2 * H, : 2 * W]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.hardswish(batch_norm_nhwc(self.bn1, self._up(self.up1, x)))
        return F.hardswish(batch_norm_nhwc(self.bn2, self._up(self.up2, x)))


def make_levit_backbone(
    backbone: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """Returns (module factory, stage channel widths)."""
    cfg = LEVIT_CONFIGS[backbone]
    hooks = tuple(hooks) if hooks is not None else LEVIT_HOOKS[backbone]
    factory = functools.partial(LeViTBackbone, cfg=cfg, hooks=hooks, input_size=input_size)
    return factory, tuple(cfg.embed_dims)
