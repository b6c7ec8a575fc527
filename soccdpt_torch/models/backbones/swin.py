"""Swin Transformer V1 backbone (the port of ``soccdpt_tpu/models/backbones/swin.py``).

V1 differs from V2 (``swin2.py``): pre-norm blocks, a learned
relative-position-bias table (``rel_pos_table``, folded at bind through
``models/bias_cache.py``), plain scaled dot-product attention with a full
qkv bias, and patch merging that norms *before* the reduction.
``dpt_swin_large_384`` feeds 256 px to the 384-px ``swinl12_384``: its
stage grids 64, 32 and 16 are zero-padded to multiples of the window of
12 (72, 36, 24), the padded tokens masked into a region of their own, and
the 8-grid last stage clamps its window to 8 with no shift; a clamped
window reads the centre of the table sized for 12.

The mask is the JAX package's (``swin2.shifted_window_attn_mask``, the
same arrays as JAX's ``padded_attn_mask``): padding is marked at rows and
columns past the stage grid in the *rolled* frame, so in a shifted block
some real tokens attend to padded ones (ROADMAP.md, departures). The
attention runs in plain PyTorch (the JAX package runs no kernel here):
logits, bias and the -100 mask in f32, softmax, the product with v in the
compute dtype. LayerNorms run in f32. In training mode each block's two
residual branches pass through per-sample stochastic depth drawn from
the ``generator`` argument.

Submodules are named after the flax scopes (``stage0_block0.attn.qkv``,
``stage0_block0.attn.rel_pos_table``, ``downsample0.norm``, ...).
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
from ..layers import conv_nhwc, dense, drop_path_mask, layer_norm_f32
from .swin2 import (
    relative_position_index,
    shifted_window_attn_mask,
    window_partition,
    window_reverse,
)


@dataclass(frozen=True)
class SwinV1Config:
    img_size: int = 384
    patch_size: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2**i) for i in range(len(self.depths)))


SWIN1_CONFIGS = {
    "swinl12_384": SwinV1Config(),
    # tiny config for the CPU tests; window 5 divides no stage grid, so
    # every stage pads
    "swin1test_64": SwinV1Config(
        img_size=64, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
        window_size=5,
    ),
}

SWIN1_HOOKS = {
    "swinl12_384": (1, 1, 17, 1),
    "swin1test_64": (1, 1, 1, 1),
}


class WindowAttentionV1(nn.Module):
    """Window attention with a learned relative-position table. The table
    is sized by the configured window (``table_window``), the attention by
    the effective, possibly clamped one (``window``)."""

    def __init__(self, dim: int, num_heads: int, window: int, table_window: int):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * table_window - 1) ** 2, num_heads))
        index = relative_position_index(window, window, table_window, table_window)
        self.register_buffer(
            "position_index", torch.from_numpy(index.reshape(-1)), persistent=False
        )
        self.register_buffer("bias_cache", None, persistent=False)
        self._bias_key = None

    def bias_params(self):
        return (self.rel_pos_table,)

    def compute_bias(self) -> torch.Tensor:
        """(H, N, N) f32 relative-position bias."""
        N = self.window * self.window
        return self.rel_pos_table[self.position_index].reshape(N, N, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (num_windows_total, N, C); mask: (nW, N, N) or None."""
        Bw, N, C = x.shape
        H = self.num_heads
        qkv = dense(self.qkv, x).reshape(Bw, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (Bw, H, N, hd)
        attn = (q.float() @ k.float().transpose(-2, -1)) * (C // H) ** -0.5
        attn = attn + cached_bias(self).float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bw // nW, nW, H, N, N) + mask[None, :, None]).reshape(Bw, H, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(Bw, N, C)
        return dense(self.proj, out)


class SwinV1Block(nn.Module):
    """Pre-norm Swin V1 block: x + attn(norm(x)); x + mlp(norm(x)).

    ``drop`` is the pair of stochastic-depth factors of the two branches
    (``layers.drop_path_mask``); ``None`` leaves both whole."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        input_resolution: Tuple[int, int],
        window_size: int,
        shift: bool,
        mlp_ratio: float,
    ):
        super().__init__()
        Hr, Wr = input_resolution
        ws = min(window_size, Hr, Wr)
        self.ws = ws
        self.shift = ws // 2 if (shift and ws < min(Hr, Wr)) else 0
        self.res = (Hr, Wr)
        self.padded = (-(-Hr // ws) * ws, -(-Wr // ws) * ws)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttentionV1(dim, num_heads, ws, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        mask = shifted_window_attn_mask(Hr, Wr, ws, ws, self.shift, self.shift, *self.padded)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.from_numpy(mask), persistent=False
        )

    def forward(
        self, x: torch.Tensor, drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> torch.Tensor:
        (Hr, Wr), (Hp, Wp), ws, shift = self.res, self.padded, self.ws, self.shift
        h = layer_norm_f32(self.norm1, x)
        if (Hp, Wp) != (Hr, Wr):
            h = F.pad(h, (0, 0, 0, Wp - Wr, 0, Hp - Hr))
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        win = self.attn(window_partition(h, ws, ws), self.attn_mask)
        h = window_reverse(win, ws, ws, Hp, Wp)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        h = h[:, :Hr, :Wr]
        x = x + (h if drop is None else h * drop[0])
        h = F.gelu(dense(self.mlp_fc1, layer_norm_f32(self.norm2, x)))
        h = dense(self.mlp_fc2, h)
        return x + (h if drop is None else h * drop[1])


class PatchMergingV1(nn.Module):
    """2x2 spatial merge: concat -> LayerNorm(4C) -> Linear(4C, 2C) (v1 order)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return dense(self.reduction, layer_norm_f32(self.norm, x))


class SwinV1Backbone(nn.Module):
    """Four-stage Swin V1 encoder returning hooked stage features (NHWC).

    ``input_size`` is the (H, W) of the images it will see: the stage
    resolutions, windows, padding and masks are fixed by it.
    """

    def __init__(
        self,
        cfg: SwinV1Config,
        hooks: Sequence[int] = (1, 1, 17, 1),
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cfg, self.hooks = cfg, tuple(hooks)
        # block id -> stochastic-depth rate, 0 at the first block
        self.drop_path_rates = [
            float(r) for r in np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        ]
        H, W = input_size or (cfg.img_size, cfg.img_size)
        if H % cfg.patch_size or W % cfg.patch_size:
            raise ValueError(f"input {H}x{W} not divisible by patch size {cfg.patch_size}")
        self.input_size = (H, W)
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        grid = (H // cfg.patch_size, W // cfg.patch_size)
        for i, depth in enumerate(cfg.depths):
            if self.hooks[i] >= depth:
                raise ValueError(f"hook {self.hooks[i]} out of range for stage {i} (depth {depth})")
            res = (grid[0] >> i, grid[1] >> i)
            dim = cfg.stage_dims[i]
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}", SwinV1Block(
                    dim, cfg.num_heads[i], res, cfg.window_size, j % 2 == 1, cfg.mlp_ratio,
                ))
            if i < len(cfg.depths) - 1:
                setattr(self, f"downsample{i}", PatchMergingV1(dim))

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        if tuple(x.shape[1:3]) != self.input_size:
            raise ValueError(f"backbone built for {self.input_size}, got {tuple(x.shape[1:3])}")
        x = layer_norm_f32(self.patch_norm, conv_nhwc(self.patch_embed, x))
        feats = []
        rates = iter(self.drop_path_rates)
        for i, depth in enumerate(self.cfg.depths):
            for j in range(depth):
                rate, drop = next(rates), None
                if self.training and rate > 0.0:
                    drop = tuple(
                        drop_path_mask(x.shape[0], rate, x.device, x.dtype, generator)
                        for _ in range(2)
                    )
                x = getattr(self, f"stage{i}_block{j}")(x, drop)
                if j == self.hooks[i]:
                    feats.append(x)
            if i < len(self.cfg.depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return tuple(feats)


def make_swin1_backbone(
    backbone: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """Returns (module factory, stage channel widths)."""
    cfg = SWIN1_CONFIGS[backbone]
    hooks = tuple(hooks) if hooks is not None else SWIN1_HOOKS[backbone]
    factory = functools.partial(SwinV1Backbone, cfg=cfg, hooks=hooks, input_size=input_size)
    return factory, cfg.stage_dims
