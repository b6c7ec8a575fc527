"""Swin Transformer V2 backbone (the port of ``soccdpt_tpu/models/backbones/swin2.py``).

Post-norm blocks, scaled-cosine window attention with a learned
per-head logit scale clamped at log 100, the log-spaced continuous
relative-position bias MLP, and patch merging with reduction then norm.
``forward`` takes NHWC images and returns the hooked stage features,
NHWC, as the JAX module does. Attention runs through kernel K1
(``kernels/window_attention.py``).

Submodules are named after the flax scopes (``stage0_block0.attn.qkv``,
``downsample0.reduction``, ...) so ``weights.load_jax_variables`` maps
one tree onto the other by name.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...kernels.window_attention import window_attention
from ..bias_cache import cached_bias
from ..layers import conv_nhwc, dense, layer_norm_f32


@dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 256
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 16
    pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2**i) for i in range(len(self.depths)))


SWIN2_CONFIGS = {
    "swin2t16_256": SwinV2Config(
        img_size=256, embed_dim=96, depths=(2, 2, 6, 2),
        num_heads=(3, 6, 12, 24), window_size=16,
    ),
    "swin2b24_384": SwinV2Config(
        img_size=384, embed_dim=128, depths=(2, 2, 18, 2),
        num_heads=(4, 8, 16, 32), window_size=24,
        pretrained_window_sizes=(12, 12, 12, 6),
    ),
    "swin2l24_384": SwinV2Config(
        img_size=384, embed_dim=192, depths=(2, 2, 18, 2),
        num_heads=(6, 12, 24, 48), window_size=24,
        pretrained_window_sizes=(12, 12, 12, 6),
    ),
    # Tiny config for fast unit tests on CPU.
    "swin2test_64": SwinV2Config(
        img_size=64, embed_dim=16, depths=(2, 2, 2, 2),
        num_heads=(1, 2, 4, 8), window_size=4,
    ),
}

SWIN2_HOOKS = {
    "swin2t16_256": (1, 1, 5, 1),
    "swin2b24_384": (1, 1, 17, 1),
    "swin2l24_384": (1, 1, 17, 1),
    "swin2test_64": (1, 1, 1, 1),
}


# ---------------------------------------------------------------------------
# Static tables (host-side numpy, cached per window geometry)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def relative_position_index(
    wh: int, ww: int, table_wh: Optional[int] = None, table_ww: Optional[int] = None
) -> np.ndarray:
    """(wh*ww, wh*ww) index into a (2table_wh-1)(2table_ww-1) bias table."""
    table_wh = wh if table_wh is None else table_wh
    table_ww = ww if table_ww is None else table_ww
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += table_wh - 1
    rel[:, :, 1] += table_ww - 1
    rel[:, :, 0] *= 2 * table_ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def relative_coords_table(
    wh: int, ww: int, pretrained_wh: int, pretrained_ww: int
) -> np.ndarray:
    """Log-spaced normalized relative coordinates, ((2wh-1)*(2ww-1), 2)."""
    h = np.arange(-(wh - 1), wh, dtype=np.float64)
    w = np.arange(-(ww - 1), ww, dtype=np.float64)
    table = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)
    if pretrained_wh > 0:
        table[..., 0] /= pretrained_wh - 1
        table[..., 1] /= pretrained_ww - 1
    else:
        table[..., 0] /= max(wh - 1, 1)
        table[..., 1] /= max(ww - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=64)
def shifted_window_attn_mask(
    H: int, W: int, wh: int, ww: int, sh: int, sw: int,
    Hp: Optional[int] = None, Wp: Optional[int] = None,
) -> Optional[np.ndarray]:
    """(num_windows, N, N) additive mask (0 / -100) for SW-MSA; padded
    tokens (when (Hp, Wp) exceed (H, W)) get a region of their own."""
    Hp = Hp if Hp is not None else H
    Wp = Wp if Wp is not None else W
    if sh == 0 and sw == 0 and Hp == H and Wp == W:
        return None
    img_mask = np.zeros((Hp, Wp), dtype=np.int32)
    if sh > 0 or sw > 0:
        cnt = 0
        for hs in (slice(0, Hp - wh), slice(Hp - wh, Hp - sh), slice(Hp - sh, Hp)):
            for ws in (slice(0, Wp - ww), slice(Wp - ww, Wp - sw), slice(Wp - sw, Wp)):
                img_mask[hs, ws] = cnt
                cnt += 1
    if Hp > H:
        img_mask[H:, :] = -1
    if Wp > W:
        img_mask[:, W:] = -1
    mw = img_mask.reshape(Hp // wh, wh, Wp // ww, ww)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Window partition helpers (NHWC)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, wh * ww, C), batch-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(win: torch.Tensor, wh: int, ww: int, H: int, W: int) -> torch.Tensor:
    """(B * nH * nW, wh * ww, C) -> (B, H, W, C)."""
    C = win.shape[-1]
    B = win.shape[0] // ((H // wh) * (W // ww))
    x = win.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class WindowAttentionV2(nn.Module):
    """Scaled-cosine window attention with continuous rel-pos bias."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        window: Tuple[int, int],
        pretrained_window: Tuple[int, int] = (0, 0),
    ):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, tuple(window)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp_0 = nn.Linear(2, 512)
        self.cpb_mlp_1 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        table = relative_coords_table(*self.window, *pretrained_window)
        index = relative_position_index(*self.window)
        self.register_buffer("coords_table", torch.from_numpy(table), persistent=False)
        self.register_buffer(
            "position_index", torch.from_numpy(index.reshape(-1)), persistent=False
        )
        self.register_buffer("bias_cache", None, persistent=False)
        self._bias_key = None

    def bias_params(self):
        return (self.cpb_mlp_0.weight, self.cpb_mlp_0.bias, self.cpb_mlp_1.weight)

    def compute_bias(self) -> torch.Tensor:
        """(H, N, N) f32 relative-position bias, already 16*sigmoid."""
        cpb = self.cpb_mlp_1(F.relu(self.cpb_mlp_0(self.coords_table)))  # (M, H)
        N = self.window[0] * self.window[1]
        rb = cpb[self.position_index].reshape(N, N, self.num_heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(rb)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (num_windows_total, N, C); mask: (nW, N, N) or None."""
        Bw, N, C = x.shape
        H = self.num_heads
        qkv = dense(self.qkv, x)
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = (qkv + bias.to(x.dtype)).reshape(Bw, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (Bw, H, N, hd)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0))).to(x.dtype)
        qn = q / torch.clamp(
            torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True), min=1e-12
        ).to(x.dtype)
        kn = k / torch.clamp(
            torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True), min=1e-12
        ).to(x.dtype)
        out = window_attention(qn, kn, v, scale, cached_bias(self), mask)
        out = out.transpose(1, 2).reshape(Bw, N, C)
        return dense(self.proj, out)


class SwinV2Block(nn.Module):
    """Post-norm Swin V2 block: x + norm(attn(x)); x + norm(mlp(x))."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        input_resolution: Tuple[int, int],
        window_size: int,
        shift: bool,
        pretrained_window_size: int,
        mlp_ratio: float,
    ):
        super().__init__()
        Hr, Wr = input_resolution
        # The window is clamped to the stage resolution and the shift is off
        # when one window covers the stage (timm); pretrained_window_size
        # stays as it is even when the window is clamped.
        ws = min(window_size, Hr, Wr)
        self.ws = ws
        self.shift = ws // 2 if (shift and ws < min(Hr, Wr)) else 0
        self.res = (Hr, Wr)
        self.padded = (-(-Hr // ws) * ws, -(-Wr // ws) * ws)
        pws = pretrained_window_size
        self.attn = WindowAttentionV2(dim, num_heads, (ws, ws), (pws, pws))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        mask = shifted_window_attn_mask(Hr, Wr, ws, ws, self.shift, self.shift, *self.padded)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.from_numpy(mask), persistent=False
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (Hr, Wr), (Hp, Wp), ws, shift = self.res, self.padded, self.ws, self.shift
        shortcut = x
        h = x
        if (Hp, Wp) != (Hr, Wr):
            h = F.pad(h, (0, 0, 0, Wp - Wr, 0, Hp - Hr))
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        win = self.attn(window_partition(h, ws, ws), self.attn_mask)
        h = window_reverse(win, ws, ws, Hp, Wp)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        if (Hp, Wp) != (Hr, Wr):
            h = h[:, :Hr, :Wr]
        x = shortcut + layer_norm_f32(self.norm1, h)
        h = F.gelu(dense(self.mlp_fc1, x))
        return x + layer_norm_f32(self.norm2, dense(self.mlp_fc2, h))


class PatchMerging(nn.Module):
    """2x2 spatial merge: concat -> Linear(4C, 2C) -> LayerNorm (v2 order)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return layer_norm_f32(self.norm, dense(self.reduction, x))


class SwinV2Backbone(nn.Module):
    """Four-stage Swin V2 encoder returning hooked stage features (NHWC).

    ``input_size`` is the (H, W) of the images it will see: the stage
    resolutions, windows and shift masks are fixed by it.
    """

    def __init__(
        self,
        cfg: SwinV2Config,
        hooks: Sequence[int] = (1, 1, 5, 1),
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cfg, self.hooks = cfg, tuple(hooks)
        H, W = input_size or (cfg.img_size, cfg.img_size)
        if H % cfg.patch_size or W % cfg.patch_size:
            raise ValueError(f"input {H}x{W} not divisible by patch size {cfg.patch_size}")
        self.input_size = (H, W)
        self.patch_embed = nn.Conv2d(
            cfg.in_chans, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size
        )
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        grid = (H // cfg.patch_size, W // cfg.patch_size)
        for i, depth in enumerate(cfg.depths):
            if self.hooks[i] >= depth:
                raise ValueError(f"hook {self.hooks[i]} out of range for stage {i} (depth {depth})")
            res = (grid[0] >> i, grid[1] >> i)
            dim = cfg.stage_dims[i]
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}", SwinV2Block(
                    dim, cfg.num_heads[i], res, cfg.window_size, j % 2 == 1,
                    cfg.pretrained_window_sizes[i], cfg.mlp_ratio,
                ))
            if i < len(cfg.depths) - 1:
                setattr(self, f"downsample{i}", PatchMerging(dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if tuple(x.shape[1:3]) != self.input_size:
            raise ValueError(f"backbone built for {self.input_size}, got {tuple(x.shape[1:3])}")
        x = layer_norm_f32(self.patch_norm, conv_nhwc(self.patch_embed, x))
        feats = []
        for i, depth in enumerate(self.cfg.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
                if j == self.hooks[i]:
                    feats.append(x)
            if i < len(self.cfg.depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return tuple(feats)


def make_swin2_backbone(
    backbone: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """Returns (module factory, stage channel widths)."""
    cfg = SWIN2_CONFIGS[backbone]
    hooks = tuple(hooks) if hooks is not None else SWIN2_HOOKS[backbone]
    factory = functools.partial(SwinV2Backbone, cfg=cfg, hooks=hooks, input_size=input_size)
    return factory, cfg.stage_dims
