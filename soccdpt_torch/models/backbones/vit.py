"""ViT and BEiT backbones for DPT (the port of
``soccdpt_tpu/models/backbones/vit.py``).

A plain single-scale transformer runs once; the activations of four
hooked blocks are lifted into a 4-level pyramid by the MiDaS
"act_postprocess" recipe:

  level 1: readout -> 1x1 conv -> 4x conv-transpose   (stride 4)
  level 2: readout -> 1x1 conv -> 2x conv-transpose   (stride 8)
  level 3: readout -> 1x1 conv                        (stride 16)
  level 4: readout -> 1x1 conv -> 3x3 stride-2 conv   (stride 32)

The readout handles the cls token: "project" concatenates it to every
patch token through Linear(2C -> C) + GELU, "ignore" drops it.

ViT: a learned absolute pos-embed, bilinearly resized when the runtime
grid differs from the pretrain grid. BEiT: no absolute pos-embed; each
block gathers a relative-position bias over the grid (plus cls-token
rows) from its ``rel_pos_table`` and scales its branches by LayerScale
gammas. The gathered bias depends on parameters only and is folded at
bind time (``models/bias_cache.py``).

Attention of both families runs through kernel K6
(``kernels/global_attention.py``): BEiT with its bias, ViT without.
``forward`` takes NHWC images and returns NHWC stage features.
Submodules are named after the flax scopes (``block3.mlp_fc1``,
``readout1.project``, ``up4x``, ...) so ``weights.load_jax_variables``
maps one tree onto the other by name.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...kernels.global_attention import global_attention
from ...ops.resize import resize_hw
from ..bias_cache import cached_bias
from ..layers import conv_nhwc, conv_transpose_nhwc, dense, layer_norm_f32


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 384
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    family: str = "vit"  # "vit" | "beit"
    readout: str = "project"  # "project" | "ignore"
    post_channels: Tuple[int, int, int, int] = (96, 192, 384, 768)  # pyramid widths
    layer_scale_init: float = 0.1  # beit only


VIT_CONFIGS = {
    "vitb16_384": ViTConfig(),
    "vitl16_384": ViTConfig(
        embed_dim=1024, depth=24, num_heads=16, post_channels=(256, 512, 1024, 1024),
    ),
    "beitb16_384": ViTConfig(family="beit", post_channels=(96, 192, 384, 768)),
    "beitl16_384": ViTConfig(
        family="beit", embed_dim=1024, depth=24, num_heads=16,
        post_channels=(256, 512, 1024, 1024),
    ),
    "beitl16_512": ViTConfig(
        family="beit", img_size=512, embed_dim=1024, depth=24, num_heads=16,
        post_channels=(256, 512, 1024, 1024),
    ),
    # Tiny configs for fast unit tests on CPU.
    "vittest_64": ViTConfig(
        img_size=64, patch_size=8, embed_dim=32, depth=4, num_heads=2,
        post_channels=(16, 32, 64, 128),
    ),
    "beittest_64": ViTConfig(
        family="beit", img_size=64, patch_size=8, embed_dim=32, depth=4,
        num_heads=2, post_channels=(16, 32, 64, 128),
    ),
}

VIT_HOOKS = {
    "vitb16_384": (2, 5, 8, 11),
    "vitl16_384": (5, 11, 17, 23),
    "beitb16_384": (2, 5, 8, 11),
    "beitl16_384": (5, 11, 17, 23),
    "beitl16_512": (5, 11, 17, 23),
    "vittest_64": (0, 1, 2, 3),
    "beittest_64": (0, 1, 2, 3),
}


@functools.lru_cache(maxsize=32)
def _beit_rel_pos_index(gh: int, gw: int) -> np.ndarray:
    """(1+N, 1+N) index into the rel-pos table incl. cls-token rows.

    The table layout is timm BEiT's: spatial entries
    0..(2gh-1)(2gw-1)-1, then cls->token, token->cls and cls->cls as the
    last three rows."""
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    idx = np.zeros((gh * gw + 1, gh * gw + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel  # cls -> token
    idx[0:, 0] = num_rel + 1  # token -> cls
    idx[0, 0] = num_rel + 2  # cls -> cls
    return idx


class TransformerBlock(nn.Module):
    """Pre-norm block: x + [gamma_1] attn(norm1(x)); x + [gamma_2] mlp(norm2(x)).

    ``grid`` is the (gh, gw) patch grid a BEiT block's ``rel_pos_table``
    is sized for. LayerNorm eps is 1e-6 (timm's ViT/BEiT, unlike Swin's
    1e-5) and runs in f32.
    """

    def __init__(self, cfg: ViTConfig, grid: Tuple[int, int]):
        super().__init__()
        self.cfg, self.grid = cfg, tuple(grid)
        C, beit = cfg.embed_dim, cfg.family == "beit"
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.qkv = nn.Linear(C, 3 * C, bias=not beit)
        self.proj = nn.Linear(C, C)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.mlp_fc1 = nn.Linear(C, int(C * cfg.mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(C * cfg.mlp_ratio), C)
        if beit:
            # q and v biases only: BEiT's k bias is zero
            self.q_bias = nn.Parameter(torch.zeros(C))
            self.v_bias = nn.Parameter(torch.zeros(C))
            num_rel = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
            self.rel_pos_table = nn.Parameter(torch.zeros(num_rel, cfg.num_heads))
            self.gamma_1 = nn.Parameter(torch.full((C,), cfg.layer_scale_init))
            self.gamma_2 = nn.Parameter(torch.full((C,), cfg.layer_scale_init))
            self.register_buffer(
                "position_index",
                torch.from_numpy(_beit_rel_pos_index(*self.grid).reshape(-1)),
                persistent=False,
            )
            self.register_buffer("bias_cache", None, persistent=False)
            self._bias_key = None

    def bias_params(self):
        return (self.rel_pos_table,)

    def compute_bias(self, grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """(H, T, T) f32 relative-position bias gathered for ``grid``
        (the block's own unless given), T = 1 + gh * gw."""
        index = self.position_index
        if grid is not None and tuple(grid) != self.grid:
            num_rel = (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3
            if num_rel != self.rel_pos_table.shape[0]:
                raise ValueError(
                    f"rel_pos_table holds {self.rel_pos_table.shape[0]} rows, for the "
                    f"{self.grid} grid; a {tuple(grid)} grid needs {num_rel}"
                )
            index = torch.from_numpy(_beit_rel_pos_index(*grid).reshape(-1)).to(index.device)
        T = int(round(index.numel() ** 0.5))
        return self.rel_pos_table[index].reshape(T, T, -1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        """x: (B, 1 + gh * gw, C), the cls token first."""
        cfg = self.cfg
        B, T, C = x.shape
        H = cfg.num_heads
        beit = cfg.family == "beit"

        h = layer_norm_f32(self.norm1, x)
        qkv = dense(self.qkv, h)
        if beit:
            qkv = qkv + torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]
            ).to(x.dtype)
        q, k, v = qkv.reshape(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)  # (B, H, T, hd) each
        bias = None
        if beit:
            # folded at bind time for the block's own grid; another grid is
            # gathered inline, as a cache keyed by grid would miss
            bias = cached_bias(self) if tuple(grid) == self.grid else self.compute_bias(grid)
        out = global_attention(q, k, v, bias, scale=(C // H) ** -0.5)
        out = dense(self.proj, out.transpose(1, 2).reshape(B, T, C))
        if beit:
            out = out * self.gamma_1.to(out.dtype)
        x = x + out

        h = layer_norm_f32(self.norm2, x)
        h = dense(self.mlp_fc2, F.gelu(dense(self.mlp_fc1, h)))
        if beit:
            h = h * self.gamma_2.to(h.dtype)
        return x + h


class Readout(nn.Module):
    """cls-token readout: (B, 1+N, C) -> (B, N, C)."""

    def __init__(self, mode: str, dim: int):
        super().__init__()
        if mode not in ("project", "ignore"):
            raise ValueError(f"unknown readout mode {mode!r}")
        self.mode = mode
        if mode == "project":
            self.project = nn.Linear(2 * dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cls, patches = tokens[:, :1], tokens[:, 1:]
        if self.mode == "ignore":
            return patches
        x = torch.cat([patches, cls.expand_as(patches)], dim=-1)
        return F.gelu(dense(self.project, x))


class ViTBackbone(nn.Module):
    """Single-scale ViT/BEiT encoder -> 4-level pyramid (NHWC).

    ``input_size`` is the (H, W) of the images a BEiT backbone will see:
    its relative-position tables are sized for that grid. A ViT backbone
    takes any size its patch divides (the pos-embed is resized).
    """

    def __init__(
        self,
        cfg: ViTConfig,
        hooks: Sequence[int] = (2, 5, 8, 11),
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.cfg, self.hooks = cfg, tuple(hooks)
        if len(set(self.hooks)) != 4 or not all(0 <= h < cfg.depth for h in self.hooks):
            raise ValueError(f"need 4 distinct hooks below depth {cfg.depth}, got {self.hooks}")
        p, C = cfg.patch_size, cfg.embed_dim
        H, W = input_size or (cfg.img_size, cfg.img_size)
        if H % p or W % p:
            raise ValueError(f"input {H}x{W} not divisible by patch size {p}")
        self.grid = (H // p, W // p)
        self.patch_embed = nn.Conv2d(3, C, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.family == "vit":
            g0 = cfg.img_size // p
            self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g0 * g0, C))
        for i in range(cfg.depth):
            setattr(self, f"block{i}", TransformerBlock(cfg, self.grid))
        for lvl, ch in enumerate(cfg.post_channels):
            setattr(self, f"readout{lvl + 1}", Readout(cfg.readout, C))
            setattr(self, f"proj{lvl + 1}", nn.Conv2d(C, ch, 1))
        ch = cfg.post_channels
        self.up4x = nn.ConvTranspose2d(ch[0], ch[0], 4, stride=4)
        self.up2x = nn.ConvTranspose2d(ch[1], ch[1], 2, stride=2)
        self.down2x = nn.Conv2d(ch[3], ch[3], 3, stride=2, padding=1)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        """``generator`` is the interface every backbone shares and is not
        used: these blocks have neither dropout nor stochastic depth, as in
        the JAX package."""
        cfg = self.cfg
        B, H, W, _ = x.shape
        p, C = cfg.patch_size, cfg.embed_dim
        if H % p or W % p:
            raise ValueError(f"input {H}x{W} not divisible by patch size {p}")
        gh, gw = H // p, W // p

        tokens = conv_nhwc(self.patch_embed, x).reshape(B, gh * gw, C)
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, C)
        tokens = torch.cat([cls, tokens], dim=1)

        if cfg.family == "vit":
            g0 = cfg.img_size // p
            cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
            if (gh, gw) != (g0, g0):
                patch_pos = resize_hw(
                    patch_pos.reshape(1, g0, g0, C), (gh, gw), "bilinear", False
                ).reshape(1, gh * gw, C)
            tokens = tokens + torch.cat([cls_pos, patch_pos], dim=1).to(tokens.dtype)

        feats = []
        for i in range(cfg.depth):
            tokens = getattr(self, f"block{i}")(tokens, (gh, gw))
            if i in self.hooks:
                feats.append(tokens)

        outs = []
        for lvl, tok in enumerate(feats):
            h = getattr(self, f"readout{lvl + 1}")(tok).reshape(B, gh, gw, C)
            h = conv_nhwc(getattr(self, f"proj{lvl + 1}"), h)
            if lvl == 0:
                h = conv_transpose_nhwc(self.up4x, h)
            elif lvl == 1:
                h = conv_transpose_nhwc(self.up2x, h)
            elif lvl == 3:
                h = conv_nhwc(self.down2x, h)
            outs.append(h)
        return tuple(outs)


def make_vit_backbone(
    backbone: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """Returns (module factory, stage channel widths)."""
    cfg = VIT_CONFIGS[backbone]
    hooks = tuple(hooks) if hooks is not None else VIT_HOOKS[backbone]
    factory = functools.partial(ViTBackbone, cfg=cfg, hooks=hooks, input_size=input_size)
    return factory, cfg.post_channels
