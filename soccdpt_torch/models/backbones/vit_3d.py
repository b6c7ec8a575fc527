"""ViT3D: a volumetric transformer over the occupancy grid (the port of
``soccdpt_tpu/models/backbones/vit_3d.py``).

A standalone module, as the JAX package keeps it (no model calls it): the
(B, gx, gy, gz, C) grid is cut into 3-D patches by a strided 3-D conv,
embedded, given a class token and a learned position embedding, run
through pre-norm transformer blocks, and either classified from the
class token (``mode="classify"``) or decoded back into per-voxel class
residuals added to the grid before a sigmoid (``mode="refine"``).

The attention blocks are flax's ``MultiHeadDotProductAttention``: the
``query``, ``key``, ``value`` and ``out`` projections are
``DenseGeneral`` layers whose ``kernel`` and ``bias`` are kept here in
flax's own shapes ((E, heads, head_dim), (heads, head_dim, E)), so
``weights.load_jax_variables`` copies them as they are. Logits and
softmax in f32; LayerNorms in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import cast_param, conv3d, dense, layer_norm_f32


class DenseGeneral(nn.Module):
    """A projection with flax ``DenseGeneral``'s parameter shapes: into
    heads, ``kernel`` (E, H, D) and ``bias`` (H, D); out of them, ``kernel``
    (H, D, E) and ``bias`` (E,)."""

    def __init__(self, kernel_shape: Tuple[int, ...], bias_shape: Tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x: torch.Tensor, equation: str) -> torch.Tensor:
        k, b = cast_param(self, "kernel", x.dtype), cast_param(self, "bias", x.dtype)
        return torch.einsum(equation, x, k) + b


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention with flax's parameter tree (``query``, ``key``,
    ``value``, ``out``); queries scaled by ``head_dim ** -0.5``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        hd = dim // num_heads
        self.query = DenseGeneral((dim, num_heads, hd), (num_heads, hd))
        self.key = DenseGeneral((dim, num_heads, hd), (num_heads, hd))
        self.value = DenseGeneral((dim, num_heads, hd), (num_heads, hd))
        self.out = DenseGeneral((num_heads, hd, dim), (dim,))
        self.head_dim = hd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query(x, "bne,ehd->bnhd") * self.head_dim**-0.5
        k = self.key(x, "bne,ehd->bnhd")
        v = self.value(x, "bne,ehd->bnhd")
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.out(out, "bnhd,hde->bne")


class ViT3D(nn.Module):
    """``forward(grid)`` takes (B, gx, gy, gz, C); ``grid_size`` (gx, gy, gz)
    sizes the position embedding."""

    def __init__(
        self,
        grid_size: Tuple[int, int, int] = (256, 256, 32),
        patch_size: Tuple[int, int, int] = (16, 16, 8),
        embed_dim: int = 256,
        depth: int = 4,
        num_heads: int = 8,
        mlp_ratio: float = 4.0,
        num_classes: int = 3,
        mode: str = "refine",
    ):
        super().__init__()
        if mode not in ("refine", "classify"):
            raise ValueError(f"mode {mode!r}: 'refine' or 'classify'")
        if any(g % p for g, p in zip(grid_size, patch_size)):
            raise ValueError(f"grid {grid_size} is not a multiple of the patch {patch_size}")
        self.grid_size, self.patch_size = tuple(grid_size), tuple(patch_size)
        self.embed_dim, self.depth, self.mode = embed_dim, depth, mode
        self.num_classes = num_classes
        n_tokens = 1
        for g, p in zip(grid_size, patch_size):
            n_tokens *= g // p
        self.patch_embed = nn.Conv3d(num_classes, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens + 1, embed_dim))
        hidden = int(embed_dim * mlp_ratio)
        for i in range(depth):
            setattr(self, f"norm1_{i}", nn.LayerNorm(embed_dim, eps=1e-5))
            setattr(self, f"attn_{i}", MultiHeadDotProductAttention(embed_dim, num_heads))
            setattr(self, f"norm2_{i}", nn.LayerNorm(embed_dim, eps=1e-5))
            setattr(self, f"mlp1_{i}", nn.Linear(embed_dim, hidden))
            setattr(self, f"mlp2_{i}", nn.Linear(hidden, embed_dim))
        if mode == "classify":
            self.head_norm = nn.LayerNorm(embed_dim, eps=1e-5)
            self.head = nn.Linear(embed_dim, num_classes)
        else:
            px, py, pz = patch_size
            self.unpatch = nn.Linear(embed_dim, px * py * pz * num_classes)

    def forward(self, grid: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``dtype`` is the compute dtype of the trunk (default: the grid's);
        the refined grid, or the class logits, are f32."""
        B, gx, gy, gz, C = grid.shape
        if (gx, gy, gz) != self.grid_size:
            raise ValueError(f"ViT3D built for the grid {self.grid_size}, got {(gx, gy, gz)}")
        dtype = dtype or grid.dtype
        px, py, pz = self.patch_size
        nx, ny, nz = gx // px, gy // py, gz // pz
        E = self.embed_dim
        x = conv3d(self.patch_embed, grid.to(dtype).permute(0, 4, 1, 2, 3))  # (B, E, nx, ny, nz)
        x = x.permute(0, 2, 3, 4, 1).reshape(B, nx * ny * nz, E)
        cls = cast_param(self, "cls_token", dtype).expand(B, 1, E)
        x = torch.cat([cls, x], dim=1) + cast_param(self, "pos_embed", dtype)
        for i in range(self.depth):
            h = getattr(self, f"attn_{i}")(layer_norm_f32(getattr(self, f"norm1_{i}"), x))
            x = x + h
            h = layer_norm_f32(getattr(self, f"norm2_{i}"), x)
            h = dense(getattr(self, f"mlp2_{i}"), F.gelu(dense(getattr(self, f"mlp1_{i}"), h)))
            x = x + h
        if self.mode == "classify":
            cls_out = layer_norm_f32(self.head_norm, x[:, 0].float())
            return dense(self.head, cls_out)
        vox = dense(self.unpatch, x[:, 1:])
        vox = vox.reshape(B, nx, ny, nz, px, py, pz, self.num_classes)
        vox = vox.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, gx, gy, gz, self.num_classes)
        return torch.sigmoid(grid.float() + vox.float())

