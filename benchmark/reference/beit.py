"""BEiT trunk, plain: pre-norm blocks with a relative-position bias
gathered per block from its table (timm's layout, the cls rows last),
q and v biases, LayerScale gammas; four hooked blocks lifted into a
pyramid by MiDaS's readout ("project": the cls token concatenated to
every patch token, Linear, GELU), 1x1 projections, a 4x and a 2x
transposed conv and a stride-2 conv. Sizes come from the configuration
file.

The family ``beit``: ``TRUNK``, its weight rules (position tables wide
enough that an attention that dropped its bias could not pass,
LayerScale near its 0.1), its K6 launches (``k6_calls``) and a
test-sized trunk (``TINY``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L


def rel_pos_index(g: int) -> np.ndarray:
    """(1 + g*g, 1 + g*g) index into the table, cls rows last."""
    num_rel = (2 * g - 1) ** 2
    coords = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += g - 1
    rel[:, :, 1] += g - 1
    rel[:, :, 0] *= 2 * g - 1
    idx = np.zeros((g * g + 1, g * g + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel
    idx[0:, 0] = num_rel + 1
    idx[0, 0] = num_rel + 2
    return idx


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, grid: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.grid = heads, grid
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * grid - 1) ** 2 + 3, heads))
        self.gamma_1 = nn.Parameter(torch.zeros(dim))
        self.gamma_2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H = self.heads
        h = L.layer_norm(self.norm1, x)
        qkv = L.linear(self.qkv, h) + torch.cat(
            [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]).to(x.dtype)
        q, k, v = qkv.reshape(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
        index = torch.as_tensor(rel_pos_index(self.grid).reshape(-1), device=x.device)
        bias = self.rel_pos_table[index].reshape(T, T, H).permute(2, 0, 1)
        s = L.matmul(q, k.transpose(-2, -1)).float() * (C // H) ** -0.5 + bias[None]
        out = L.matmul(L.softmax(s, v.dtype), v).transpose(1, 2).reshape(B, T, C)
        x = x + L.linear(self.proj, out) * self.gamma_1.to(x.dtype)
        h = L.linear(self.mlp_fc2, F.gelu(L.linear(self.mlp_fc1, L.layer_norm(self.norm2, x))))
        return x + h * self.gamma_2.to(x.dtype)


class Readout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Linear(2 * dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cls, patches = tokens[:, :1], tokens[:, 1:]
        return F.gelu(L.linear(self.project, torch.cat([patches, cls.expand_as(patches)], -1)))


class BEiT(nn.Module):
    """``cfg``: the ``backbone`` entry of a configuration file."""

    def __init__(self, cfg: dict, input_size: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        p, C = cfg["patch_size"], cfg["embed_dim"]
        self.grid = input_size[0] // p
        ch = tuple(cfg["post_channels"])
        self.channels = ch
        self.patch_embed = nn.Conv2d(3, C, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        for i in range(cfg["depth"]):
            setattr(self, f"block{i}", Block(C, cfg["num_heads"], self.grid, cfg["mlp_ratio"]))
        for lvl, c in enumerate(ch):
            setattr(self, f"readout{lvl + 1}", Readout(C))
            setattr(self, f"proj{lvl + 1}", nn.Conv2d(C, c, 1))
        self.up4x = nn.ConvTranspose2d(ch[0], ch[0], 4, stride=4)
        self.up2x = nn.ConvTranspose2d(ch[1], ch[1], 2, stride=2)
        self.down2x = nn.Conv2d(ch[3], ch[3], 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        B = x.shape[0]
        g, C = self.grid, self.cfg["embed_dim"]
        tokens = L.conv(self.patch_embed, x).reshape(B, g * g, C)
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(B, 1, C), tokens], dim=1)
        feats = []
        for i in range(self.cfg["depth"]):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in self.cfg["hooks"]:
                feats.append(tokens)
        outs = []
        for lvl, tok in enumerate(feats):
            h = getattr(self, f"readout{lvl + 1}")(tok).reshape(B, g, g, C)
            h = L.conv(getattr(self, f"proj{lvl + 1}"), h)
            if lvl == 0:
                h = L.conv_transpose(self.up4x, h)
            elif lvl == 1:
                h = L.conv_transpose(self.up2x, h)
            elif lvl == 3:
                h = L.conv(self.down2x, h)
            outs.append(h)
        return tuple(outs)


TRUNK = BEiT

# A test-sized trunk of the family, for the harness's CPU tests: the
# program's model type, its (backbone, net_w, net_h) entry, and the
# backbone as a configuration file gives it.
TINY = ("dpt_beit_test_64", ("beittest_64", 64, 64), {
    "family": "beit", "img_size": 64, "patch_size": 8, "embed_dim": 32, "depth": 4,
    "num_heads": 2, "mlp_ratio": 4.0, "post_channels": [16, 32, 64, 128],
    "hooks": [0, 1, 2, 3]})


def weight_rule(mod: nn.Module, name: str, t: torch.Tensor):
    """The relative-position tables and the LayerScale gammas; ``None``
    for the rest."""
    if name == "rel_pos_table":
        return 0.0, 0.5
    if name in ("gamma_1", "gamma_2"):
        return 0.1, 0.02
    return None


def k6_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, T, d, bias itemsize) of each block's K6 launch in a request
    of ``batch`` frames at the configuration's net size: the patch tokens
    and the cls, the f32 relative-position bias."""
    b = cfg["backbone"]
    net_w, net_h = cfg["net_size"]
    p, heads = b["patch_size"], b["num_heads"]
    tokens = (net_h // p) * (net_w // p) + 1
    return [(batch, heads, tokens, b["embed_dim"] // heads, 4)] * b["depth"]
