"""Swin Transformer V2 trunk, plain: post-norm blocks, scaled-cosine
window attention with a logit scale clamped at log 100, the log-spaced
continuous position bias MLP (16 sigmoid), shifted windows with the
-100 mask, a stage padded up to whole windows (the padding a masked
region of its own), patch merging (reduction, then norm); stochastic depth is
off when serving. Sizes come from the configuration file.

The family ``swin2``: ``TRUNK``, its weight rule (the logit scale near
log 10), its K1 launches (``k1_calls``) and a test-sized trunk (``TINY``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def relative_coords_table(ws: int, pretrained: int) -> np.ndarray:
    h = np.arange(-(ws - 1), ws, dtype=np.float64)
    table = np.stack(np.meshgrid(h, h, indexing="ij"), axis=-1)
    table /= (pretrained - 1) if pretrained > 0 else max(ws - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def shift_mask(res: int, ws: int, shift: int, padded: int) -> Optional[np.ndarray]:
    """(windows, N, N) additive mask of shifted or padded windows: -100
    between tokens of different regions; the padding is a region of its
    own."""
    if shift == 0 and padded == res:
        return None
    img = np.zeros((padded, padded), np.int32)
    if shift:
        cnt = 0
        bands = (slice(0, padded - ws), slice(padded - ws, padded - shift),
                 slice(padded - shift, padded))
        for hs in bands:
            for wsl in bands:
                img[hs, wsl] = cnt
                cnt += 1
    img[res:, :] = -1
    img[:, res:] = -1
    n = padded // ws
    mw = img.reshape(n, ws, n, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, pretrained: int):
        super().__init__()
        self.heads, self.ws, self.pretrained = heads, ws, pretrained
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.zeros(heads, 1, 1))
        self.cpb_mlp_0 = nn.Linear(2, 512)
        self.cpb_mlp_1 = nn.Linear(512, heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def bias(self, device) -> torch.Tensor:
        table = torch.as_tensor(relative_coords_table(self.ws, self.pretrained), device=device)
        cpb = L.linear(self.cpb_mlp_1, F.relu(L.linear(self.cpb_mlp_0, table)))
        index = torch.as_tensor(relative_position_index(self.ws).reshape(-1), device=device)
        N = self.ws * self.ws
        return 16.0 * torch.sigmoid(cpb[index].reshape(N, N, self.heads).permute(2, 0, 1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        Bw, N, C = x.shape
        H = self.heads
        qkv = L.linear(self.qkv, x) + torch.cat(
            [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]).to(x.dtype)
        q, k, v = qkv.reshape(Bw, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q = q / torch.clamp(torch.linalg.vector_norm(q.float(), dim=-1, keepdim=True),
                            min=1e-12).to(x.dtype)
        k = k / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True),
                            min=1e-12).to(x.dtype)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        attn = L.matmul(q, k.transpose(-2, -1)).float() * scale + self.bias(x.device)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bw // nW, nW, H, N, N) + mask[None, :, None]).reshape(
                Bw, H, N, N)
        out = L.matmul(L.softmax(attn, v.dtype), v)
        return L.linear(self.proj, out.transpose(1, 2).reshape(Bw, N, C))


class Block(nn.Module):
    def __init__(self, dim, heads, res, window, shift, pretrained, mlp_ratio):
        super().__init__()
        self.ws = min(window, res)
        self.shift = self.ws // 2 if (shift and self.ws < res) else 0
        self.res = res
        self.padded = math.ceil(res / self.ws) * self.ws  # whole windows
        self.attn = WindowAttention(dim, heads, self.ws, pretrained)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        B, R, _, C = x.shape
        ws, s, P = self.ws, self.shift, self.padded
        h = F.pad(x, (0, 0, 0, P - R, 0, P - R)) if P > R else x
        h = torch.roll(h, shifts=(-s, -s), dims=(1, 2)) if s else h
        win = h.reshape(B, P // ws, ws, P // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(-1, ws * ws, C)
        m = shift_mask(R, ws, s, P)
        win = self.attn(win, None if m is None else torch.as_tensor(m, device=x.device))
        h = win.reshape(B, P // ws, P // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(B, P, P, C)
        if s:
            h = torch.roll(h, shifts=(s, s), dims=(1, 2))
        h = h[:, :R, :R]
        h = L.layer_norm(self.norm1, h)
        x = x + h
        h = L.linear(self.mlp_fc2, F.gelu(L.linear(self.mlp_fc1, x)))
        h = L.layer_norm(self.norm2, h)
        return x + h


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return L.layer_norm(self.norm, L.linear(self.reduction, x))


class SwinV2(nn.Module):
    """``cfg``: the ``backbone`` entry of a configuration file."""

    def __init__(self, cfg: dict, input_size: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        depths, heads = cfg["depths"], cfg["num_heads"]
        dims = [cfg["embed_dim"] * 2**i for i in range(len(depths))]
        self.channels = tuple(dims)
        p = cfg["patch_size"]
        self.patch_embed = nn.Conv2d(3, cfg["embed_dim"], p, stride=p)
        self.patch_norm = nn.LayerNorm(cfg["embed_dim"], eps=1e-5)
        grid = input_size[0] // p
        for i, depth in enumerate(depths):
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}", Block(
                    dims[i], heads[i], grid >> i, cfg["window_size"], j % 2 == 1,
                    cfg["pretrained_window_sizes"][i], cfg["mlp_ratio"]))
            if i < len(depths) - 1:
                setattr(self, f"downsample{i}", PatchMerging(dims[i]))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = L.layer_norm(self.patch_norm, L.conv(self.patch_embed, x))
        feats = []
        depths, hooks = self.cfg["depths"], self.cfg["hooks"]
        for i, depth in enumerate(depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
                if j == hooks[i]:
                    feats.append(x)
            if i < len(depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return tuple(feats)


TRUNK = SwinV2

# A test-sized trunk of the family, for the harness's CPU tests: the
# program's model type, its (backbone, net_w, net_h) entry, and the
# backbone as a configuration file gives it.
TINY = ("dpt_swin2_test_64", ("swin2test_64", 64, 64), {
    "family": "swin2", "img_size": 64, "patch_size": 4, "embed_dim": 16,
    "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 4,
    "pretrained_window_sizes": [0, 0, 0, 0], "mlp_ratio": 4.0, "drop_path_rate": 0.1,
    "hooks": [1, 1, 1, 1]})


def weight_rule(mod: nn.Module, name: str, t: torch.Tensor):
    """The attention's logit scale near log 10; ``None`` for the rest."""
    if name == "logit_scale":
        return math.log(10.0), 0.05
    return None


def k1_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int, int, int]]:
    """(Bw, H, N, d, nW) of each block's K1 launch in a request of
    ``batch`` frames, in block order, as the program runs the trunk at the
    configuration's net size: stage i at the patch grid halved i times,
    its window clamped to the stage, the stage padded up to whole windows;
    the f32 (nW, N, N) mask where the block shifts (odd blocks whose
    window is smaller than the stage) or pads."""
    b = cfg["backbone"]
    net_w, net_h = cfg["net_size"]
    out = []
    for i, depth in enumerate(b["depths"]):
        h, w = (net_h // b["patch_size"]) >> i, (net_w // b["patch_size"]) >> i
        ws = min(b["window_size"], h, w)
        windows = math.ceil(h / ws) * math.ceil(w / ws)
        padded = h % ws != 0 or w % ws != 0
        heads = b["num_heads"][i]
        d = b["embed_dim"] * 2**i // heads
        for j in range(depth):
            masked = padded or (j % 2 == 1 and ws < min(h, w))
            out.append((batch * windows, heads, ws * ws, d, windows if masked else 0))
    return out
