"""DPT-Hybrid trunk (timm's ``vit_base_r50_s16_384``), plain: a BiT
ResNet-50 stem and stages 0-2, then a ViT-B over the /16 map. Sizes come
from the configuration file.

The ResNet: convs without bias whose kernels are standardized per output
channel over (in, kh, kw) (mean and biased variance, eps 1e-8), TF-SAME
padding on the stride-2 convs (the 7x7 stem, each stage's first 3x3
``conv2``) and on the 3x3/2 max-pool (padded with -inf), GroupNorm(32,
eps 1e-5) in f32, v1.5 bottlenecks that are not pre-activated (conv ->
GN -> ReLU twice, conv -> GN, the shortcut GN(1x1 conv) on a stage's first
block, ReLU after the residual add). Stage 0's and 1's outputs are
pyramid levels 1 and 2.

The ViT: a 1x1 patch embedding of stage 2's map, the cls token, a learned
position embedding (resized bilinearly, ``align_corners=False``, only where
the token grid is not the one of ``img_size``), pre-norm blocks (LayerNorm
eps 1e-6, qkv with a bias, softmax in f32, GELU MLP, no LayerScale), and
the blocks ``hooks`` read out by MiDaS's "project" (the cls token
concatenated to every patch token, Linear, GELU), 1x1 projections
(``proj3``, ``proj4``) and a stride-2 conv (``down2x``) on level 4.

Departures from timm and DPT (the program's and the JAX package's too):
NHWC at module boundaries and the program's parameter names; the
standardized kernel cast to the activations' dtype before the product
(a departure only outside f32); GroupNorm computed in f32 and cast back,
as autocast runs timm's under AMP; no final LayerNorm after the last
block, which timm's model has and DPT never reads; eval only (no dropout
or drop path).

The family ``vit_hybrid``: ``TRUNK``, its weight rule, its K6 launches
(``k6_calls``, no bias) and a test-sized trunk (``TINY``). The shared
rules cover every leaf but one kind (standardization takes away a conv
kernel's scale, so the fan-in rule only sets its shape): the scale of each
bottleneck's last GroupNorm (``gn3``, ``BranchEnd``) is drawn near 0.1, as
BEiT's LayerScale is. With the shared norm scale near 1, sixteen seeded
bottlenecks are chaotic: bf16 rounding grows by 0.03-0.04 of stage 2's
spread a block, to about 0.46 at its end, and the served bf16 program then
lies as far from the f32 reference as half the fp8 control does. timm
starts the same scale at zero (``zero_init_last``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L
from .beit import Readout
from .precision import act_dtype, operand

WS_EPS = 1e-8


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one axis: ``ceil(size / stride)``
    outputs, the odd pixel after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x_nchw: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    top, bottom = same_pads(x_nchw.shape[-2], kernel, stride)
    left, right = same_pads(x_nchw.shape[-1], kernel, stride)
    return F.pad(x_nchw, (left, right, top, bottom), value=value)


class StdConv(nn.Conv2d):
    """A conv without bias whose kernel is standardized per output
    channel, TF-SAME padded, on NHWC."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + WS_EPS)).to(x.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        y = F.conv2d(operand(pad_same(x.permute(0, 3, 1, 2), k, s)), operand(w), None, s)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in f32 on NHWC, cast back to the activations' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2).float(), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(act_dtype())


class BranchEnd(GroupNorm):
    """The last GroupNorm of a bottleneck's branch, before the residual add."""


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int, first: bool, groups: int):
        super().__init__()
        self.first = first
        if first:
            self.downsample_conv = StdConv(cin, out, 1, stride)
            self.downsample_gn = GroupNorm(groups, out, eps=1e-5)
        self.conv1 = StdConv(cin, mid, 1)
        self.gn1 = GroupNorm(groups, mid, eps=1e-5)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.gn2 = GroupNorm(groups, mid, eps=1e-5)
        self.conv3 = StdConv(mid, out, 1)
        self.gn3 = BranchEnd(groups, out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.downsample_gn(self.downsample_conv(x)) if self.first else x
        h = F.relu(self.gn1(self.conv1(x)))
        h = F.relu(self.gn2(self.conv2(h)))
        return F.relu(self.gn3(self.conv3(h)) + shortcut)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        H = self.heads
        qkv = L.linear(self.qkv, L.layer_norm(self.norm1, x))
        q, k, v = qkv.reshape(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
        s = L.matmul(q, k.transpose(-2, -1)).float() * (C // H) ** -0.5
        out = L.matmul(L.softmax(s, v.dtype), v).transpose(1, 2).reshape(B, T, C)
        x = x + L.linear(self.proj, out)
        h = L.linear(self.mlp_fc2, F.gelu(L.linear(self.mlp_fc1, L.layer_norm(self.norm2, x))))
        return x + h


class ViTHybrid(nn.Module):
    """``cfg``: the ``backbone`` entry of a configuration file."""

    def __init__(self, cfg: dict, input_size: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        w, groups, C = cfg["stem_width"], cfg["gn_groups"], cfg["embed_dim"]
        self.channels = tuple(cfg["post_channels"])
        self.stem_conv = StdConv(3, w, 7, 2)
        self.stem_gn = GroupNorm(groups, w, eps=1e-5)
        cin = w
        for s, depth in enumerate(cfg["stage_blocks"]):
            out = w * 4 * 2**s
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", Bottleneck(
                    cin, out // 4, out, 2 if s > 0 and b == 0 else 1, b == 0, groups))
                cin = out
        self.patch_embed_proj = nn.Conv2d(cin, C, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.g0 = cfg["img_size"] // cfg["patch_size"]
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.g0 * self.g0, C))
        for i in range(cfg["depth"]):
            setattr(self, f"block{i}", Block(C, cfg["num_heads"], cfg["mlp_ratio"]))
        for lvl in (3, 4):
            setattr(self, f"readout{lvl}", Readout(C))
            setattr(self, f"proj{lvl}", nn.Conv2d(C, self.channels[lvl - 1], 1))
        self.down2x = nn.Conv2d(self.channels[3], self.channels[3], 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        cfg = self.cfg
        B, C, g0 = x.shape[0], cfg["embed_dim"], self.g0
        h = F.relu(self.stem_gn(self.stem_conv(x)))
        h = F.max_pool2d(pad_same(h.permute(0, 3, 1, 2), 3, 2, float("-inf")), 3, 2)
        h = h.permute(0, 2, 3, 1)
        feats = []
        for s, depth in enumerate(cfg["stage_blocks"]):
            for b in range(depth):
                h = getattr(self, f"stage{s}_block{b}")(h)
            if s < 2:
                feats.append(h)
        gh, gw = h.shape[1], h.shape[2]
        tokens = L.conv(self.patch_embed_proj, h).reshape(B, gh * gw, C)
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(B, 1, C), tokens], dim=1)
        patch_pos = self.pos_embed[:, 1:]
        if (gh, gw) != (g0, g0):
            patch_pos = L.resize(patch_pos.reshape(1, g0, g0, C), (gh, gw), "bilinear")
            patch_pos = patch_pos.reshape(1, gh * gw, C)
        tokens = tokens + torch.cat([self.pos_embed[:, :1], patch_pos], 1).to(tokens.dtype)
        hooked = []
        for i in range(cfg["depth"]):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in cfg["hooks"]:
                hooked.append(tokens)
        for lvl, tok in zip((3, 4), hooked):
            t = getattr(self, f"readout{lvl}")(tok).reshape(B, gh, gw, C)
            t = L.conv(getattr(self, f"proj{lvl}"), t)
            feats.append(L.conv(self.down2x, t) if lvl == 4 else t)
        return tuple(feats)


TRUNK = ViTHybrid

# A test-sized trunk of the family, for the harness's CPU tests: the
# program's model type, its (backbone, net_w, net_h) entry, and the
# backbone as a configuration file gives it (the program's hybridtest_64).
TINY = ("dpt_hybridtest_64", ("hybridtest_64", 64, 64), {
    "family": "vit_hybrid", "img_size": 64, "stem_width": 32, "stage_blocks": [1, 1, 1],
    "gn_groups": 32, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
    "mlp_ratio": 4.0, "readout": "project", "hooks": [0, 1],
    "post_channels": [128, 256, 32, 32]})


def weight_rule(mod: nn.Module, name: str, t: torch.Tensor):
    """The scales of the bottlenecks' last GroupNorms; ``None`` for the
    rest."""
    if name == "weight" and isinstance(mod, BranchEnd):
        return 0.1, 0.02
    return None


def k6_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, T, d, bias itemsize) of each ViT block's K6 launch in a
    request of ``batch`` frames at the configuration's net size: the
    tokens of the /16 map (each stride-2 stage rounds up, TF-SAME) and
    the cls, no bias."""
    b = cfg["backbone"]
    net_w, net_h = cfg["net_size"]
    p, heads = b["patch_size"], b["num_heads"]
    gh, gw = (-(-n // p) for n in (net_h, net_w))
    tokens = gh * gw + 1
    return [(batch, heads, tokens, b["embed_dim"] // heads, 0)] * b["depth"]
