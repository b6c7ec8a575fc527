"""ViT-hybrid (ResNet50 + ViT-B) backbone for ``dpt_hybrid_384`` (the port
of ``soccdpt_tpu/models/backbones/vit_hybrid.py``).

timm's hybrid trunk (``_resnetv2(layers=(3, 4, 9), preact=False,
stem_type='same', conv_layer=StdConv2dSame(eps=1e-8))``):
weight-standardized convs with TF-SAME padding, GroupNorm(32), v1.5
bottlenecks that are not pre-activated (conv -> GN/ReLU, ReLU after the
residual add). Stage-0/1 outputs are pyramid levels 1-2 (256 ch @ /4, 512
ch @ /8); a ViT-B over the /16 stage-2 features gives levels 3-4 from the
activations of blocks 8 and 11 (768 ch @ /16, /32).

Where the arithmetic is the JAX package's own:

* weight standardization in f32 at every forward (mean and biased
  variance over (kh, kw, in), eps 1e-8), the standardized kernel then
  cast to the compute dtype, as flax's ``nn.Conv`` casts the param its
  ``WSConv`` returns; without gradients the standardized kernel is kept
  and reused until the weight changes (``layers.cast_param``'s key);
* GroupNorm in f32, cast back;
* TF-SAME padding: the stride-2 7x7 stem conv, the stride-2 3x3 ``conv2``
  and the 3x3/2 max-pool pad more on the bottom and right; the pool pads
  with -inf;
* the position embedding is resized bilinearly (``align_corners=False``)
  when the /16 grid is not the 384 grid.

The ViT blocks are ``vit.TransformerBlock``: their attention is kernel K6
(``kernels/global_attention.py``), with no bias, and its backward K7.
``forward`` takes NHWC images and returns NHWC stage features. Submodules
carry the flax scope names (``stem_conv``, ``stage1_block0.gn2``,
``patch_embed_proj``, ``block7.qkv``, ``readout3.project``, ``down2x``),
so ``weights.load_jax_variables`` maps one tree onto the other by name.

Counters (``counts()``), read like ``kernels.ops.launches()``:
``group_norm_nhwc.calls`` counts GroupNorms run (52 a forward of
``vitb_rn50_384``), ``standardized_weight.misses`` the kernels
standardized rather than taken from the cache (none after the first
forward without gradients). Both count Python calls: a CUDA graph counts
once, at its capture, and its replays count nothing. There is no host
span here: a served request is one graph replay, so a span around the
stem would time its capture alone; the device time of the GroupNorms is
read from the kernels' names in a profile instead.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_hw
from ..layers import conv_nhwc
from .vit import Readout, TransformerBlock, ViTConfig

WS_EPS = 1e-8
GN_GROUPS, GN_EPS = 32, 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one axis: ``ceil(size / stride)``
    outputs, the odd pixel of padding after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    top, bottom = same_pads(x_nchw.shape[-2], kernel, stride)
    left, right = same_pads(x_nchw.shape[-1], kernel, stride)
    if top or bottom or left or right:
        x_nchw = F.pad(x_nchw, (left, right, top, bottom), value=value)
    return x_nchw


def standardized_weight(mod: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``mod.weight`` standardized per output channel in f32, in ``dtype``.
    Without gradients the result is cached on the module, keyed by the
    weight's storage and version counter; while ``torch.export`` traces it
    is computed in the program."""
    w = mod.weight
    cached = not torch.is_grad_enabled() and not torch.compiler.is_compiling()
    if cached:
        key = (w.data_ptr(), w._version, dtype)
        hit = mod.__dict__.get("_ws_cache")
        if hit is not None and hit[0] == key:
            return hit[1]
    standardized_weight.misses += 1
    wf = w.float()
    var, mean = torch.var_mean(wf, dim=(1, 2, 3), unbiased=False, keepdim=True)
    out = ((wf - mean) * torch.rsqrt(var + WS_EPS)).to(dtype)
    if cached:
        mod.__dict__["_ws_cache"] = (key, out.detach())
    return out


class WSConv(nn.Conv2d):
    """Weight-standardized conv without bias (BiT / ResNetV2), TF-SAME
    padded, on NHWC."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        y = F.conv2d(_pad_same(x.permute(0, 3, 1, 2), k, s),
                     standardized_weight(self, x.dtype), None, s)
        return y.permute(0, 2, 3, 1)


def group_norm_nhwc(mod: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm in f32 on NHWC, cast back to x's dtype."""
    group_norm_nhwc.calls += 1
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), mod.num_groups, mod.weight, mod.bias,
                     mod.eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


standardized_weight.misses = 0
group_norm_nhwc.calls = 0


def counts() -> Dict[str, int]:
    """The trunk's counts so far: GroupNorm calls, weight standardizations."""
    return {"group_norm": group_norm_nhwc.calls,
            "standardized_weight": standardized_weight.misses}


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


class BottleneckV15(nn.Module):
    """timm ResNetV2 ``preact=False`` Bottleneck (HF BitBottleneckLayer):
    conv1 -> GN/ReLU -> conv2 (stride, TF-SAME) -> GN/ReLU -> conv3 -> GN,
    shortcut GN(conv1x1(x)) on the first block of a stage, ReLU after the
    residual add."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1, is_first: bool = False):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.downsample_conv = WSConv(cin, out, 1, stride)
            self.downsample_gn = _gn(out)
        self.conv1 = WSConv(cin, mid, 1)
        self.gn1 = _gn(mid)
        self.conv2 = WSConv(mid, mid, 3, stride)
        self.gn2 = _gn(mid)
        self.conv3 = WSConv(mid, out, 1)
        self.gn3 = _gn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.is_first:
            shortcut = group_norm_nhwc(self.downsample_gn, self.downsample_conv(x))
        h = F.relu(group_norm_nhwc(self.gn1, self.conv1(x)))
        h = F.relu(group_norm_nhwc(self.gn2, self.conv2(h)))
        h = group_norm_nhwc(self.gn3, self.conv3(h))
        return F.relu(h + shortcut)


@dataclass(frozen=True)
class HybridConfig:
    img_size: int = 384
    stem_width: int = 64
    stage_blocks: Tuple[int, int, int] = (3, 4, 9)
    vit: ViTConfig = field(default_factory=lambda: ViTConfig(img_size=384, patch_size=16))
    vit_hooks: Tuple[int, int] = (8, 11)
    post_channels: Tuple[int, int, int, int] = (256, 512, 768, 768)


HYBRID_CONFIGS = {
    "vitb_rn50_384": HybridConfig(),
    "hybridtest_64": HybridConfig(
        img_size=64,
        stem_width=32,
        stage_blocks=(1, 1, 1),
        vit=ViTConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2),
        vit_hooks=(0, 1),
        post_channels=(128, 256, 32, 32),
    ),
}


class ViTHybridBackbone(nn.Module):
    """ResNet stem and stages 0-2, then a ViT over the /16 map; NHWC in,
    the 4-level pyramid out."""

    def __init__(self, cfg: HybridConfig):
        super().__init__()
        self.cfg = cfg
        w, vit = cfg.stem_width, cfg.vit
        self.stem_conv = WSConv(3, w, 7, 2)
        self.stem_gn = _gn(w)
        chans, cin = (w * 4, w * 8, w * 16), w
        for s, depth in enumerate(cfg.stage_blocks):
            for b in range(depth):
                setattr(self, f"stage{s}_block{b}", BottleneckV15(
                    cin, chans[s] // 4, chans[s], stride=2 if (s > 0 and b == 0) else 1,
                    is_first=(b == 0)))
                cin = chans[s]
        C = vit.embed_dim
        self.patch_embed_proj = nn.Conv2d(cin, C, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        g0 = vit.img_size // 16
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g0 * g0, C))
        for i in range(vit.depth):
            # a ViT block's grid only sizes a BEiT table: none here
            setattr(self, f"block{i}", TransformerBlock(vit, (g0, g0)))
        for lvl in (3, 4):
            ch = cfg.post_channels[lvl - 1]
            setattr(self, f"readout{lvl}", Readout(vit.readout, C))
            setattr(self, f"proj{lvl}", nn.Conv2d(C, ch, 1))
        ch = cfg.post_channels[3]
        self.down2x = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, ...]:
        """``generator`` is the interface every backbone shares and is not
        used: nothing here draws at random, as in the JAX package."""
        cfg, vit = self.cfg, self.cfg.vit
        B = x.shape[0]
        h = F.relu(group_norm_nhwc(self.stem_gn, self.stem_conv(x)))
        # after the ReLU every value is >= 0, so the pool's -inf padding
        # gives what a zero-padded pool (HF BitMaxPool2d) gives
        h = F.max_pool2d(_pad_same(h.permute(0, 3, 1, 2), 3, 2, float("-inf")), 3, 2)
        h = h.permute(0, 2, 3, 1)

        feats = []
        for s, depth in enumerate(cfg.stage_blocks):
            for b in range(depth):
                h = getattr(self, f"stage{s}_block{b}")(h)
            if s < 2:
                feats.append(h)  # 256 @ /4, 512 @ /8

        C = vit.embed_dim
        gh, gw = h.shape[1], h.shape[2]
        tokens = conv_nhwc(self.patch_embed_proj, h).reshape(B, gh * gw, C)
        cls = self.cls_token.to(tokens.dtype).expand(B, 1, C)
        tokens = torch.cat([cls, tokens], dim=1)
        g0 = vit.img_size // 16
        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (g0, g0):
            patch_pos = resize_hw(
                patch_pos.reshape(1, g0, g0, C), (gh, gw), "bilinear", False
            ).reshape(1, gh * gw, C)
        tokens = tokens + torch.cat([cls_pos, patch_pos], dim=1).to(tokens.dtype)

        hooked = []
        for i in range(vit.depth):
            tokens = getattr(self, f"block{i}")(tokens, (gh, gw))
            if i in cfg.vit_hooks:
                hooked.append(tokens)

        for lvl, tok in zip((3, 4), hooked):
            t = getattr(self, f"readout{lvl}")(tok).reshape(B, gh, gw, C)
            t = conv_nhwc(getattr(self, f"proj{lvl}"), t)
            if lvl == 4:
                t = conv_nhwc(self.down2x, t)
            feats.append(t)
        return tuple(feats)


def make_vit_hybrid_backbone(backbone: str, hooks: Optional[Sequence[int]] = None):
    """Returns (module factory, stage channel widths). Four ``hooks`` set
    the two ViT blocks read out (the last two), as in the JAX package."""
    cfg = HYBRID_CONFIGS[backbone]
    if hooks is not None and len(hooks) == 4:
        cfg = HybridConfig(
            img_size=cfg.img_size,
            stem_width=cfg.stem_width,
            stage_blocks=cfg.stage_blocks,
            vit=cfg.vit,
            vit_hooks=(hooks[2], hooks[3]),
            post_channels=cfg.post_channels,
        )
    factory = functools.partial(ViTHybridBackbone, cfg=cfg)
    return factory, cfg.post_channels
