"""SOccDPT V3, plain: a trunk (its family's module, found by name),
DPT's reassemble convs and fusion decoder (residual conv units, 1x1 out
conv, bilinear upsampling with aligned corners), the depth head (conv,
2x up, conv, ReLU, 1x1 conv, ReLU) that also hands its fused features to
the segmentation head (conv without bias, BatchNorm, ReLU, 1x1 conv, 2x
up, sigmoid or scaled tanh). The parameters carry the program's names,
so one state dict loads into both. It serves: eval mode only, dropout
off.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L
from .precision import act_dtype

HERE = Path(__file__).resolve().parent


def trunk_module(cfg: dict) -> ModuleType:
    """The module of the configuration's trunk family,
    ``benchmark/reference/<family>.py``. It gives ``TRUNK``, the class of
    a module built as ``TRUNK(backbone_cfg, (net_h, net_w))``, with
    ``channels`` (four widths), whose forward takes NHWC images to four
    NHWC maps; and it may
    give ``weight_rule(mod, name, t)`` (``(mean, std)`` of a leaf, or
    ``None`` for the shared rules), ``k1_calls(cfg, batch)`` and
    ``k6_calls(cfg, batch)`` (one tuple a launch of a request, as
    ``benchmark/work.py`` counts them), and ``TINY``, the test-sized trunk
    that the harness's CPU tests shrink its cells to."""
    family = cfg["backbone"]["family"]
    path = HERE.relative_to(HERE.parents[1]) / f"{family}.py"
    name, missing = f"{__package__}.{family}", f"no trunk family {family!r}: no {path}"
    if not family.isidentifier():
        raise FileNotFoundError(missing)
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise FileNotFoundError(missing) from None
    if not hasattr(module, "TRUNK"):
        raise AttributeError(f"{path} gives no TRUNK")
    return module


def kernel_calls(cfg: dict, kernel: str, batch: int) -> Optional[list]:
    """The trunk's ``<kernel>_calls(cfg, batch)`` at the configuration's
    net size, or ``None`` where its family gives none."""
    calls = getattr(trunk_module(cfg), f"{kernel}_calls", None)
    return None if calls is None else calls(cfg, batch)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return L.conv(self.conv2, F.relu(L.conv(self.conv1, F.relu(x)))) + x


class Fusion(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res_conv_unit1 = ResidualConvUnit(features)
        self.res_conv_unit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.res_conv_unit1(skip)
        out = L.conv(self.out_conv, self.res_conv_unit2(x))
        size = size or (out.shape[1] * 2, out.shape[2] * 2)
        return L.resize(out, size, "bilinear", align_corners=True)


class DepthHead(nn.Module):
    def __init__(self, features: int, hf2: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(features // 2, hf2, 3, padding=1)
        self.conv3 = nn.Conv2d(hf2, 1, 1)

    def forward(self, x):
        x = L.conv(self.conv1, x)
        x = L.resize(x, (x.shape[1] * 2, x.shape[2] * 2), "bilinear", align_corners=True)
        x = L.conv(self.conv3, F.relu(L.conv(self.conv2, x)))
        return F.relu(x)


class SegHead(nn.Module):
    def __init__(self, num_classes: int, features: int, sigmoid: bool):
        super().__init__()
        self.sigmoid = sigmoid
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(features, num_classes, 1)

    def forward(self, x):
        x = F.relu(L.batch_norm(self.bn, L.conv(self.conv1, x)))
        x = L.conv(self.conv2, x)
        x = L.resize(x, (x.shape[1] * 2, x.shape[2] * 2), "bilinear", align_corners=True)
        return torch.sigmoid(x) if self.sigmoid else 0.5 * torch.tanh(x) + 0.5


class DepthNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        net_w, net_h = cfg["net_size"]
        self.backbone = trunk_module(cfg).TRUNK(cfg["backbone"], (net_h, net_w))
        f = cfg["features"]
        for i, c in enumerate(self.backbone.channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        self.refinenet4 = Fusion(f, with_skip=False)
        self.refinenet3 = Fusion(f)
        self.refinenet2 = Fusion(f)
        self.refinenet1 = Fusion(f)
        self.head = DepthHead(f, cfg["head_features_2"])

    def forward(self, x):
        rn = [L.conv(getattr(self, f"layer{i + 1}_rn"), t)
              for i, t in enumerate(self.backbone(x))]
        path = self.refinenet4(rn[3], size=tuple(rn[2].shape[1:3]))
        path = self.refinenet3(path, rn[2], size=tuple(rn[1].shape[1:3]))
        path = self.refinenet2(path, rn[1], size=tuple(rn[0].shape[1:3]))
        path = self.refinenet1(path, rn[0])
        return self.head(path), path


class SOccDPTV3(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.depth_net = DepthNet(cfg)
        self.seg_head = SegHead(cfg["num_classes"], cfg["features"], cfg["sigmoid"])

    def forward(self, image: torch.Tensor):
        """(B, 3, h, w) normalized images -> net-resolution inverse depth
        (B, h, w) and segmentation (B, C, h, w)."""
        inv, feats = self.depth_net(image.permute(0, 2, 3, 1).to(act_dtype()))
        seg = self.seg_head(feats)
        return inv[..., 0], seg.permute(0, 3, 1, 2)


def preprocess(frames_u8: torch.Tensor, net_size) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, net_h, net_w): /255, (x - 0.5) / 0.5,
    a bicubic resize without antialiasing."""
    net_w, net_h = net_size
    x = (frames_u8.to(act_dtype()) / 255.0 - 0.5) / 0.5
    return L.resize(x, (net_h, net_w), "bicubic").permute(0, 3, 1, 2)
