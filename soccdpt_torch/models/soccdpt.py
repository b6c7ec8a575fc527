"""SOccDPT model family (the port of ``soccdpt_tpu/models/soccdpt.py``).

``model(x)`` takes (B, 3, h, w) normalized images and returns
``(inv_depth, segmentation, points, occupancy_grid_or_None)``:

* ``inv_depth``      (B, H, W)      upsampled to camera resolution
* ``segmentation``   (B, C, H, W)
* ``points``         (B, H, W, 3)   camera-frame point cloud
* ``occupancy_grid`` (B, gx, gy, gz, C) when ``compute_occ``

``return_raw=True`` gives the net-resolution (inv_depth, seg) pair. The
network runs in ``cfg.compute_dtype``; the geometry tail runs in f32 in
either case, since kernel K2 accumulates f32 and bf16 coordinates would
move points by whole voxels.

Only V3, the published flagship, is ported so far.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..ops.geometry import get_semantic_occupancy
from .backbones import dpt_extras, make_backbone
from .dpt import DPT
from .heads import DepthHead, OccupancyHead, SegHead


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _head_features(cfg: ModelConfig):
    """(head_features_1, head_features_2); LeViT overrides to (64, 8)."""
    if cfg.model_type == "dpt_levit_224":
        return cfg.head_features_1 or 64, 8
    return cfg.head_features_1 or cfg.features, cfg.head_features_2


class SOccDPT_V3(nn.Module):
    """Depth DPT with ``return_features``; the seg head rides the depth
    decoder's fused features (the published flagship)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        net_w, net_h = cfg.net_size
        bb, chans = make_backbone(cfg.backbone, input_size=(net_h, net_w))
        hf1, hf2 = _head_features(cfg)
        self.depth_net = DPT(
            backbone=bb,
            in_channels=chans,
            head=functools.partial(DepthHead, cfg.features, hf1, hf2, cfg.non_negative),
            features=cfg.features,
            return_features=True,
            **dpt_extras(cfg.backbone),
        )
        self.seg_head = SegHead(cfg.num_classes, cfg.features, cfg.sigmoid)
        self.occupancy_conv = OccupancyHead(cfg.num_classes, identity=not cfg.occupancy_head)

    def forward(
        self,
        x: torch.Tensor,
        compute_occ: Optional[bool] = None,
        return_raw: bool = False,
        output_size: Optional[Tuple[int, int]] = None,
    ):
        cfg = self.cfg
        x = x.permute(0, 2, 3, 1).to(compute_dtype(cfg))
        inv_depth, feats = self.depth_net(x)
        seg = self.seg_head(feats)
        inv_depth = inv_depth[..., 0]  # (B, h, w)
        seg = seg.permute(0, 3, 1, 2)  # (B, C, h, w)
        if return_raw:
            return inv_depth, seg
        occ = cfg.compute_occ if compute_occ is None else compute_occ
        inv_d, seg_up, points, grid = get_semantic_occupancy(
            inv_depth.float(), seg.float(), cfg.camera, cfg.occupancy, cfg.num_classes,
            compute_occ=occ, output_size=output_size,
        )
        if grid is not None:
            grid = self.occupancy_conv(grid)
        return inv_d, seg_up, points, grid


def build_model(
    cfg: ModelConfig,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
) -> nn.Module:
    """The model of ``cfg`` in eval mode on ``device`` (the card unless
    ``device`` says otherwise), with weights drawn from numpy seed ``seed``
    (``weights.init_random_``); load real weights with
    ``weights.load_jax_variables``."""
    from ..weights import init_random_

    dev = resolve_device(device)
    if cfg.version != 3:
        raise NotImplementedError(
            f"SOccDPT V{cfg.version} is not ported to soccdpt_torch yet (see ROADMAP.md)"
        )
    model = SOccDPT_V3(cfg)
    init_random_(model, seed)
    return model.to(dev).eval()
