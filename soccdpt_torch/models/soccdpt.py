"""SOccDPT model family: V1, V2, V3 (the port of ``soccdpt_tpu/models/soccdpt.py``).

``model(x)`` takes (B, 3, h, w) normalized images and returns
``(inv_depth, segmentation, points, occupancy_grid_or_None)``:

* ``inv_depth``      (B, H, W)      upsampled to camera resolution
* ``segmentation``   (B, C, H, W)
* ``points``         (B, H, W, 3)   camera-frame point cloud
* ``occupancy_grid`` (B, gx, gy, gz, C) when ``compute_occ``

``return_raw=True`` gives the net-resolution (inv_depth, seg) pair, which
is what training differentiates. In training mode (``model.train()``)
BatchNorm takes batch statistics and the seg head's dropout and the
Swin blocks' stochastic depth draw from the ``generator`` argument. The
network runs in ``cfg.compute_dtype``; the geometry tail runs in f32 in
either case, since kernel K2 accumulates f32 and bf16 coordinates would
move points by whole voxels.

The versions differ in how depth and segmentation share the network:

* V1: two whole DPTs, ``depth_net`` (a depth head, no BatchNorm) and
  ``seg_net`` (BatchNorm in its fusion blocks and a seg head that is
  always sigmoid, whatever ``cfg.sigmoid`` says), each with its own
  backbone;
* V2: one trunk, ``pretrained``, with an identity head, then a
  ``depth_head`` and a ``seg_head`` on its features;
* V3 (the published flagship): the depth DPT returns its fused features
  beside its depth, and the ``seg_head`` rides them.

Submodules carry the JAX package's flax scope names, so
``weights.load_jax_variables`` maps a JAX tree onto any version.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..ops.geometry import get_semantic_occupancy
from .backbones import dpt_extras, make_backbone
from .dpt import DPT
from .heads import DepthHead, IdentityHead, OccupancyHead, SegHead


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _head_features(cfg: ModelConfig):
    """(head_features_1, head_features_2); LeViT overrides to (64, 8)."""
    if cfg.model_type == "dpt_levit_224":
        return cfg.head_features_1 or 64, 8
    return cfg.head_features_1 or cfg.features, cfg.head_features_2


def _head_in(cfg: ModelConfig) -> int:
    """Channels the heads read: the fused features, or what LeViT's stem
    transpose makes of them (64)."""
    stem = dpt_extras(cfg.backbone).get("stem_transpose")
    return cfg.features if stem is None else stem.out_channels


def _depth_head(cfg: ModelConfig) -> Callable[[], DepthHead]:
    hf1, hf2 = _head_features(cfg)
    return functools.partial(DepthHead, _head_in(cfg), hf1, hf2, cfg.non_negative)


def _seg_head(cfg: ModelConfig, sigmoid: bool) -> Callable[[], SegHead]:
    return functools.partial(SegHead, cfg.num_classes, cfg.features, sigmoid,
                             in_features=_head_in(cfg))


def _dpt(cfg: ModelConfig, remat: bool, head: Callable[[], nn.Module], **kwargs) -> DPT:
    """A DPT on its own backbone of ``cfg``."""
    net_w, net_h = cfg.net_size
    bb, chans = make_backbone(cfg.backbone, input_size=(net_h, net_w), remat=remat)
    return DPT(backbone=bb, in_channels=chans, head=head, features=cfg.features,
               **kwargs, **dpt_extras(cfg.backbone))


class _SOccDPT(nn.Module):
    """What the versions share: the config, the occupancy refiner and the
    geometry tail (the JAX package's ``_GeometryMixin._finish``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def _add_occupancy_head(self) -> None:
        """Registered last: ``init_random_`` draws in registration order,
        so a seed gives a version's networks the same weights whether or
        not the 3-D head is on."""
        self.occupancy_conv = OccupancyHead(self.cfg.num_classes,
                                            identity=not self.cfg.occupancy_head)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).to(compute_dtype(self.cfg))

    def _finish(
        self,
        inv_depth_nhwc: torch.Tensor,
        seg_nhwc: torch.Tensor,
        compute_occ: Optional[bool],
        return_raw: bool,
        output_size: Optional[Tuple[int, int]],
    ):
        cfg = self.cfg
        inv_depth = inv_depth_nhwc[..., 0]  # (B, h, w)
        seg = seg_nhwc.permute(0, 3, 1, 2)  # (B, C, h, w)
        if return_raw:
            return inv_depth, seg
        occ = cfg.compute_occ if compute_occ is None else compute_occ
        inv_d, seg_up, points, grid = get_semantic_occupancy(
            inv_depth.float(), seg.float(), cfg.camera, cfg.occupancy, cfg.num_classes,
            compute_occ=occ, output_size=output_size,
        )
        if grid is not None:
            grid = self.occupancy_conv(grid, compute_dtype(cfg))
        return inv_d, seg_up, points, grid


class SOccDPT_V1(_SOccDPT):
    """Two independent DPTs, depth and segmentation."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        super().__init__(cfg)
        self.depth_net = _dpt(cfg, remat, _depth_head(cfg), use_bn=False)
        # the reference's segmentation DPT forces BatchNorm and a sigmoid
        self.seg_net = _dpt(cfg, remat, _seg_head(cfg, True), use_bn=True)
        self._add_occupancy_head()

    def forward(
        self,
        x: torch.Tensor,
        compute_occ: Optional[bool] = None,
        return_raw: bool = False,
        output_size: Optional[Tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        x = self._input(x)
        inv_depth = self.depth_net(x, generator=generator)
        seg = self.seg_net(x, generator=generator)
        return self._finish(inv_depth, seg, compute_occ, return_raw, output_size)


class SOccDPT_V2(_SOccDPT):
    """One shared DPT trunk (identity head), separate depth and seg heads."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        super().__init__(cfg)
        self.pretrained = _dpt(cfg, remat, IdentityHead)
        self.depth_head = _depth_head(cfg)()
        self.seg_head = _seg_head(cfg, cfg.sigmoid)()
        self._add_occupancy_head()

    def forward(
        self,
        x: torch.Tensor,
        compute_occ: Optional[bool] = None,
        return_raw: bool = False,
        output_size: Optional[Tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        feats = self.pretrained(self._input(x), generator=generator)
        inv_depth = self.depth_head(feats)
        seg = self.seg_head(feats, generator)
        return self._finish(inv_depth, seg, compute_occ, return_raw, output_size)


class SOccDPT_V3(_SOccDPT):
    """Depth DPT with ``return_features``; the seg head rides the depth
    decoder's fused features (the published flagship)."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        super().__init__(cfg)
        self.depth_net = _dpt(cfg, remat, _depth_head(cfg), return_features=True)
        self.seg_head = _seg_head(cfg, cfg.sigmoid)()
        self._add_occupancy_head()

    def forward(
        self,
        x: torch.Tensor,
        compute_occ: Optional[bool] = None,
        return_raw: bool = False,
        output_size: Optional[Tuple[int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        inv_depth, feats = self.depth_net(self._input(x), generator=generator)
        seg = self.seg_head(feats, generator)
        return self._finish(inv_depth, seg, compute_occ, return_raw, output_size)


SOccDPT_versions = {1: SOccDPT_V1, 2: SOccDPT_V2, 3: SOccDPT_V3}


def build_model(
    cfg: ModelConfig,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    remat: bool = False,
) -> nn.Module:
    """The model of ``cfg`` in eval mode on ``device`` (the card unless
    ``device`` says otherwise), with weights drawn from numpy seed ``seed``
    (``weights.init_random_``); load real weights with
    ``weights.load_jax_variables``. ``remat`` recomputes the Swin-V2 blocks
    in the backward pass. A trainer calls ``.train()`` itself. Raises
    ``ValueError`` for a version the JAX package does not have."""
    from ..weights import init_random_

    if cfg.version not in SOccDPT_versions:
        raise ValueError(
            f"SOccDPT has versions {sorted(SOccDPT_versions)}, not V{cfg.version}"
        )
    dev = resolve_device(device)
    model = SOccDPT_versions[cfg.version](cfg, remat=remat)
    init_random_(model, seed)
    return model.to(dev).eval()


# --- single-output adapters ---------------------------------------------------


def depth_net(fn: Callable) -> Callable:
    """Wrap a model or a serving function to give only the inverse depth."""

    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs)[0]

    return wrapped


def seg_net(fn: Callable) -> Callable:
    """Wrap a model or a serving function to give only the segmentation."""

    def wrapped(*args, **kwargs):
        return fn(*args, **kwargs)[1]

    return wrapped
