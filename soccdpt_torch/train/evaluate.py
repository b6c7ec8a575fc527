"""Validation-set evaluation (the port of ``soccdpt_tpu/train/evaluate.py``).

The reference's metrics with the reference's protocol: predictions resized
(bicubic, ``align_corners=False``) to GT resolution, depth re-aligned per
image with the closed-form scale and shift before scoring, per-class IoU
at a 0.5 threshold, and the occupancy grid's IoU (the reference leaves it
a 0.0 TODO, utils/__init__.py:504).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.resize import resize_nchw
from .metrics import occupancy_iou, seg_iou, ssi_aligned_depth_metrics


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_eval_forward(model: torch.nn.Module) -> Callable:
    """A deterministic forward, the model in eval mode and no gradients:
    a (B, 3, h, w) batch (numpy or tensor) -> the raw (inv_depth, seg) at
    net resolution, on the model's device. The folded attention biases
    are served from the cache (``models/bias_cache.py``), rebuilt if the
    weights moved since they were folded."""
    device = _device_of(model)

    @torch.no_grad()
    def run(image):
        model.eval()
        return model(torch.as_tensor(image).to(device), return_raw=True)

    return run


def make_occupancy_forward(model: torch.nn.Module) -> Callable:
    """As ``make_eval_forward``, giving the (B, gx, gy, gz, C) grid."""
    device = _device_of(model)

    @torch.no_grad()
    def run(image):
        model.eval()
        return model(torch.as_tensor(image).to(device), compute_occ=True)[3]

    return run


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def evaluate_depth_seg(
    forward: Callable,
    batches,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Aggregate depth metrics + seg IoU over an iterable of batches."""
    depth_sums: Dict[str, list] = {}
    ious = []
    n = 0
    for batch in batches:
        if max_batches is not None and n >= max_batches:
            break
        inv_depth, seg = forward(batch["image"])
        gt_disp = np.asarray(batch["disparity"], np.float32)
        gt_seg = np.asarray(batch["seg"], np.float32)
        mask = np.asarray(batch["mask_disp"], bool)
        gt_hw = gt_disp.shape[-2:]

        disp_pred = _np(resize_nchw(inv_depth.float(), gt_hw, "bicubic", False))
        seg_pred = _np(resize_nchw(seg.float(), gt_hw, "bicubic", False))

        m = ssi_aligned_depth_metrics(gt_disp, disp_pred, mask)
        for k, v in m.as_dict().items():
            depth_sums.setdefault(k, []).append(v)
        ious.append(seg_iou(gt_seg, seg_pred))
        n += 1

    out = {k: float(np.mean(v)) for k, v in depth_sums.items()}
    out["iou"] = float(np.mean(ious)) if ious else 0.0
    return out


def evaluate_occupancy(
    forward_occ: Callable,
    batches,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Occupancy-grid IoU over an iterable of batches."""
    ious = []
    n = 0
    for batch in batches:
        if max_batches is not None and n >= max_batches:
            break
        grid_pred = forward_occ(batch["image"])
        ious.append(occupancy_iou(np.asarray(batch["occupancy_grid"]), _np(grid_pred)))
        n += 1
    return {"iou_3D": float(np.mean(ious)) if ious else 0.0}
