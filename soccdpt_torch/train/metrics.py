"""Evaluation metrics (the port of ``soccdpt_tpu/train/metrics.py``).

Depth: abs_rel, sq_rel, RMSE, RMSE_log and delta < 1.25^k over the masked
pixels, with NaN and Inf clamped to 0. Segmentation: per-class IoU at a
0.5 threshold, averaged over classes. Evaluation first re-aligns the
prediction to the GT with the closed-form scale and shift. Metrics
aggregate over a validation set on the host, in numpy; tensors are
accepted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from .losses import compute_scale_and_shift


@dataclass
class DepthMetrics:
    abs_rel: float
    sq_rel: float
    rmse: float
    rmse_log: float
    a1: float
    a2: float
    a3: float

    def as_dict(self) -> Dict[str, float]:
        return self.__dict__.copy()


def _np(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _clamp(v: float) -> float:
    return 0.0 if (np.isinf(v) or np.isnan(v)) else float(v)


def compute_masked_errors(gt, pred, mask) -> DepthMetrics:
    """The seven depth errors over the pixels where ``mask`` is true."""
    g = _np(gt, np.float64)[_np(mask, bool)]
    p = _np(pred, np.float64)[_np(mask, bool)]
    if not g.size:
        return DepthMetrics(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        thresh = np.maximum(g / p, p / g)
        a1, a2, a3 = (_clamp((thresh < 1.25**k).mean()) for k in (1, 2, 3))
        rmse = _clamp(np.sqrt(((g - p) ** 2).mean()))
        rmse_log = _clamp(np.sqrt(((np.log(g) - np.log(p)) ** 2).mean()))
        abs_rel = _clamp(np.mean(np.abs(g - p) / g))
        sq_rel = _clamp(np.mean(((g - p) ** 2) / g))
    return DepthMetrics(abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)


def ssi_aligned_depth_metrics(gt, pred, mask) -> DepthMetrics:
    """Align ``pred`` to ``gt`` with the closed-form scale and shift, then
    score."""
    pred = _np(pred, np.float32)
    scale, shift = compute_scale_and_shift(
        torch.from_numpy(pred),
        torch.from_numpy(_np(gt, np.float32)),
        torch.from_numpy(_np(mask, np.float32)),
    )
    pred_ssi = scale.numpy()[:, None, None] * pred + shift.numpy()[:, None, None]
    return compute_masked_errors(gt, pred_ssi, mask)


def seg_iou(gt, pred, threshold: float = 0.5) -> float:
    """Class-averaged IoU on (B, C, H, W) mask probabilities."""
    gt, pred = _np(gt), _np(pred)
    num_classes = pred.shape[1]
    iou = np.zeros((gt.shape[0],), np.float64)
    for c in range(num_classes):
        pm = pred[:, c] > threshold
        gm = gt[:, c] > threshold
        inter = np.logical_and(pm, gm).sum(axis=(1, 2))
        union = np.logical_or(pm, gm).sum(axis=(1, 2))
        iou += inter / (union + 1e-7)
    return float(np.mean(iou / num_classes))


def occupancy_iou(gt_grid, pred_grid, threshold: float = 0.5) -> float:
    """3-D occupancy IoU over (B, gx, gy, gz, C) grids."""
    gt = _np(gt_grid) > threshold
    pred = _np(pred_grid) > threshold
    inter = np.logical_and(gt, pred).sum()
    union = np.logical_or(gt, pred).sum()
    return float(inter / (union + 1e-7))
