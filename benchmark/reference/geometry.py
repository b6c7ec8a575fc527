"""Inverse depth and segmentation at net size -> camera-resolution
outputs, points and the semantic occupancy grid, plain. Each stage is a
function of its own, so a served output can be judged from the served
output before it. All of it runs in :func:`precision.tail_dtype`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import tail_dtype


def upsample(inv_depth: torch.Tensor, seg: torch.Tensor, hw):
    """(B, h, w), (B, C, h, w) -> inverse depth (B, H, W) by bicubic
    (a = -0.75, no aligned corners) and segmentation (B, C, H, W) by
    nearest neighbour."""
    dt = tail_dtype()
    inv = F.interpolate(inv_depth[:, None].to(dt), size=tuple(hw), mode="bicubic",
                        align_corners=False, antialias=False)[:, 0]
    seg = F.interpolate(seg.to(dt), size=tuple(hw), mode="nearest")
    return inv, seg


def unproject(inv_depth: torch.Tensor, camera: dict) -> torch.Tensor:
    """(B, H, W) inverse depth -> (B, H, W, 3) camera-frame points:
    depth 1 / max(inv, 1e-8), X = (col - cx) Z / fx, Y = (row - cy) Z / fy."""
    dt = tail_dtype()
    depth = 1.0 / torch.clamp(inv_depth.to(dt), min=1e-8)
    _, H, W = depth.shape
    u = torch.arange(H, dtype=dt, device=depth.device)[:, None]
    v = torch.arange(W, dtype=dt, device=depth.device)[None, :]
    x = (v - camera["cx"]) * depth / camera["fx"]
    y = (u - camera["cy"]) * depth / camera["fy"]
    return torch.stack([x, y, depth], dim=-1)


def rotation(angles_deg) -> np.ndarray:
    a, b, c = (math.radians(v) for v in angles_deg)
    ra = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    rb = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rc = np.array([[math.cos(c), -math.sin(c), 0], [math.sin(c), math.cos(c), 0], [0, 0, 1]])
    return (ra @ rb @ rc).astype(np.float32)


def slots(points: torch.Tensor, occ: dict) -> torch.Tensor:
    """(B, H, W, 3) points -> (B, H*W) cell of each point in its image's
    grid, -1 where it falls outside: scaled and shifted per coordinate,
    rotated, cut into cells (truncated toward zero), kept where
    0 < ijk < grid."""
    dt = tail_dtype()
    B = points.shape[0]
    pts = points.reshape(B, -1, 3).to(dt)
    dev = pts.device
    pts = pts * torch.tensor(occ["pc_scale"], dtype=dt, device=dev) + torch.tensor(
        occ["pc_shift"], dtype=dt, device=dev)
    pts = pts @ torch.as_tensor(rotation(occ["correction_angle"]), device=dev).to(dt)
    grid = torch.tensor(occ["grid_size"], device=dev)
    extent = torch.tensor([g / s for g, s in zip(occ["grid_size"], occ["scale"])], dtype=dt,
                          device=dev)
    finite = torch.isfinite(pts).all(-1)
    ijk = (torch.where(finite[..., None], pts, torch.zeros_like(pts)) / extent
           * grid.to(dt)).to(torch.int64)
    keep = finite & ((ijk > 0) & (ijk < grid)).all(-1)
    gx, gy, gz = occ["grid_size"]
    cell = (ijk[..., 0] * gy + ijk[..., 1]) * gz + ijk[..., 2]
    return torch.where(keep, cell, torch.full_like(cell, -1))


def voxelize(points: torch.Tensor, seg: torch.Tensor, occ: dict) -> torch.Tensor:
    """The (B, gx, gy, gz, C) grid: each cell the sum of the segmentation
    scores of the points that fall in it."""
    B, C = seg.shape[:2]
    cells = slots(points, occ)
    vals = seg.reshape(B, C, -1).transpose(1, 2).to(tail_dtype())
    ncell = int(np.prod(occ["grid_size"]))
    out = torch.zeros(B, ncell, C, dtype=tail_dtype(), device=seg.device)
    for b in range(B):
        keep = cells[b] >= 0
        out[b].index_add_(0, cells[b][keep], vals[b][keep])
    return out.reshape(B, *occ["grid_size"], C)
