"""Depth -> point cloud -> semantic occupancy grid (the port of
``soccdpt_tpu/ops/geometry.py``).

Same function as the JAX package, including its two fixes to the
reference: every batch row voxelizes into its own grid with true
accumulation, and ``pc_scale``/``pc_shift`` apply per coordinate. The
accumulation goes through kernel K2 (``kernels/segment_sum.py``); on the
card the tail before it, inverse depth to points and slot keys, is one
kernel (``kernels/unproject_slots.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import CameraConfig, OccupancyConfig
from ..kernels.ops import count_fallback
from ..kernels.segment_sum import segment_sum
from ..kernels.unproject_slots import unproject_slots
from .resize import resize_nchw


def rotation_matrix(
    angles_deg: Tuple[float, float, float], transpose: bool = False
) -> np.ndarray:
    """Combined rotation R = Ra @ Rb @ Rc about x, y, z (degrees);
    ``transpose`` selects the GT pipeline's convention."""
    a, b, c = (math.radians(v) for v in angles_deg)
    ra = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    rb = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rc = np.array([[math.cos(c), -math.sin(c), 0], [math.sin(c), math.cos(c), 0], [0, 0, 1]])
    m = ra @ rb @ rc
    if transpose:
        m = ra.T @ rb.T @ rc.T
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cached_const(values: Tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _const(values: Tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A small constant tensor, made once per device: a fresh host-to-device
    copy on every request would stall the host behind the card. While
    ``torch.export`` traces it is made afresh, a constant of the program,
    and never cached: the cache would keep a fake tensor."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_const(values, device, dtype)


def rotate_points(
    points: torch.Tensor, angles_deg: Tuple[float, float, float], transpose: bool = False
) -> torch.Tensor:
    """Rotate (..., 3) points by euler angles (degrees): ``points @ R``."""
    m = rotation_matrix(angles_deg, transpose)
    return points @ _const(tuple(map(tuple, m.tolist())), points.device, points.dtype)


def unproject_depth(depth: torch.Tensor, camera: CameraConfig) -> torch.Tensor:
    """(B, H, W) depth -> (B, H, W, 3) camera-frame points,
    X = (V - cx) Z / fx, Y = (U - cy) Z / fy."""
    _, H, W = depth.shape
    u = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    v = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    x = (v - camera.cx) * depth / camera.fx
    y = (u - camera.cy) * depth / camera.fy
    return torch.stack([x, y, depth], dim=-1)


def occupancy_frame(points: torch.Tensor, occ: OccupancyConfig) -> torch.Tensor:
    """(B, N, 3) camera-frame points -> the grid's frame: scaled and shifted
    per coordinate (``pc_scale``, ``pc_shift``), then rotated by
    ``correction_angle``."""
    scale = _const(tuple(occ.pc_scale), points.device, points.dtype)
    shift = _const(tuple(occ.pc_shift), points.device, points.dtype)
    return rotate_points(points * scale + shift, occ.correction_angle)


def slot_keys(points: torch.Tensor, occ: OccupancyConfig) -> torch.Tensor:
    """(B, N, 3) points in the grid's frame -> ``slot`` (B*N,) int32: the
    cell of each point in its image's grid plus ``b * cells``, or -1 for a
    point outside the grid or with a non-finite coordinate."""
    B = points.shape[0]
    gx, gy, gz = occ.grid_size
    shape_m = _const(tuple(occ.occupancy_shape), points.device, points.dtype)
    grid = _const(tuple(float(g) for g in occ.grid_size), points.device, points.dtype)

    # non-finite points are zeroed before the cast; the cast truncates
    # toward zero; the bounds test is strict, 0 < ijk < grid
    finite = torch.isfinite(points).all(dim=-1)
    safe = torch.where(finite[..., None], points, torch.zeros_like(points))
    ijk = (safe / shape_m * grid).to(torch.int32)
    inb = ((ijk > 0) & (ijk < _const(tuple(occ.grid_size), points.device, torch.int32))).all(-1)
    valid = finite & inb

    num_cells = gx * gy * gz
    if B * (num_cells + 1) >= 2**31:
        raise ValueError(f"batch {B} x grid {num_cells} overflows the int32 slot")
    lin = (ijk[..., 0] * gy + ijk[..., 1]) * gz + ijk[..., 2]
    batch_off = torch.arange(B, dtype=torch.int32, device=points.device)[:, None] * num_cells
    return torch.where(valid, lin + batch_off, torch.full_like(lin, -1)).reshape(-1)


def slot_values(
    semantics: torch.Tensor, rows: Tuple[int, int], num_classes: int, mode: str = "prob",
    threshold: float = 0.5,
) -> torch.Tensor:
    """The (B, N, C) f32 values K2 sums for ``rows`` = (B, N): ``semantics``
    itself where it is f32 (a view K2 reads in place at its strides), else a
    cast of it (``mode="prob"``), or its scores above ``threshold``
    (``mode="count"``)."""
    if tuple(semantics.shape) != (*rows, num_classes):
        raise ValueError(f"semantics {tuple(semantics.shape)} do not fit points "
                         f"{(*rows, 3)} and {num_classes} classes")
    if mode == "prob":
        return semantics.float()
    if mode == "count":
        return (semantics > threshold).to(torch.float32)
    raise ValueError(mode)


def occupancy_slots(
    points: torch.Tensor,
    semantics: torch.Tensor,
    occ: OccupancyConfig,
    num_classes: int,
    mode: str = "prob",
    threshold: float = 0.5,
):
    """The segment-sum problem of a voxelization: ``(slot, vals, num_slots)``
    with ``slot`` (B*N,) int32 in [0, B*cells) or -1 for a dropped row
    (``slot_keys``) and ``vals`` (B, N, C) f32 (``slot_values``). Slots fold
    the batch in: ``b * cells + cell``."""
    B, N, _ = points.shape
    slot = slot_keys(points, occ)
    vals = slot_values(semantics, (B, N), num_classes, mode, threshold)
    return slot, vals, B * math.prod(occ.grid_size)


def points_to_occupancy_grid(
    points: torch.Tensor,
    semantics: torch.Tensor,
    occ: OccupancyConfig,
    num_classes: int,
    mode: str = "prob",
    threshold: float = 0.5,
) -> torch.Tensor:
    """Voxelize semantic points into a per-batch occupancy grid.

    points: (B, N, 3) in meters; semantics: (B, N, C) class scores.
    Returns (B, gx, gy, gz, C) f32 accumulated weights (``mode="prob"``)
    or counts of scores above ``threshold`` (``mode="count"``).
    """
    flat = segment_sum(*occupancy_slots(points, semantics, occ, num_classes, mode, threshold))
    return flat.reshape(points.shape[0], *occ.grid_size, num_classes)


def camera_frame_points(inv_depth: torch.Tensor, camera: CameraConfig) -> torch.Tensor:
    """(B, H, W) inverse depth -> (B, H, W, 3) points: depth 1 / inverse
    depth clamped at 1e-8 (a NaN stays NaN), unprojected."""
    return unproject_depth(1.0 / torch.clamp(inv_depth, min=1e-8), camera)


def takes_kernel(inv_depth_up: torch.Tensor, slots: bool, num_cells: int) -> bool:
    """Whether ``get_semantic_occupancy`` runs its tail through the geometry
    kernel (``kernels/unproject_slots.py``): contiguous f32 on the card, no
    gradient recorded, the int32 slot (``slot_keys``) and the kernel's 32-bit
    index inside an image within range."""
    if not (inv_depth_up.is_cuda and inv_depth_up.dtype == torch.float32
            and inv_depth_up.dim() == 3 and inv_depth_up.is_contiguous()
            and not (torch.is_grad_enabled() and inv_depth_up.requires_grad)):
        return False
    B, H, W = inv_depth_up.shape
    return 3 * H * W < 2**31 and (not slots or B * (num_cells + 1) < 2**31)


def get_semantic_occupancy(
    inv_depth: torch.Tensor,
    segmentation: torch.Tensor,
    camera: CameraConfig,
    occ: OccupancyConfig,
    num_classes: int,
    compute_occ: bool = False,
    occ_mode: str = "prob",
    output_size: Optional[Tuple[int, int]] = None,
):
    """inv_depth (B, h, w) and segmentation (B, C, h, w) -> (inv_depth_up
    (B, H, W), seg_up (B, C, H, W), points (B, H, W, 3), grid or None) at
    camera resolution (or ``output_size``). On the card, without autograd,
    the points and the grid's slot keys come from one kernel
    (``takes_kernel``); elsewhere from the plain functions of this module."""
    H, W = output_size if output_size is not None else (camera.height, camera.width)
    inv_depth_up = resize_nchw(inv_depth, (H, W), "bicubic", align_corners=False)
    seg_up = resize_nchw(segmentation, (H, W), "nearest")

    # scale the intrinsics so they stay valid at a reduced output size
    cam = camera
    if (H, W) != (camera.height, camera.width):
        sy, sx = H / camera.height, W / camera.width
        cam = CameraConfig(
            fx=camera.fx * sx, fy=camera.fy * sy, cx=camera.cx * sx, cy=camera.cy * sy,
            width=W, height=H,
        )
    B = inv_depth_up.shape[0]
    num_cells = math.prod(occ.grid_size)
    if takes_kernel(inv_depth_up, compute_occ, num_cells):
        points, slot = unproject_slots(inv_depth_up, cam, occ, compute_occ)
    else:
        if inv_depth_up.is_cuda:
            count_fallback("unproject_slots")
        points = camera_frame_points(inv_depth_up, cam)
        slot = (slot_keys(occupancy_frame(points.reshape(B, -1, 3), occ), occ)
                if compute_occ else None)

    occupancy_grid = None
    if compute_occ:
        sem = seg_up.reshape(B, num_classes, -1).transpose(1, 2)
        vals = slot_values(sem, (B, H * W), num_classes, occ_mode)
        occupancy_grid = segment_sum(slot, vals, B * num_cells).reshape(
            B, *occ.grid_size, num_classes)
    return inv_depth_up, seg_up, points, occupancy_grid


def occupancy_grid_to_points(
    occupancy_grid, occ: OccupancyConfig, threshold: float = 0.5
) -> np.ndarray:
    """Host-side: (gx, gy, gz, C) grid -> (N, 4) [x, y, z, class_id] points
    in meters, class by class."""
    if isinstance(occupancy_grid, torch.Tensor):
        occupancy_grid = occupancy_grid.detach().cpu().numpy()
    occupancy_grid = np.asarray(occupancy_grid)
    num_classes = occupancy_grid.shape[3]
    shape_m = np.asarray(occ.occupancy_shape, np.float32)
    grid = np.asarray(occ.grid_size, np.float32)
    idx = np.argwhere(occupancy_grid >= threshold)
    out = []
    for c in range(num_classes):
        ci = idx[idx[:, 3] == c][:, :3]
        pts = (ci / grid * shape_m).astype(np.float32)
        out.append(np.concatenate([pts, np.full((len(pts), 1), c, np.float32)], axis=1))
    return np.concatenate(out, axis=0) if out else np.zeros((0, 4), np.float32)
