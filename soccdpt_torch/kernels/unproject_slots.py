"""The 1080p geometry tail in one pass: inverse depth at camera resolution
to the served points and the voxelizer's slot keys.

Replaces no TPU kernel: the JAX package leaves the tail to XLA, which fuses
it (``soccdpt_tpu/ops/geometry.py``). The CUDA source is
``csrc/unproject_slots.cu`` (the kernel, its design and its arithmetic).

Contract, over a contiguous f32 ``inv (B, H, W)``: ``points (B, H, W, 3)``
f32, exactly ``ops/geometry.py::camera_frame_points`` (``1 / clamp(inv,
1e-8)``, then ``unproject_depth``), and, when ``slots`` is set, ``slot (B
H W,)`` int32, exactly ``slot_keys(occupancy_frame(points))``: the point
scaled, shifted and rotated into the grid's frame, its cell, ``b * cells``
added, or -1 outside the grid. Without ``slots`` the second output is
empty. On the card the points equal the plain path's bit for bit; a slot
may differ where the rotation lands on a cell's face, since cuBLAS's GEMM
may sum a row in another order than the kernel.

Bound on the H100: bytes, 20 a pixel (``tail_bytes``): 249 MB a batch-6
request at 1080x1920, 74 us at 3.35 TB/s.

The op is ``soccdpt::unproject_slots`` (``torch.library``, registered as
the upsample's): its CUDA implementation launches the kernel on the current
stream and allocates only its outputs, its CPU implementation is
``unproject_slots_plain``, and a fake implementation gives the outputs'
shapes, so CUDA graphs capture it and ``torch.export`` records it as one
node. ``ops/geometry.py::get_semantic_occupancy`` decides which calls take
it. ``unproject_slots.launches`` counts the kernel's launches (Python calls:
a graph counts at its capture); ``unproject_slots.fallbacks`` counts the
card's geometry tails that ``get_semantic_occupancy`` left to the plain
path (autograd, another dtype or layout).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import CameraConfig, OccupancyConfig
from . import _build

BYTES_PER_PIXEL = {True: 20, False: 16}  # inverse depth in, point out, [slot out]


def tail_bytes(B: int, H: int, W: int, slots: bool = True) -> int:
    """Bytes the bound counts: each inverse depth read once, each point and
    slot written once."""
    return B * H * W * BYTES_PER_PIXEL[slots]


def unproject_slots_plain(inv: torch.Tensor, intrinsics: Sequence[float],
                          pc_scale: Sequence[float], pc_shift: Sequence[float],
                          angle: Sequence[float], grid_size: Sequence[int],
                          voxel_scale: Sequence[float], slots: bool):
    """The plain version: ``ops/geometry.py``'s own functions."""
    from ..ops import geometry  # it imports this module

    fx, fy, cx, cy = intrinsics
    cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=inv.shape[2], height=inv.shape[1])
    occ = OccupancyConfig(grid_size=tuple(grid_size), scale=tuple(voxel_scale),
                          pc_scale=tuple(pc_scale), pc_shift=tuple(pc_shift),
                          correction_angle=tuple(angle))
    points = geometry.camera_frame_points(inv, cam)
    if not slots:
        return points, inv.new_empty((0,), dtype=torch.int32)
    frame = geometry.occupancy_frame(points.reshape(points.shape[0], -1, 3), occ)
    return points, geometry.slot_keys(frame, occ)


@functools.lru_cache(maxsize=64)
def _params(intrinsics: Tuple[float, ...], pc_scale, pc_shift, angle, grid_size, voxel_scale):
    """The C entry's host arrays: f32 as the plain path's constants are
    (aten divides by a Python scalar as a product by its f32 reciprocal)."""
    from ..ops.geometry import rotation_matrix

    fx, fy, cx, cy = (np.float32(v) for v in intrinsics)
    occ = OccupancyConfig(grid_size=grid_size, scale=voxel_scale)
    values = np.concatenate([
        [cx, cy, np.float32(1) / fx, np.float32(1) / fy],
        np.asarray(pc_scale, np.float32), np.asarray(pc_shift, np.float32),
        rotation_matrix(angle).reshape(-1), np.asarray(occ.occupancy_shape, np.float32),
    ]).astype(np.float32)
    return (ctypes.c_float * values.size)(*values.tolist()), (ctypes.c_int * 3)(*grid_size)


def launch(inv: torch.Tensor, intrinsics, pc_scale, pc_shift, angle, grid_size, voxel_scale,
           slots: bool):
    """One launch of the kernel on ``inv`` (B, H, W), contiguous f32 on the
    card; returns new ``(points, slot)``."""
    if inv.dtype != torch.float32 or inv.dim() != 3 or not inv.is_contiguous():
        raise ValueError(f"the geometry kernel takes contiguous (B, H, W) f32, got "
                         f"{inv.dtype} {tuple(inv.shape)} at strides {inv.stride()}")
    if inv.data_ptr() % 16:
        inv = inv.clone()
    B, H, W = inv.shape
    points = torch.empty((B, H, W, 3), dtype=torch.float32, device=inv.device)
    slot = torch.empty((B * H * W,) if slots else (0,), dtype=torch.int32, device=inv.device)
    params, grid = _params(tuple(intrinsics), tuple(pc_scale), tuple(pc_shift), tuple(angle),
                           tuple(grid_size), tuple(voxel_scale))
    lib = _build.load("unproject_slots")
    fn = lib.soccdpt_unproject_slots
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(inv.data_ptr(), points.data_ptr(), slot.data_ptr() if slots else None, B, H, W,
            params, grid, torch.cuda.current_stream(inv.device).cuda_stream)
    _build.check(lib, rc, "geometry kernel")
    unproject_slots.launches += 1
    return points, slot


# The custom op, registered through ``torch.library.Library`` as the
# upsample's is (kernels/upsample.py)
_LIB = torch.library.Library("soccdpt", "FRAGMENT")
_LIB.define("unproject_slots(Tensor inv, float[] intrinsics, float[] pc_scale, "
            "float[] pc_shift, float[] angle, int[] grid_size, float[] voxel_scale, "
            "bool slots) -> (Tensor, Tensor)")
_LIB.impl("unproject_slots", launch, "CUDA")
_LIB.impl("unproject_slots", unproject_slots_plain, "CPU")


@torch.library.register_fake("soccdpt::unproject_slots", lib=_LIB)
def _unproject_slots_fake(inv, intrinsics, pc_scale, pc_shift, angle, grid_size, voxel_scale,
                          slots):
    B, H, W = inv.shape
    return (inv.new_empty((B, H, W, 3)),
            inv.new_empty((B * H * W,) if slots else (0,), dtype=torch.int32))


_unproject_slots_op = torch.ops.soccdpt.unproject_slots.default


def unproject_slots(inv: torch.Tensor, camera: CameraConfig, occ: OccupancyConfig,
                    slots: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(points (B, H, W, 3), slot (B H W,) or None)`` of inverse depth
    ``inv`` (B, H, W) at ``camera``'s intrinsics, through the op: the
    kernel on the card, ``unproject_slots_plain`` on the CPU. No gradient:
    ``ops/geometry.py`` sends what autograd records elsewhere."""
    points, slot = _unproject_slots_op(
        inv, [camera.fx, camera.fy, camera.cx, camera.cy], list(occ.pc_scale),
        list(occ.pc_shift), list(occ.correction_angle), list(occ.grid_size), list(occ.scale),
        slots)
    return points, slot if slots else None


unproject_slots.launches = 0
unproject_slots.fallbacks = 0
