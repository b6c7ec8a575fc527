"""K2, the voxelizer's segment-sum, and the geometry around it: the port's
plain version against the JAX package's Pallas kernel (interpret mode)
and an ``np.add.at`` oracle on the CPU. The CUDA kernel is held to the
oracle on the card in tests/test_torch_kernels_gpu.py.

Tolerances, with their reasons:
* segment sums: rtol/atol 1e-5, the bound tests/test_sorted_segment_sum.py
  uses; the adds are f32 in another order (atomics on the card);
* grids from points: rtol/atol 1e-4, the bound tests/test_geometry.py uses
  against its numpy oracle.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.ops import geometry as jgeo
from soccdpt_tpu.ops.sorted_segment_sum import segment_sum_sorted_pallas

from soccdpt_torch.core.config import CameraConfig, OccupancyConfig
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.kernels.segment_sum import segment_sum, segment_sum_plain
from soccdpt_torch.ops.geometry import (
    get_semantic_occupancy,
    points_to_occupancy_grid,
    rotate_points,
    rotation_matrix,
    unproject_depth,
)

CAM_KW = dict(fx=100.0, fy=120.0, cx=32.0, cy=20.0, width=64, height=40)
OCC = OccupancyConfig(grid_size=(16, 16, 8))
JOCC = JaxOcc(grid_size=(16, 16, 8))


def _oracle(lin, vals, S):
    out = np.zeros((S, vals.shape[1]), np.float32)
    keep = (lin >= 0) & (lin < S)
    np.add.at(out, lin[keep], vals[keep])
    return out


def _port_sum(lin, vals, S):
    return segment_sum(torch.from_numpy(lin), torch.from_numpy(vals), S).numpy()


# --- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "N,S,C,bk,bc",
    [
        (1000, 96, 3, 64, 16),  # OOB rows drop
        (333, 40, 2, 32, 8),
        (64, 256, 1, 64, 32),  # more slots than rows
        (512, 16, 3, 64, 16),  # heavy duplication into few cells
    ],
)
def test_plain_matches_pallas_kernel_and_oracle(N, S, C, bk, bc):
    rng = np.random.default_rng(N + S + C)
    lin = rng.integers(0, S + max(4, S // 4), size=(N,)).astype(np.int32)
    vals = rng.uniform(size=(N, C)).astype(np.float32)
    want = np.asarray(segment_sum_sorted_pallas(
        jnp.asarray(lin), jnp.asarray(vals), S, block_k=bk, block_c=bc, interpret=True
    ))
    got = _port_sum(lin, vals, S)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _oracle(lin, vals, S), rtol=1e-5, atol=1e-5)


def test_all_rows_one_cell():
    N, S, C = 256, 64, 3
    lin = np.full((N,), 7, np.int32)
    want = np.zeros((S, C), np.float32)
    want[7] = N
    np.testing.assert_allclose(_port_sum(lin, np.ones((N, C), np.float32), S), want)


def test_all_rows_dropped_and_empty_input():
    lin = np.full((128,), 256 + 5, np.int32)
    lin[::3] = -2
    got = _port_sum(lin, np.full((128, 2), np.nan, np.float32), 256)
    np.testing.assert_array_equal(got, np.zeros((256, 2), np.float32))
    got = _port_sum(np.zeros((0,), np.int32), np.zeros((0, 3), np.float32), 10)
    np.testing.assert_array_equal(got, np.zeros((10, 3), np.float32))


def test_batch_folded_keys_with_oob_and_negative():
    """Keys folded as b*cells + cell, with out-of-range and negative keys
    in every slice (the JAX segmented-sort edge case)."""
    rng = np.random.default_rng(17)
    B, n, cells = 4, 256, 48
    lin = (rng.integers(0, cells, (B, n)) + np.arange(B)[:, None] * cells).reshape(-1)
    lin = lin.astype(np.int32)
    lin[5:40] = B * cells + rng.integers(0, 100, size=35)
    lin[300:310] = B * cells
    lin[700] = -3
    vals = rng.uniform(size=(B * n, 3)).astype(np.float32)
    want = np.asarray(segment_sum_sorted_pallas(
        jnp.asarray(lin), jnp.asarray(vals), B * cells, sort_segments=B,
        block_k=64, block_c=16, interpret=True,
    ))
    got = _port_sum(lin, vals, B * cells)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _oracle(lin, vals, B * cells), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    lin = np.arange(10, dtype=np.int32)
    vals = np.ones((10, 2), np.float32)
    before = kernel_ops.launches()["segment_sum"]
    got = _port_sum(lin, vals, 8)
    assert kernel_ops.launches()["segment_sum"] == before
    np.testing.assert_array_equal(
        got, segment_sum_plain(torch.from_numpy(lin), torch.from_numpy(vals), 8).numpy()
    )


# --- geometry ---------------------------------------------------------------


def _points(seed, B, N):
    rng = np.random.default_rng(seed)
    shape_m = np.asarray(OCC.occupancy_shape, np.float32)
    points = (rng.random((B, N, 3)).astype(np.float32) * 1.4 - 0.2) * shape_m
    return rng, points


@pytest.mark.parametrize("mode", ["prob", "count"])
def test_voxelize_matches_jax(mode):
    rng, points = _points(0, 2, 700)
    points[0, :5] = np.inf
    points[1, :7] = np.nan
    sem = rng.random((2, 700, 3)).astype(np.float32)
    want = np.asarray(jgeo.points_to_occupancy_grid(points, sem, JOCC, 3, mode=mode))
    got = points_to_occupancy_grid(
        torch.from_numpy(points), torch.from_numpy(sem), OCC, 3, mode=mode
    ).numpy()
    assert got.shape == (2, 16, 16, 8, 3) and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_voxelize_duplicates_and_batch_rows():
    shape_m = np.asarray(OCC.occupancy_shape, np.float32)
    cell = lambda ijk: (np.asarray([ijk], np.float32) / np.asarray(OCC.grid_size)) * shape_m + 0.01
    points = np.stack([np.tile(cell([3, 3, 3]), (10, 1)), np.tile(cell([5, 5, 5]), (10, 1))])
    grid = points_to_occupancy_grid(
        torch.from_numpy(points.astype(np.float32)), torch.ones(2, 10, 1), OCC, 1, mode="count"
    ).numpy()
    assert grid.sum() == 20.0
    assert grid[0, 3, 3, 3, 0] == 10.0 and grid[0, 5, 5, 5, 0] == 0.0
    assert grid[1, 5, 5, 5, 0] == 10.0 and grid[1, 3, 3, 3, 0] == 0.0


def test_voxelize_all_nonfinite_gives_empty_grid():
    points = torch.full((1, 10, 3), float("nan"))
    grid = points_to_occupancy_grid(points, torch.ones(1, 10, 2), OCC, 2)
    assert grid.sum().item() == 0.0


def test_rotation_and_unprojection_match_jax():
    np.testing.assert_allclose(
        rotation_matrix((7.0, 3.0, -12.0)), jgeo.rotation_matrix((7.0, 3.0, -12.0))
    )
    pts = np.random.default_rng(0).standard_normal((2, 10, 3)).astype(np.float32)
    for tr in (False, True):
        np.testing.assert_allclose(
            rotate_points(torch.from_numpy(pts), (7.0, 3.0, -12.0), tr).numpy(),
            np.asarray(jgeo.rotate_points(pts, (7.0, 3.0, -12.0), tr)),
            atol=1e-6,
        )
    depth = np.random.default_rng(1).uniform(1, 5, (1, 40, 64)).astype(np.float32)
    np.testing.assert_allclose(
        unproject_depth(torch.from_numpy(depth), CameraConfig(**CAM_KW)).numpy(),
        np.asarray(jgeo.unproject_depth(depth, JaxCamera(**CAM_KW))),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("output_size", [None, (20, 32)])
def test_get_semantic_occupancy_matches_jax(output_size):
    kw = dict(pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0), correction_angle=(7.0, 0.0, 0.0))
    rng = np.random.default_rng(5)
    inv_depth = rng.uniform(0.2, 0.5, (2, 16, 16)).astype(np.float32)
    inv_depth[0, 0, :4] = 0.0  # clamps at 1e-8, stays finite
    seg = rng.random((2, 3, 16, 16)).astype(np.float32)
    want = jgeo.get_semantic_occupancy(
        inv_depth, seg, JaxCamera(**CAM_KW), JaxOcc(grid_size=(16, 16, 8), **kw), 3,
        compute_occ=True, output_size=output_size,
    )
    got = get_semantic_occupancy(
        torch.from_numpy(inv_depth), torch.from_numpy(seg), CameraConfig(**CAM_KW),
        OccupancyConfig(grid_size=(16, 16, 8), **kw), 3,
        compute_occ=True, output_size=output_size,
    )
    H, W = output_size or (40, 64)
    assert tuple(got[2].shape) == (2, H, W, 3)
    assert torch.isfinite(got[2]).all() and got[3].sum() > 0
    for g, w, name in zip(got, want, ("inv_depth", "seg", "points", "grid")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)

