"""K2's gradient on the CPU: the port's ``segment_sum`` (an
``autograd.Function`` whose CPU backward is ``segment_sum_backward_plain``)
against the JAX package, and the plain route on strided values.

* the gradient of ``points_to_occupancy_grid`` with respect to the
  semantics against ``jax.grad`` of the JAX function, through
  ``method="pallas"`` (``sorted_segment_sum_tpu`` in interpret mode, with
  its custom VJP, as tests/test_sorted_segment_sum.py runs it) and through
  ``method="scatter"``, at B = 2 with NaN, inf and out-of-bounds points,
  the semantics contiguous or the served channel-major view;
* strided (B, N, C) and (N, C) views through the plain route against
  contiguous values, forward and backward;
* ``autograd.gradcheck`` of the Function in f64.

Tolerances: gradients 1e-5 (atol = rtol), the bound
tests/test_sorted_segment_sum.py holds the Pallas route's gradient to (a
gather: the same cotangent values on both sides); grids 1e-4, the bound
tests/test_geometry.py uses against its numpy oracle; views against
contiguous values: the same bits (the plain route copies a view into the
same rows before the same ``index_add_``).
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.ops import geometry as jgeo
from soccdpt_tpu.ops import sorted_segment_sum as sss

from soccdpt_torch.core.config import OccupancyConfig
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.kernels.segment_sum import (
    segment_sum,
    segment_sum_backward,
    segment_sum_backward_plain,
)
from soccdpt_torch.ops.geometry import points_to_occupancy_grid

OCC = OccupancyConfig(grid_size=(16, 16, 8))
JOCC = JaxOcc(grid_size=(16, 16, 8))
B, N, C = 2, 700, 3


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    shape_m = np.asarray(OCC.occupancy_shape, np.float32)
    points = (rng.random((B, N, 3)).astype(np.float32) * 1.4 - 0.2) * shape_m
    points[0, :5] = np.inf
    points[1, :7] = np.nan
    points[1, 10:13] = -np.inf
    sem = rng.random((B, N, C)).astype(np.float32)
    w = rng.random((B, *OCC.grid_size, C)).astype(np.float32)
    return points, sem, w


def _jax_grad(points, sem, w, method):
    def loss(s):
        return (jgeo.points_to_occupancy_grid(points, s, JOCC, C, method=method) * w).sum()

    if method != "pallas":
        return np.asarray(jax.grad(loss)(sem))
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(sss.pl, "pallas_call", interp):
        return np.asarray(jax.grad(loss)(sem))


@pytest.mark.parametrize("layout", ["contiguous", "channel_major"])
@pytest.mark.parametrize("method", ["pallas", "scatter"])
def test_voxelizer_gradient_matches_jax(method, layout):
    points, sem, w = _inputs()
    want = _jax_grad(points, sem, w, method)
    if layout == "channel_major":  # the served path's (B, N, C) view of (B, C, N)
        leaf = torch.from_numpy(np.ascontiguousarray(sem.transpose(0, 2, 1))).requires_grad_()
        x = leaf.transpose(1, 2)
    else:
        leaf = x = torch.from_numpy(sem).requires_grad_()
    grid = points_to_occupancy_grid(torch.from_numpy(points), x, OCC, C)
    (got,) = torch.autograd.grad((grid * torch.from_numpy(w)).sum(), leaf)
    got = got.transpose(1, 2) if layout == "channel_major" else got
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # dropped rows (non-finite or out of the grid) get no gradient
    shape_m = np.asarray(OCC.occupancy_shape, np.float32)
    outside = ((points < 0) | (points >= shape_m)).any(-1) & np.isfinite(points).all(-1)
    assert outside.sum() > 100
    for rows in (got[0, :5], got[1, :7], got[1, 10:13], got[torch.from_numpy(outside)]):
        assert float(rows.abs().sum()) == 0.0
    assert float(got.abs().sum()) > 0.0
    np.testing.assert_allclose(
        grid.detach().numpy(),
        np.asarray(jgeo.points_to_occupancy_grid(points, sem, JOCC, C, method="scatter")),
        rtol=1e-4, atol=1e-4,
    )


def _views(layout, rng):
    """(lin, view, contiguous copy of the view, S)."""
    S = 64
    if layout == "channel_major":
        base = torch.from_numpy(rng.random((2, 3, 300)).astype(np.float32))
        view = base.transpose(1, 2)
    elif layout == "every_other_row":
        base = torch.from_numpy(rng.random((600, 3)).astype(np.float32))
        view = base[::2]
    else:  # channels picked out of a wider row
        base = torch.from_numpy(rng.random((2, 300, 7)).astype(np.float32))
        view = base[..., 1:7:2]
    lin = torch.from_numpy(rng.integers(-5, S + 5, view.shape[:-1]).reshape(-1).astype(np.int32))
    return lin, view, view.contiguous(), S


@pytest.mark.parametrize("layout", ["channel_major", "every_other_row", "channel_slice"])
def test_strided_values_match_contiguous(layout):
    lin, view, cont, S = _views(layout, np.random.default_rng(7))
    assert not view.is_contiguous()
    assert torch.equal(segment_sum(lin, view, S), segment_sum(lin, cont, S))
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal((S, 3)).astype(np.float32))
    grads = []
    for v in (view, cont):
        leaf = v.clone().requires_grad_()
        segment_sum(lin, leaf, S).backward(cot)
        grads.append(leaf.grad)
    assert grads[0].shape == view.shape
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("shape", [(40, 3), (2, 20, 2)])
def test_gradcheck_f64(shape):
    rng = np.random.default_rng(9)
    lin = torch.from_numpy(rng.integers(-2, 10, int(np.prod(shape[:-1]))))
    lin[:4] = 3  # a run of equal slots
    vals = torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: segment_sum(lin, v, 8), (vals,))


def test_plain_backward_gathers_the_slot_and_zeroes_dropped_rows():
    rng = np.random.default_rng(4)
    S = 32
    lin = rng.integers(0, S, 500)
    lin[::9], lin[1::9], lin[2::9] = -1, S, S + 5
    cot = rng.standard_normal((S, 3)).astype(np.float32)
    want = np.where(((lin >= 0) & (lin < S))[:, None], cot[np.clip(lin, 0, S - 1)], 0.0)
    before = kernel_ops.launches()["segment_sum_backward"]
    for keys in (torch.from_numpy(lin), torch.from_numpy(lin.astype(np.int32))):
        got = segment_sum_backward(keys, torch.from_numpy(cot))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(segment_sum_backward_plain(keys, torch.from_numpy(cot)),
                                      want)
    assert kernel_ops.launches()["segment_sum_backward"] == before  # CPU tensors: the plain version
