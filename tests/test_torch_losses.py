"""The port's losses and metrics against the JAX package's, on the CPU.

Every function of ``soccdpt_torch/train/losses.py`` and ``metrics.py`` on
inputs from a numpy seed: values, and for the losses ``jax.grad`` against
autograd. Both stacks run in f32.

Tolerances: ``VALUE_RTOL`` = 1e-5 on loss values (sums of up to a few
thousand f32 terms in another order); ``GRAD_TOL`` = 1e-5 of the largest
gradient entry (atol) and 1e-4 relative. ``FROM_NET_RTOL`` = 1e-4 where
the bicubic resize sits inside the loss: the JAX side multiplies by resize
matrices where the port interpolates. The metrics run in numpy float64 on
both sides and agree to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.ops.resize import resize_nchw as jax_resize_nchw
from soccdpt_tpu.ops.resize import subsampled_resize_nchw as jax_subsampled_resize
from soccdpt_tpu.train import losses as jl
from soccdpt_tpu.train import metrics as jm

from soccdpt_torch.ops.resize import resize_nchw, subsampled_resize_nchw
from soccdpt_torch.train import losses as tl
from soccdpt_torch.train import metrics as tm

torch.set_num_threads(2)  # the suite runs several worker processes side by side
VALUE_RTOL = 1e-5
GRAD_TOL = 1e-5
FROM_NET_RTOL = 1e-4

SHAPES = [(2, 16, 24), (3, 13, 17)]  # even, and odd sizes through the ::2 pyramid


def _fixture(shape, seed=0, mask="random"):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    target = (50 * rng.uniform(0.1, 2.0, shape) + 3).astype(np.float32)
    if mask == "random":
        m = (rng.random(shape) > 0.3).astype(np.float32)
    elif mask == "zero":
        m = np.zeros(shape, np.float32)
    else:
        m = np.ones(shape, np.float32)
    return pred, target, m


def _compare(jax_fn, torch_fn, pred, *rest, rtol=VALUE_RTOL):
    """Value and d/d(pred) of a scalar loss in both stacks."""
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(pred), *map(jnp.asarray, rest))
    tp = torch.from_numpy(pred).requires_grad_()
    got = torch_fn(tp, *map(torch.from_numpy, rest))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol, atol=1e-7)
    want_grad = np.asarray(want_grad)
    atol = GRAD_TOL * max(float(np.abs(want_grad).max()), 1e-30)
    np.testing.assert_allclose(tp.grad.numpy(), want_grad, rtol=10 * rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_scale_and_shift_matches_jax(shape):
    pred, target, mask = _fixture(shape)
    want = jl.compute_scale_and_shift(*map(jnp.asarray, (pred, target, mask)))
    got = tl.compute_scale_and_shift(*map(torch.from_numpy, (pred, target, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    # a boolean mask is taken as it is
    got_bool = tl.compute_scale_and_shift(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask > 0)
    )
    np.testing.assert_array_equal(got_bool[0].numpy(), got[0].numpy())


def test_scale_and_shift_are_zero_where_the_system_is_singular():
    """``det == 0``: an all-zero mask for one image, a constant prediction
    under a one-pixel mask for another; the third is regular."""
    pred, target, mask = _fixture((3, 8, 8), seed=1)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, 2, 3] = 1.0
    want = jl.compute_scale_and_shift(*map(jnp.asarray, (pred, target, mask)))
    got = tl.compute_scale_and_shift(*map(torch.from_numpy, (pred, target, mask)))
    assert got[0][:2].tolist() == [0.0, 0.0] and got[1][:2].tolist() == [0.0, 0.0]
    assert np.asarray(want[0])[:2].tolist() == [0.0, 0.0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4)
    # the gradient through the guarded division is finite
    tp = torch.from_numpy(pred).requires_grad_()
    s, t = tl.compute_scale_and_shift(tp, torch.from_numpy(target), torch.from_numpy(mask))
    (s.sum() + t.sum()).backward()
    assert torch.isfinite(tp.grad).all() and float(tp.grad[:2].abs().max()) == 0.0


@pytest.mark.parametrize("mask", ["random", "zero"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["mse_loss", "gradient_loss"])
def test_elementary_losses_match_jax(name, shape, mask):
    pred, target, m = _fixture(shape, mask=mask)
    _compare(getattr(jl, name), getattr(tl, name), 40 * pred, target, m)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mask", ["random", "zero", "ones"])
@pytest.mark.parametrize("shape", SHAPES)
def test_scale_and_shift_invariant_loss_matches_jax(shape, mask, align):
    pred, target, m = _fixture(shape, seed=2, mask=mask)

    def jfn(p, t, mm):
        return jl.scale_and_shift_invariant_loss(p, t, mm, do_compute_scale_and_shift=align)

    def tfn(p, t, mm):
        return tl.scale_and_shift_invariant_loss(p, t, mm, do_compute_scale_and_shift=align)

    _compare(jfn, tfn, pred, target, m, rtol=1e-4)


@pytest.mark.parametrize("net_hw,gt_hw", [((8, 8), (27, 48)), ((16, 12), (30, 41))])
def test_ssi_loss_from_net_matches_jax(net_hw, gt_hw):
    pred, _, _ = _fixture((2, *net_hw), seed=3)
    _, target, mask = _fixture((2, *gt_hw), seed=4)
    _compare(jl.ssi_loss_from_net, tl.ssi_loss_from_net, pred, target, mask, rtol=FROM_NET_RTOL)


def test_ssi_loss_from_net_is_resize_then_the_loss():
    pred, _, _ = _fixture((2, 8, 8), seed=5)
    _, target, mask = _fixture((2, 27, 48), seed=6)
    tp, tt, tmk = map(torch.from_numpy, (pred, target, mask))
    want = tl.scale_and_shift_invariant_loss(
        resize_nchw(tp, (27, 48), "bicubic", False), tt, tmk
    )
    np.testing.assert_allclose(
        float(tl.ssi_loss_from_net(tp, tt, tmk)), float(want), rtol=VALUE_RTOL
    )


@pytest.mark.parametrize("step", [1, 2, 4])
@pytest.mark.parametrize("method", ["bicubic", "nearest"])
def test_subsampled_resize_matches_jax(step, method):
    x = np.random.default_rng(7).standard_normal((2, 8, 12)).astype(np.float32)
    want = np.asarray(jax_subsampled_resize(jnp.asarray(x), (27, 41), step, method, False))
    got = subsampled_resize_nchw(torch.from_numpy(x), (27, 41), step, method, False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    full = np.asarray(jax_resize_nchw(jnp.asarray(x), (27, 41), method, False))
    np.testing.assert_allclose(got.numpy(), full[..., ::step, ::step], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos_weight", [1.0, 7.5])
@pytest.mark.parametrize("mask", ["random", "zero"])
def test_masked_bce_loss_matches_jax(mask, pos_weight):
    rng = np.random.default_rng(8)
    shape = (2, 3, 9, 11)
    pred = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    pred[0, 0, 0, :4] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # clamped like torch's BCELoss
    target = (rng.random(shape) > 0.7).astype(np.float32)
    m = np.zeros(shape, np.float32) if mask == "zero" else (rng.random(shape) > 0.4).astype(np.float32)

    def jfn(p, t, mm):
        return jl.masked_bce_loss(p, t, mm, pos_weight=pos_weight)

    def tfn(p, t, mm):
        return tl.masked_bce_loss(p, t, mm, pos_weight=pos_weight)

    _compare(jfn, tfn, pred, target, m)


def test_joint_loss_matches_jax():
    pred, target, mask = _fixture((2, 16, 24), seed=9)
    rng = np.random.default_rng(10)
    seg = rng.uniform(0.05, 0.95, (2, 3, 16, 24)).astype(np.float32)
    seg_t = (rng.random(seg.shape) > 0.5).astype(np.float32)
    seg_m = np.ones(seg.shape, np.float32)
    weights = (0.3, 0.7)
    want, want_aux = jl.joint_loss(
        *map(jnp.asarray, (pred, target, mask, seg, seg_t, seg_m)), loss_weights=weights
    )
    got, aux = tl.joint_loss(
        *map(torch.from_numpy, (pred, target, mask, seg, seg_t, seg_m)), loss_weights=weights
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert set(aux) == set(want_aux) == {"loss_disp", "loss_seg"}
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=1e-4)


# --- metrics ---------------------------------------------------------------------


def _depth_fixture(seed=11):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 80.0, (2, 12, 14)).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape) + 0.5).astype(np.float32)
    mask = rng.random(gt.shape) > 0.25
    return gt, pred, mask


@pytest.mark.parametrize("empty", [False, True])
def test_compute_masked_errors_matches_jax(empty):
    gt, pred, mask = _depth_fixture()
    if empty:
        mask = np.zeros_like(mask)
    want = jm.compute_masked_errors(gt, pred, mask).as_dict()
    got = tm.compute_masked_errors(torch.from_numpy(gt), torch.from_numpy(pred), mask).as_dict()
    assert list(got) == list(want) == ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-12, err_msg=key)


def test_masked_errors_clamp_what_is_not_finite():
    gt, pred, mask = _depth_fixture()
    pred[0, 0, 0], mask[0, 0, 0] = 0.0, True  # log(0), g / 0
    want = jm.compute_masked_errors(gt, pred, mask).as_dict()
    got = tm.compute_masked_errors(gt, pred, mask).as_dict()
    assert got["rmse_log"] == want["rmse_log"] == 0.0
    assert got == pytest.approx(want, rel=1e-9)


def test_ssi_aligned_depth_metrics_matches_jax():
    gt, pred, mask = _depth_fixture(seed=12)
    want = jm.ssi_aligned_depth_metrics(gt, 0.02 * pred - 1.0, mask).as_dict()
    got = tm.ssi_aligned_depth_metrics(gt, 0.02 * pred - 1.0, mask).as_dict()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-5, err_msg=key)
    assert got["abs_rel"] < 0.5  # the alignment took the affine map out


def test_seg_and_occupancy_iou_match_jax():
    rng = np.random.default_rng(13)
    gt = (rng.random((2, 3, 10, 12)) > 0.6).astype(np.float32)
    pred = np.clip(gt * 0.7 + 0.5 * rng.random(gt.shape), 0, 1).astype(np.float32)
    assert tm.seg_iou(torch.from_numpy(gt), torch.from_numpy(pred)) == pytest.approx(
        jm.seg_iou(gt, pred), rel=1e-12
    )
    assert tm.seg_iou(gt, pred, threshold=0.8) == pytest.approx(
        jm.seg_iou(gt, pred, threshold=0.8), rel=1e-12
    )
    grid_gt = rng.random((1, 6, 6, 4, 3)) > 0.7
    grid_pred = rng.random((1, 6, 6, 4, 3)).astype(np.float32)
    assert tm.occupancy_iou(grid_gt, torch.from_numpy(grid_pred)) == pytest.approx(
        jm.occupancy_iou(grid_gt, grid_pred), rel=1e-12
    )
    assert tm.occupancy_iou(np.zeros_like(grid_gt), np.zeros_like(grid_pred)) == 0.0
