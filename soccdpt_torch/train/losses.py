"""Training losses (the port of ``soccdpt_tpu/train/losses.py``).

The scale-and-shift-invariant depth loss of MiDaS: a closed-form
per-image least-squares alignment of the prediction to the target, a
masked MSE data term and a multi-scale gradient-matching regulariser
(alpha = 0.5, 4 scales). The segmentation loss is a masked binary
cross-entropy on probabilities. Reductions guard their divisors with
``torch.where`` instead of branching on data, so every function is
differentiable everywhere and never syncs the host. All of it runs in
f32 whatever the network's dtype: the trainer casts before it calls.

The reductions divide a sum over the batch by a sum of the mask. Under
data parallelism a rank holds some rows of the batch: ``global_sum``
(given by the trainer) sums a divisor over the ranks that hold the other
rows, so a rank's loss is its rows' share of the global batch's, and the
shares add up to it. Averaging the ranks' own losses would be another
function wherever their mask counts differ. A divisor depends on the
masks alone, so the sum carries no gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.resize import resize_nchw


def compute_scale_and_shift(
    prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form least-squares (scale, shift) per image, masked.

    prediction, target: (B, H, W); mask: (B, H, W) float or bool. Where the
    2x2 system is singular (``det == 0``) both are 0.
    """
    mask = mask.to(prediction.dtype)
    a_00 = torch.sum(mask * prediction * prediction, dim=(1, 2))
    a_01 = torch.sum(mask * prediction, dim=(1, 2))
    a_11 = torch.sum(mask, dim=(1, 2))
    b_0 = torch.sum(mask * prediction * target, dim=(1, 2))
    b_1 = torch.sum(mask * target, dim=(1, 2))

    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, zero)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, zero)
    return x_0, x_1


GlobalSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _global(divisor: torch.Tensor, global_sum: GlobalSum) -> torch.Tensor:
    return divisor if global_sum is None else global_sum(divisor.detach())


def _reduction_batch_based(
    image_loss: torch.Tensor, M: torch.Tensor, global_sum: GlobalSum = None
) -> torch.Tensor:
    divisor = _global(torch.sum(M), global_sum)
    total = torch.sum(image_loss) / torch.clamp(divisor, min=1.0)
    return torch.where(divisor == 0, torch.zeros_like(total), total)


def mse_loss(prediction, target, mask, global_sum: GlobalSum = None):
    mask = mask.to(prediction.dtype)
    M = torch.sum(mask, dim=(1, 2))
    res = prediction - target
    image_loss = torch.sum(mask * res * res, dim=(1, 2))
    return _reduction_batch_based(image_loss, 2 * M, global_sum)


def gradient_loss(prediction, target, mask, global_sum: GlobalSum = None):
    mask = mask.to(prediction.dtype)
    M = torch.sum(mask, dim=(1, 2))
    diff = mask * (prediction - target)

    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1])
    grad_x = mask[:, :, 1:] * mask[:, :, :-1] * grad_x

    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :])
    grad_y = mask[:, 1:, :] * mask[:, :-1, :] * grad_y

    image_loss = torch.sum(grad_x, dim=(1, 2)) + torch.sum(grad_y, dim=(1, 2))
    return _reduction_batch_based(image_loss, M, global_sum)


def scale_and_shift_invariant_loss(
    prediction: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 0.5,
    scales: int = 4,
    do_compute_scale_and_shift: bool = True,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """MSE of the aligned prediction plus ``alpha`` times the gradient loss
    at ``scales`` strides 1, 2, 4, ...; all of (B, H, W)."""
    if do_compute_scale_and_shift:
        scale, shift = compute_scale_and_shift(prediction, target, mask)
    else:
        scale, shift = target.new_ones(target.shape[0]), target.new_zeros(target.shape[0])
    pred_ssi = scale[:, None, None] * prediction + shift[:, None, None]

    total = mse_loss(pred_ssi, target, mask, global_sum)
    if alpha > 0:
        for s in range(scales):
            step = 2**s
            total = total + alpha * gradient_loss(
                pred_ssi[:, ::step, ::step],
                target[:, ::step, ::step],
                mask[:, ::step, ::step],
                global_sum,
            )
    return total


def ssi_loss_from_net(
    prediction_net: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 0.5,
    scales: int = 4,
    do_compute_scale_and_shift: bool = True,
    method: str = "bicubic",
    align_corners: bool = False,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """The SSI loss of a net-resolution prediction against a GT-resolution
    target: the prediction resized to the target's size, then
    :func:`scale_and_shift_invariant_loss`. (The JAX package builds each
    pyramid level from the net output with ``subsampled_resize_nchw``, a
    rewrite for the TPU, where a strided slice of a 1080p tensor is slow;
    a level is the same numbers as the slice of the one full resize taken
    here, and its backward one bicubic backward instead of four.)"""
    pred_full = resize_nchw(prediction_net, tuple(target.shape[-2:]), method, align_corners)
    return scale_and_shift_invariant_loss(
        pred_full, target, mask, alpha, scales, do_compute_scale_and_shift, global_sum
    )


def masked_bce_loss(
    prediction: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-7,
    pos_weight: float = 1.0,
    global_sum: GlobalSum = None,
) -> torch.Tensor:
    """Mean binary cross-entropy over the masked elements, on probabilities
    (the seg head already applies its sigmoid), clamped to
    ``[eps, 1 - eps]``. ``pos_weight`` multiplies the positive-class term;
    occupancy training uses it, where occupied cells are rare."""
    mask = mask.to(prediction.dtype)
    p = torch.clamp(prediction, eps, 1.0 - eps)
    bce = -(pos_weight * target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return torch.sum(bce * mask) / torch.clamp(_global(torch.sum(mask), global_sum), min=1.0)


def joint_loss(
    disp_pred,
    disp_target,
    disp_mask,
    seg_pred,
    seg_target,
    seg_mask,
    loss_weights: Tuple[float, float] = (0.5, 0.5),
    compute_scale_and_shift: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted depth + seg objective at one resolution."""
    w_depth, w_seg = loss_weights
    l_disp = scale_and_shift_invariant_loss(
        disp_pred, disp_target, disp_mask,
        do_compute_scale_and_shift=compute_scale_and_shift,
    )
    l_seg = masked_bce_loss(seg_pred, seg_target, seg_mask)
    return w_depth * l_disp + w_seg * l_seg, {"loss_disp": l_disp, "loss_seg": l_seg}
