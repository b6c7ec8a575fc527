"""Layer calls in the compute dtype of their input.

Parameters stay f32 (as the JAX package's ``param_dtype``); a layer runs
in the dtype of the activation it is given, casting its weights to it,
as flax's ``dtype=`` does. Without gradients the cast is made once and
kept (:func:`cast_param`), so bf16 serving does not re-cast every weight
on every request. LayerNorm and BatchNorm compute in f32 and
cast back, as the JAX modules' ``dtype=jnp.float32`` norms do. In a
module that is in training mode BatchNorm normalises by the batch's
statistics and moves the running ones, and :func:`dropout` and
:func:`drop_path_mask` draw from an explicit ``torch.Generator``.
Activations are NHWC at module boundaries, as in the JAX package;
convolutions view them as NCHW (a channels-last view, no copy).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.comm import all_reduce_sum


def cast_param(mod: nn.Module, name: str, dtype: torch.dtype):
    """``getattr(mod, name)`` in ``dtype``. Without gradients the cast is
    cached on the module, keyed by the parameter's storage and version
    counter, so a weight load or a move invalidates it. While
    ``torch.export`` traces, the cast is a node of the program, as in the
    JAX package's exported forward."""
    p = getattr(mod, name)
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled() or torch.compiler.is_compiling():
        return p.to(dtype)
    cache = mod.__dict__.setdefault("_cast_cache", {})
    key = (p.data_ptr(), p._version, dtype)
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, p.detach().to(dtype))
    return hit[1]


def dense(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, cast_param(mod, "weight", x.dtype), cast_param(mod, "bias", x.dtype))


def conv_nhwc(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``mod`` to an NHWC tensor; returns NHWC."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), cast_param(mod, "weight", x.dtype), cast_param(mod, "bias", x.dtype),
        mod.stride, mod.padding, mod.dilation, mod.groups,
    )
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(mod: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``mod`` to an NHWC tensor; returns NHWC."""
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), cast_param(mod, "weight", x.dtype), cast_param(mod, "bias", x.dtype),
        mod.stride, mod.padding, mod.output_padding, mod.groups, mod.dilation,
    )
    return y.permute(0, 2, 3, 1)


def conv3d(mod: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``mod`` to a channels-first (B, C, X, Y, Z) tensor in x's dtype."""
    return F.conv3d(
        x, cast_param(mod, "weight", x.dtype), cast_param(mod, "bias", x.dtype),
        mod.stride, mod.padding, mod.dilation, mod.groups,
    )


def layer_norm_f32(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps)
    return y.to(x.dtype)


def batch_norm_nhwc(mod: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in f32 over the last axis of a channels-last tensor (NHWC,
    or LeViT's and Next-ViT's (B, N, C) tokens, whose statistics are taken
    over batch and tokens as flax takes them). In eval mode it reads the
    running statistics. In training mode it normalises by the batch's mean
    and biased variance and moves the running statistics towards them by
    ``mod.momentum`` (0.1, flax's ``momentum=0.9``). The running variance
    takes the biased batch variance, as flax's ``batch_stats`` does, where
    ``nn.BatchNorm2d`` itself would store the unbiased one.

    Under data parallelism the trainer gives the module a
    ``process_group`` (the ranks that hold the other rows of the batch),
    and the moments are the global batch's, in two passes: the sum and the
    count summed over the group, then the squared deviations from that
    mean. Both sums are differentiable, so the gradient of every rank's
    loss reaches every rank's rows. Without a group the moments are the
    local batch's, computed as on one process."""
    xf = x.float()
    if mod.training:
        dims = tuple(range(x.dim() - 1))
        group = getattr(mod, "process_group", None)
        if group is None:
            mean = xf.mean(dim=dims)
            var = xf.var(dim=dims, unbiased=False)
        else:
            total = xf.sum(dim=dims)
            count = xf.new_full((1,), xf.numel() // xf.shape[-1])
            total, count = all_reduce_sum(torch.cat([total, count]), group).split([len(total), 1])
            mean = total / count
            var = all_reduce_sum(torch.square(xf - mean).sum(dim=dims), group) / count
        with torch.no_grad():
            mod.running_mean.lerp_(mean, mod.momentum)
            mod.running_var.lerp_(var, mod.momentum)
    else:
        mean, var = mod.running_mean, mod.running_var
    y = (xf - mean) * torch.rsqrt(var + mod.eps)
    return (y * mod.weight + mod.bias).to(x.dtype)


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return x * mask.to(x.dtype) / keep


def drop_path_mask(
    batch: int, rate: float, device, dtype, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """(batch, 1, 1, 1) per-sample stochastic-depth factor: 0 with
    probability ``rate``, else ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    mask = torch.rand((batch, 1, 1, 1), device=device, generator=generator) < keep
    return mask.to(dtype) / keep
