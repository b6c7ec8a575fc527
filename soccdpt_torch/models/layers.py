"""Layer calls in the compute dtype of their input.

Parameters stay f32 (as the JAX package's ``param_dtype``); a layer runs
in the dtype of the activation it is given, casting its weights to it,
as flax's ``dtype=`` does. Without gradients the cast is made once and
kept (:func:`cast_param`), so bf16 serving does not re-cast every weight
on every request. LayerNorm and BatchNorm compute in f32 and
cast back, as the JAX modules' ``dtype=jnp.float32`` norms do.
Activations are NHWC at module boundaries, as in the JAX package;
convolutions view them as NCHW (a channels-last view, no copy).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def cast_param(mod: nn.Module, name: str, dtype: torch.dtype):
    """``getattr(mod, name)`` in ``dtype``. Without gradients the cast is
    cached on the module, keyed by the parameter's storage and version
    counter, so a weight load or a move invalidates it."""
    p = getattr(mod, name)
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled():
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


def layer_norm_f32(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps)
    return y.to(x.dtype)


def batch_norm_eval_nhwc(mod: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm with running statistics, in f32, on NHWC."""
    y = (x.float() - mod.running_mean) * torch.rsqrt(mod.running_var + mod.eps)
    return (y * mod.weight + mod.bias).to(x.dtype)
