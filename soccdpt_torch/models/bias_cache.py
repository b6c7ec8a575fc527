"""Bind-time folding of parameter-derived attention biases.

Swin-V2's continuous relative-position bias (CPB MLP, gather by relative
position index, ``16 * sigmoid``) and BEiT's gathered relative-position
table depend on parameters only. As in the JAX package's
``models/bias_cache.py``, serving computes them once when weights are
bound and reads them on every request.

A module that owns such a bias registers a non-persistent buffer
``bias_cache`` and defines ``bias_params()`` (the parameters the bias is
computed from) and ``compute_bias()``. The cache is keyed by the storage and version counter of
each of those parameters: loading weights (``copy_``, ``load_state_dict``,
an optimizer step) bumps a version counter and moving the module moves
the storage, so a stale bias is never served. A stale cache is
recomputed inline until the next :func:`build_inference_cache`. With
gradients enabled the bias is always computed inline, so training sees
gradients through it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


def _key(mod: nn.Module) -> Tuple:
    return tuple((p.data_ptr(), p._version) for p in mod.bias_params())


def cached_bias(mod: nn.Module) -> torch.Tensor:
    """``mod.compute_bias()``, or its cache when the cache is current."""
    if not torch.is_grad_enabled() and mod.bias_cache is not None:
        if mod._bias_key == _key(mod):
            return mod.bias_cache
    return mod.compute_bias()


def _owners(model: nn.Module):
    return [mod for mod in model.modules() if "bias_cache" in mod._buffers]


def build_inference_cache(
    model: nn.Module, cache_dtype: Optional[torch.dtype] = None
) -> nn.Module:
    """Fold every bias of ``model`` from its current parameters.

    ``cache_dtype`` (``torch.bfloat16``) stores the folded biases in a
    narrower type: it halves the bias reads of BEiT serving, where the
    (H, T, T) bias is the largest thing an attention call reads, at a
    relative perturbation of 2^-9 of the pre-softmax bias. Opt-in: the
    default keeps f32."""
    with torch.no_grad():
        for mod in _owners(model):
            bias = mod.compute_bias()
            mod.bias_cache = bias if cache_dtype is None else bias.to(cache_dtype)
            mod._bias_key = _key(mod)
    return model


def clear_inference_cache(model: nn.Module) -> nn.Module:
    for mod in _owners(model):
        mod.bias_cache = None
        mod._bias_key = None
    return model
