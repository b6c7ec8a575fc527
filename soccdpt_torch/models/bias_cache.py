"""Bind-time folding of parameter-derived attention biases.

Swin-V2's continuous relative-position bias (CPB MLP, gather by relative
position index, ``16 * sigmoid``) depends on parameters only. As in the
JAX package's ``models/bias_cache.py``, serving computes it once when
weights are bound and reads it on every request.

A module that owns such a bias defines ``bias_params()`` (the parameters
it is computed from), ``compute_bias()`` and a non-persistent buffer
``bias_cache``. The cache is keyed by the storage and version counter of
each of those parameters: loading weights (``copy_``, ``load_state_dict``,
an optimizer step) bumps a version counter and moving the module moves
the storage, so a stale bias is never served. A stale cache is
recomputed inline until the next :func:`build_inference_cache`. With
gradients enabled the bias is always computed inline, so training sees
gradients through it.
"""
from __future__ import annotations

from typing import Tuple

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


def build_inference_cache(model: nn.Module) -> nn.Module:
    """Fold every bias of ``model`` from its current parameters."""
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "compute_bias"):
                mod.bias_cache = mod.compute_bias()
                mod._bias_key = _key(mod)
    return model


def clear_inference_cache(model: nn.Module) -> nn.Module:
    for mod in model.modules():
        if hasattr(mod, "compute_bias"):
            mod.bias_cache = None
            mod._bias_key = None
    return model
