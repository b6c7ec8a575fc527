"""Weights: random initialisation and loading of the JAX package's trees.

The port names its submodules after the flax scopes
(``depth_net.backbone.stage0_block0.attn.qkv``, ``seg_head.bn``, ...), so
a flax ``{"params": ..., "batch_stats": ...}`` tree maps onto the port's
state by name, with these layout changes:

* conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W);
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* LayerNorm / BatchNorm ``scale`` -> ``weight``;
* BatchNorm ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
* plain parameters (``q_bias``, ``v_bias``, ``logit_scale``) as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .models.bias_cache import build_inference_cache


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def _targets(model: nn.Module):
    """Yield (torch tensor, collection, flax path, layout) for every
    parameter and BatchNorm statistic of ``model``."""
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        for pname, t in mod.named_parameters(recurse=False):
            if isinstance(mod, nn.Linear) and pname == "weight":
                yield t, "params", pre + "kernel", "dense"
            elif isinstance(mod, nn.Conv2d) and pname == "weight":
                yield t, "params", pre + "kernel", "conv"
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)) and pname == "weight":
                yield t, "params", pre + "scale", None
            else:
                yield t, "params", pre + pname, None
        if isinstance(mod, nn.BatchNorm2d):
            yield mod.running_mean, "batch_stats", pre + "mean", None
            yield mod.running_var, "batch_stats", pre + "var", None


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX variables tree (numpy leaves) into ``model`` in place.

    Raises on a shape mismatch and on any key left unused on either side.
    Folds the attention biases from the new weights afterwards.
    """
    trees = {c: _flatten(variables.get(c, {})) for c in ("params", "batch_stats")}
    extra = set(variables) - set(trees)
    if extra:
        raise KeyError(f"unexpected variable collections {sorted(extra)}")
    used = {c: set() for c in trees}
    missing = []
    with torch.no_grad():
        for t, coll, path, layout in _targets(model):
            if path not in trees[coll]:
                missing.append(f"{coll}:{path}")
                continue
            arr = trees[coll][path]
            if layout == "dense":
                arr = arr.T
            elif layout == "conv":
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"{coll}:{path}: JAX shape {arr.shape} does not fit {tuple(t.shape)}"
                )
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)))
            used[coll].add(path)
    unused = [f"{c}:{p}" for c in trees for p in sorted(set(trees[c]) - used[c])]
    if missing or unused:
        raise KeyError(f"weights do not match: missing {missing}, unused {unused}")
    return build_inference_cache(model)


def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``model`` in place with weights drawn from ``numpy`` seed
    ``seed``: fan-in-scaled normal kernels, small nonzero biases, norm
    scales near 1, running variances in [0.8, 1.2]. The draws do not
    depend on the device, so one seed gives one model everywhere."""
    rng = np.random.default_rng(seed)

    def draw(shape, std, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32))

    with torch.no_grad():
        for t, coll, path, layout in _targets(model):
            name = path.rsplit(".", 1)[-1]
            if layout in ("dense", "conv"):
                fan_in = t[0].numel()
                t.copy_(draw(t.shape, 1.0 / math.sqrt(fan_in)))
            elif name == "scale":
                t.copy_(draw(t.shape, 0.05, 1.0))
            elif name == "logit_scale":
                t.copy_(draw(t.shape, 0.05, math.log(10.0)))
            elif name == "var":
                t.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, t.shape).astype(np.float32)))
            else:  # biases, q/v biases, running means
                t.copy_(draw(t.shape, 0.05))
    return build_inference_cache(model)
