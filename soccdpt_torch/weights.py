"""Weights: random initialisation, and the JAX package's trees in and out.

The port names its submodules after the flax scopes
(``depth_net.backbone.stage0_block0.attn.qkv``, ``seg_head.bn``, ...), so
a flax ``{"params": ..., "batch_stats": ...}`` tree maps onto the port's
state by name, with these layout changes:

* conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W);
* 3-D conv ``kernel`` (D, H, W, I, O) -> ``weight`` (O, I, D, H, W);
* transposed conv ``kernel`` (H, W, I, O) -> ``weight`` (I, O, H, W),
  flipped along both spatial axes: flax's ``nn.ConvTranspose`` runs a
  fractionally strided correlation with the stored kernel, torch's
  ``ConvTranspose2d`` the gradient of a convolution, which is its mirror
  image;
* dense ``kernel`` (in, out) -> ``weight`` (out, in);
* LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``;
* BatchNorm ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
  ``running_var``;
* plain parameters (``q_bias``, ``v_bias``, ``logit_scale``, ``cls_token``,
  ``pos_embed``, ``rel_pos_table``, ``gamma_1``, ``gamma_2``) as they are.

``to_jax_variables`` is the way back, for parameters, their gradients and
the running statistics; ``named_flax_params`` lists the parameters under
their flax paths in the JAX package's leaf order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

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
            elif isinstance(mod, nn.ConvTranspose2d) and pname == "weight":
                yield t, "params", pre + "kernel", "conv_transpose"
            elif isinstance(mod, nn.Conv2d) and pname == "weight":
                yield t, "params", pre + "kernel", "conv"
            elif isinstance(mod, nn.Conv3d) and pname == "weight":
                yield t, "params", pre + "kernel", "conv3d"
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)) and pname == "weight":
                yield t, "params", pre + "scale", None
            else:
                yield t, "params", pre + pname, None
        if isinstance(mod, nn.BatchNorm2d):
            yield mod.running_mean, "batch_stats", pre + "mean", None
            yield mod.running_var, "batch_stats", pre + "var", None


def _to_torch_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return arr.transpose(3, 2, 0, 1)
    if layout == "conv3d":
        return arr.transpose(4, 3, 0, 1, 2)
    if layout == "conv_transpose":
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _to_flax_layout(arr: np.ndarray, layout) -> np.ndarray:
    """The inverse of :func:`_to_torch_layout`."""
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return arr.transpose(2, 3, 1, 0)
    if layout == "conv3d":
        return arr.transpose(2, 3, 4, 1, 0)
    if layout == "conv_transpose":
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return arr


def named_flax_params(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``(flax path, parameter)`` for every parameter of ``model``, in the
    order in which the JAX package enumerates the leaves of its ``params``
    tree: nested dictionaries flattened with the keys of each level
    sorted. That is not ``model.named_parameters()`` order, and the
    patch-wise training masks are cut from it."""
    found = [(path, t) for t, coll, path, _ in _targets(model) if coll == "params"]
    return sorted(found, key=lambda item: tuple(item[0].split(".")))


def to_jax_variables(model: nn.Module, grads: bool = False) -> Dict[str, Dict]:
    """``{"params": ..., "batch_stats": ...}`` of numpy leaves under the
    flax paths and in the flax layouts: what ``load_jax_variables`` reads,
    written back. With ``grads`` the ``params`` leaves are the parameters'
    ``.grad`` (zeros where a parameter has none) and there is no
    ``batch_stats``. Raises if two tensors map to one path."""
    out: Dict[str, Dict] = {"params": {}} if grads else {"params": {}, "batch_stats": {}}
    seen = set()
    for t, coll, path, layout in _targets(model):
        if (coll, path) in seen:
            raise KeyError(f"two tensors of the model map to {coll}:{path}")
        seen.add((coll, path))
        if grads:
            if coll != "params":
                continue
            t = t.grad if t.grad is not None else torch.zeros_like(t)
        arr = _to_flax_layout(t.detach().float().cpu().numpy(), layout)
        node = out[coll]
        *scopes, leaf = path.split(".")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


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
            arr = _to_torch_layout(trees[coll][path], layout)
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
    scales near 1, running variances in [0.8, 1.2], BEiT's LayerScale
    gammas near their init of 0.1, and its relative-position tables with
    a standard deviation of 0.5, so that the bias they gather shapes the
    softmax and an attention that dropped it could not pass a comparison.
    The draws do not depend on the device, so one seed gives one model
    everywhere."""
    rng = np.random.default_rng(seed)

    def draw(shape, std, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32))

    with torch.no_grad():
        for t, coll, path, layout in _targets(model):
            name = path.rsplit(".", 1)[-1]
            if layout in ("dense", "conv", "conv3d"):
                fan_in = t[0].numel()
                t.copy_(draw(t.shape, 1.0 / math.sqrt(fan_in)))
            elif layout == "conv_transpose":
                # (in, out, k, k) with stride k: one tap per input channel
                t.copy_(draw(t.shape, 1.0 / math.sqrt(t.shape[0])))
            elif name == "rel_pos_table":
                t.copy_(draw(t.shape, 0.5))
            elif name in ("gamma_1", "gamma_2"):
                t.copy_(draw(t.shape, 0.02, 0.1))
            elif name == "scale":
                t.copy_(draw(t.shape, 0.05, 1.0))
            elif name == "logit_scale":
                t.copy_(draw(t.shape, 0.05, math.log(10.0)))
            elif name == "var":
                t.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, t.shape).astype(np.float32)))
            else:  # biases, q/v biases, cls token, pos-embed, running means
                t.copy_(draw(t.shape, 0.05))
    return build_inference_cache(model)
