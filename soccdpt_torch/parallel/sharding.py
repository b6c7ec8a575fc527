"""Which leaves are sharded over the ``model`` axis (the port of
``soccdpt_tpu/parallel/sharding.py``).

The JAX rule shards a leaf of at least ``min_size`` elements on its
largest dim that tp divides, ties going to the first such dim in flax
order, and leaves the rest replicated. It reads the flax shape, and the
port's leaves are in torch layout (a conv's OIHW against flax's HWIO, a
dense kernel transposed), so the rule is evaluated on the flax shape and
the dim it picks is mapped through ``weights.py``'s layout table: the
port shards the leaves and dims that the JAX package shards.

The port keeps full weights for its forward. What a leaf's sharding
splits is Adam's moments and the update: each rank along ``model`` holds
and updates its slice (``train/trainer.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..weights import flax_param_layouts, flax_shape, torch_dim
from .mesh import MODEL_AXIS, Mesh


def param_sharding_rules(
    model: torch.nn.Module, mesh: Mesh, min_size: int = 2**16
) -> Dict[str, Optional[int]]:
    """``{flax path: the torch dim sharded over model, or None}`` for every
    parameter of ``model``."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    rules: Dict[str, Optional[int]] = {}
    for path, (t, layout) in flax_param_layouts(model).items():
        shape = flax_shape(t.shape, layout)
        rules[path] = None
        if tp > 1 and np.prod(shape, dtype=np.int64) >= min_size:
            order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
            for dim in order:
                if shape[dim] % tp == 0 and shape[dim] >= tp:
                    rules[path] = torch_dim(dim, layout)
                    break
    return rules


def shard_slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (a view), or ``t`` itself
    where ``dim`` is None."""
    if dim is None:
        return t
    size = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.model_index * size, size)
