"""Structural parameter initialization for timing and memory runs.

The port of ``soccdpt_tpu/utils/fake_init.py``: every parameter is
filled with small random values, ``N(0, 1) * 0.02``, drawn by a numpy
generator of seed 0 in ``named_parameters`` order. Timing does not depend
on the values, and drawing them costs less than the fan-in-scaled init of
``weights.init_random_``. No parity with the JAX function's values is
claimed: it draws per flax leaf in float64, this draws per parameter in
float32, in another order. Buffers (BatchNorm statistics, tables) keep
the values the module was built with.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def structural_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``model`` in place; returns ``model``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            draw = rng.standard_normal(tuple(p.shape), dtype=np.float32) * np.float32(0.02)
            p.copy_(torch.from_numpy(draw))
    return model
