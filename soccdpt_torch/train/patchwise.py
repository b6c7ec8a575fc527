"""Patch-wise (parameter-subset) training (the port of
``soccdpt_tpu/train/patchwise.py``).

Each inner step of a training step unfreezes the next
``ceil(N * patchwise_percentage)`` of the N trainable parameters and runs
a full forward, backward and optimizer step. The JAX package freezes a
leaf with ``stop_gradient``; here it is ``requires_grad_(False)``, which
also prunes the leaf's backward graph.

A mask is a dictionary from a parameter's flax path to a flag, in the
JAX package's leaf order (``weights.named_flax_params``: the keys of each
level of its ``params`` tree sorted), so that the partition is the JAX
package's own and not one cut from ``named_parameters()`` order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch.nn as nn

from ..weights import named_flax_params

Mask = Dict[str, bool]

# Submodule names that make up "the pretrained encoder" for freezing.
ENCODER_SUBTREES = ("backbone", "pretrained")


def encoder_mask(
    model: nn.Module, encoder_percentage: float, subtrees: Sequence[str] = ENCODER_SUBTREES
) -> Mask:
    """Trainability mask: every leaf outside the encoder is trainable; of
    the encoder's N leaves the first ``round(N * encoder_percentage)`` in
    leaf order are trainable and the rest frozen."""
    if not 0.0 <= encoder_percentage <= 1.0:
        raise ValueError(f"encoder_percentage must lie in [0, 1], got {encoder_percentage}")
    paths = [path for path, _ in named_flax_params(model)]
    encoder = [p for p in paths if any(n in part for part in p.split(".") for n in subtrees)]
    unfrozen = set(encoder[: round(len(encoder) * encoder_percentage)])
    frozen = set(encoder) - unfrozen
    return {p: p not in frozen for p in paths}


def patch_masks(trainable: Mask, patchwise_percentage: float) -> List[Mask]:
    """Split the trainable leaves into ``ceil(1 / pct)`` disjoint patch
    masks, consecutive in leaf order."""
    if not 0.0 < patchwise_percentage <= 1.0:
        raise ValueError(f"patchwise_percentage must lie in (0, 1], got {patchwise_percentage}")
    train = [p for p, flag in trainable.items() if flag]
    if not train:
        raise ValueError("no trainable parameters")
    m = min(math.ceil(len(train) * patchwise_percentage), len(train))
    masks = []
    for start in range(0, len(train), m):
        active = set(train[start : start + m])
        masks.append({p: p in active for p in trainable})
    return masks


def select_trainable(model: nn.Module, mask: Mask) -> None:
    """Set ``requires_grad`` of every parameter of ``model`` to its flag."""
    for path, param in named_flax_params(model):
        param.requires_grad_(mask[path])


def mask_fraction(mask: Mask) -> float:
    return sum(bool(f) for f in mask.values()) / max(len(mask), 1)
