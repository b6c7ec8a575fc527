"""Checkpoints as torch state dicts, in the reference's directory layout.

The part of ``soccdpt_tpu/core/checkpoint.py`` the occupancy trainer
needs: ``checkpoint_dir``, ``save_checkpoint`` / ``restore_checkpoint``
(one ``torch.save`` file of a dict, e.g. ``{"params": model.state_dict()}``,
read back onto the CPU) and ``load_params_lenient``. The JAX package's
orbax checkpoints are not read here yet (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch


def checkpoint_dir(base_dir: str, project_name: str, run_id: str) -> str:
    """reference layout: checkpoints/<project>/<run_id>/ (train_SOccDPT.py:438)."""
    return os.path.join(base_dir, project_name, run_id)


def save_checkpoint(path: str, state: Mapping[str, Any]) -> None:
    """Write ``state`` (tensors, numbers, nested dicts) to ``path``, through
    a file of its own renamed into place, so a reader never sees half a
    checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The dict ``save_checkpoint`` wrote, every tensor on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_params_lenient(
    restored: Mapping[str, torch.Tensor],
    target: Mapping[str, torch.Tensor],
    verbose: bool = True,
) -> Dict[str, torch.Tensor]:
    """strict=False-style merge (reference base_model.py:22-37): for every
    name of ``target``, the restored tensor where the name and the shape
    match, else the target's own; the names kept from ``target`` are
    reported. Names only ``restored`` has are left out."""
    merged, skipped = {}, []
    for name, tgt in target.items():
        src = restored.get(name)
        if src is not None and tuple(src.shape) == tuple(tgt.shape):
            merged[name] = src
        else:
            merged[name] = tgt
            skipped.append(name)
    if verbose and skipped:
        print(f"[checkpoint] kept {len(skipped)} incompatible/missing leaves:")
        for name in skipped[:20]:
            print("  ", name)
    return merged
