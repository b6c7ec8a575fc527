"""Checkpoints as torch state dicts, in the reference's directory layout.

The port of ``soccdpt_tpu/core/checkpoint.py``: ``checkpoint_dir``,
``save_checkpoint`` / ``restore_checkpoint`` (one ``torch.save`` file of a
dict, e.g. ``{"params": model.state_dict()}``, read back onto the CPU) and
``load_params_lenient``. A save is topology-free: the trainer gathers the
sharded optimizer state first (``Trainer.gather_state``) and one rank
writes.

The JAX package's orbax checkpoints need JAX to read.
``scripts/orbax_to_npz.py`` (run where JAX is installed) writes one as an
``.npz`` of flax paths, which :func:`restore_jax_export` reads with numpy
alone.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
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


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *scopes, leaf = path.split("/")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = value
    return tree


def restore_jax_export(path: str) -> Dict[str, Any]:
    """A JAX-package checkpoint converted by ``scripts/orbax_to_npz.py``: an
    ``.npz`` whose keys are ``/``-joined flax paths, ``params/...``,
    ``batch_stats/...``, ``opt_state/mu/...``, ``opt_state/nu/...``,
    ``opt_state/count``, ``opt_state/learning_rate`` and ``step``. Returns
    ``{"variables": {"params": tree, "batch_stats": tree}, "opt_state":
    {"count", "learning_rate", "mu", "nu"}, "step"}``: the variables as
    nested dicts of numpy arrays in the flax layouts (what
    ``weights.load_jax_variables`` reads), the moments by dotted flax path,
    in the flax layouts too (``weights.moments_to_torch``). A file without
    the optimizer state gives ``opt_state`` ``None``."""
    with np.load(os.path.abspath(path), allow_pickle=False) as npz:
        flat = {key: npz[key] for key in npz.files}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top == "opt_state" and rest.startswith(("mu/", "nu/")):
            top, _, rest = rest.partition("/")
            rest = rest.replace("/", ".")
        groups.setdefault(top, {})[rest] = value
    unknown = set(groups) - {"params", "batch_stats", "mu", "nu", "opt_state", "step"}
    if unknown or "params" not in groups:
        raise KeyError(f"{path}: not a JAX checkpoint export (top-level keys {sorted(groups)})")
    opt = None
    if "mu" in groups:
        scalars = groups["opt_state"]
        opt = {"count": int(scalars["count"]), "learning_rate": float(scalars["learning_rate"]),
               "mu": groups["mu"], "nu": groups["nu"]}
    return {
        "variables": {"params": _nest(groups["params"]),
                      "batch_stats": _nest(groups.get("batch_stats", {}))},
        "opt_state": opt,
        "step": int(groups["step"][""]) if "step" in groups else 0,
    }
