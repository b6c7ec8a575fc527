#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax) into an ``.npz`` that the
PyTorch port reads with numpy alone.

    python scripts/orbax_to_npz.py <orbax checkpoint dir> <out.npz>

Run it where JAX and orbax are installed: it reads the checkpoint through
``soccdpt_tpu.core.checkpoint.restore_checkpoint``, which restores every
leaf as a host array whatever mesh wrote it. The port reads the result
through ``soccdpt_torch.core.checkpoint.restore_jax_export`` (the
trainer's ``restore_state`` resumes from it; ``load_weights`` of the
training, eval, export and eval_others CLIs takes its weights).

The keys of the ``.npz`` are ``/``-joined flax paths:

* ``params/...`` and ``batch_stats/...``: the variables, in flax layout;
* ``opt_state/mu/...`` and ``opt_state/nu/...``: Adam's moments, one per
  parameter, in flax layout too;
* ``opt_state/count``: Adam's step count, the one its bias correction uses;
* ``opt_state/learning_rate``: the learning rate the plateau controller set;
* ``step``: the trainer's step count.

The JAX trainer's optimizer is ``optax.inject_hyperparams(optax.adamw)``
(``soccdpt_tpu/train/trainer.py::make_optimizer``), whose restored state is
``{"count", "hyperparams": {"learning_rate", ...}, "inner_state": [adam,
decay, lr]}``; the moments and Adam's count are read from
``opt_state/inner_state/0/{mu,nu,count}`` and the learning rate from
``opt_state/hyperparams/learning_rate``. A checkpoint without
``opt_state`` gives the variables and ``step`` only.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

import numpy as np


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}" if prefix else str(key), out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def _item(seq: Any, index: int) -> Any:
    return seq[index] if isinstance(seq, (list, tuple)) else seq[str(index)]


def export_arrays(restored: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The ``.npz`` arrays of a restored checkpoint dict."""
    out: Dict[str, np.ndarray] = {}
    _flatten(restored["params"], "params", out)
    _flatten(restored.get("batch_stats") or {}, "batch_stats", out)
    opt = restored.get("opt_state")
    if opt is not None:
        adam = _item(opt["inner_state"], 0)
        _flatten(adam["mu"], "opt_state/mu", out)
        _flatten(adam["nu"], "opt_state/nu", out)
        out["opt_state/count"] = np.asarray(adam["count"])
        out["opt_state/learning_rate"] = np.asarray(opt["hyperparams"]["learning_rate"])
    if "step" in restored:
        out["step"] = np.asarray(restored["step"])
    return out


def convert(src: str, dst: str) -> Dict[str, np.ndarray]:
    from soccdpt_tpu.core.checkpoint import restore_checkpoint

    arrays = export_arrays(restore_checkpoint(src))
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    np.savez(dst, **arrays)
    return arrays


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="orbax checkpoint directory of the JAX package")
    parser.add_argument("dst", help="the .npz to write")
    args = parser.parse_args(argv)
    arrays = convert(args.src, args.dst)
    n_params = sum(k.startswith("params/") for k in arrays)
    print(f"{args.dst}: {n_params} parameters, "
          f"{sum(k.startswith('batch_stats/') for k in arrays)} batch statistics, "
          f"{'with' if 'opt_state/count' in arrays else 'without'} the optimizer state")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    main()
