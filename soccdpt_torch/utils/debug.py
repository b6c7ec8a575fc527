"""Debug and determinism toggles (the port of ``soccdpt_tpu/utils/debug.py``;
SURVEY.md §5.2).

The reference's nearest equivalents are seeded determinism (reference
train_SOccDPT.py:150-154) and NaN/Inf scrubbing in its metrics. Here:
``enable_nan_checks`` turns on autograd's anomaly mode with NaN checks,
``set_determinism`` seeds every generator and makes cuDNN deterministic,
and ``tree_finite_report`` counts the non-finite values of a nested
mapping of tensors or arrays.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Iterator, Mapping, Tuple


def enable_nan_checks(enable: bool = True) -> None:
    """``torch.autograd.set_detect_anomaly(enable, check_nan=True)``.

    What it catches of what the JAX package's ``jax_debug_nans`` catches:
    a NaN that a backward function makes (a gradient), raised at that
    function with the traceback of the forward op it belongs to, on the
    CPU and on the card alike; and a NaN of a forward pass under autograd
    once it reaches the gradient. What it does not: ``jax_debug_nans``
    re-runs any computation that gave a NaN op by op and raises at the op
    that made it, forward ones included; anomaly mode never looks at
    forward outputs, so a NaN made outside autograd (a served request
    under ``no_grad``, an exported program) passes unseen. Check such
    outputs with :func:`tree_finite_report`. Anomaly mode slows every
    backward pass (each op's traceback is kept); it is a debugging aid."""
    import torch

    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def set_determinism(seed: int = 0) -> None:
    """Seed Python's ``random``, numpy's global generator and torch's (the
    CPU's and every card's), and make cuDNN pick deterministic algorithms
    (``cudnn.deterministic``, no ``cudnn.benchmark`` autotuning).

    Kernel K2 (``kernels/segment_sum.py``) sums each run of equal slots in
    registers and then adds it to the grid with a float ``red``, an atomic
    add, so the order of a voxel's additions across runs follows the
    warps' timing. Two identical grid requests of the flagship on an H100
    gave grids equal bit for bit (``chip_smoke.py``'s deployment phase;
    PERF.md): the runs of a voxel are few and mostly within one warp's
    tile. That is a measurement, not a guarantee; nothing here changes
    K2."""
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) as ``jax.tree_util.tree_leaves_with_path`` walks a
    tree of mappings (keys sorted), lists and tuples, with the path spelled
    as ``jax.tree_util.keystr`` spells it; ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (f"[{key!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + (f"[{i}]",))
    else:
        yield "".join(path), tree


def tree_finite_report(tree) -> Dict[str, int]:
    """Count non-finite values per leaf (debugging aid): ``{key path:
    count}`` for every leaf, tensor or array, that holds a NaN or an Inf.
    A tensor is counted where it lies."""
    import numpy as np
    import torch

    out = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = int((~torch.isfinite(leaf)).sum()) if leaf.is_floating_point() else 0
        else:
            bad = int((~np.isfinite(np.asarray(leaf))).sum())
        if bad:
            out[path] = bad
    return out
