"""Memory of a patch-wise training step across configurations (the port
of ``soccdpt_tpu/cli/eval_patchwise.py``; reference
scripts/eval_patchwise.py:69-181).

    python -m soccdpt_torch.cli.eval_patchwise [-t dpt_swin2_tiny_256] [-v 3] \\
        [--batch_sizes 1 2 4 8] [--patchwise 1.0 0.5 0.25] [--encoder_pct 0.5] [--device cpu]

The reference binary-searches the CUDA out-of-memory frontier over
(batch size, patch-wise percentage, encoder percentage); the JAX package
reads the compiled step's sizes from XLA's ``memory_analysis``. Here one
bf16 step of ``train/trainer.py::Trainer`` runs on a synthetic batch and
the card's allocator reports what it held: ``allocated_at_start_bytes``
(whatever the process held before the trainer was built),
``allocated_before_step_bytes`` (that, the weights, Adam's moments and the
batch), ``step_peak_bytes`` (the most allocated at once during the step,
from ``reset_peak_memory_stats`` and ``max_memory_allocated``) and the
step's own peak above what was allocated before it. XLA's temp, argument,
output and code sizes have no counterpart. On the CPU only ``n_patches``
is reported: its memory is not measured. Runs on the card unless
``--device`` names another device. A configuration that fails, out of
memory included, prints an ``error`` row, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.config import MODEL_TYPES, ModelConfig, TrainConfig
from ..core.device import resolve_device


def measure_step_memory(
    model_type: str,
    version: int,
    batch_size: int,
    patchwise_pct: float,
    encoder_pct: float,
    gt_hw: Tuple[int, int] = (256, 256),
    device: Union[str, torch.device, None] = None,
) -> dict:
    """One bf16 training step's patches and, on a card, its memory."""
    from ..train.trainer import Trainer

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        at_start = torch.cuda.memory_allocated(dev)
    mcfg = ModelConfig(model_type=model_type, version=version, compute_dtype="bfloat16")
    tcfg = TrainConfig(batch_size=batch_size, patchwise_percentage=patchwise_pct,
                       encoder_percentage=encoder_pct)
    trainer = Trainer(mcfg, tcfg, device=dev)
    _, w, h = MODEL_TYPES[model_type]
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.standard_normal((batch_size, 3, h, w)).astype(np.float32),
        "disparity": np.abs(rng.standard_normal((batch_size, *gt_hw))).astype(np.float32),
        "mask_disp": np.ones((batch_size, *gt_hw), np.float32),
        "seg": rng.random((batch_size, mcfg.num_classes, *gt_hw)).astype(np.float32),
        "mask_seg": np.ones((batch_size, mcfg.num_classes, *gt_hw), np.float32),
    }
    state = trainer.init_state(0)
    device_batch = trainer.to_device_batch(batch)
    generator = torch.Generator(device=dev).manual_seed(1)
    out = {"n_patches": len(trainer.masks)}
    if dev.type != "cuda":
        trainer.train_step(state, device_batch, generator)
        return out
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.train_step(state, device_batch, generator)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    out.update({
        "allocated_at_start_bytes": int(at_start),
        "allocated_before_step_bytes": int(before),
        "step_peak_bytes": int(peak),
        "step_peak_above_before_bytes": int(peak - before),
        "step_peak_gb": round(peak / 2**30, 3),
    })
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Patchwise memory sweep")
    parser.add_argument("-t", "--model_type", default="dpt_swin2_tiny_256")
    parser.add_argument("-v", "--version", type=int, default=3)
    parser.add_argument("--batch_sizes", nargs="+", type=int, default=[1, 2, 4, 8])
    parser.add_argument("--patchwise", nargs="+", type=float, default=[1.0, 0.5, 0.25])
    parser.add_argument("--encoder_pct", type=float, default=0.5)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    for bs in args.batch_sizes:
        for pw in args.patchwise:
            try:
                mem = measure_step_memory(args.model_type, args.version, bs, pw,
                                          args.encoder_pct, device=device)
                row = {"batch_size": bs, "patchwise_pct": pw, **mem}
            except Exception as e:  # a sweep reports a failing configuration and goes on
                row = {"batch_size": bs, "patchwise_pct": pw,
                       "error": f"{type(e).__name__}: {e}"[:200]}
            if device.type == "cuda":
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
