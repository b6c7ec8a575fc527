"""Benchmark: SOccDPT V3 ``dpt_swin2_tiny_256`` served rate on one card
(the port of ``soccdpt_tpu/cli/bench.py``).

    python -m soccdpt_torch.cli.bench          # BENCH_BATCH=1 BENCH_ITERS=201

Protocol: the reference times 50 sequential forwards of ``net(x)`` by
wall clock (reference eval_SOccDPT.py:247-259), where the forward is the
full contract: net-resolution heads, bicubic/nearest upsample to camera
resolution (1920x1080), depth inversion and unprojection, with
``compute_occ=False`` (reference SOccDPT.py:152,366-372). Here each
request serves uint8 frames already on the card through
``serving.make_serving_fn`` in bf16, on its CUDA-graph path, and ends in
``torch.cuda.synchronize()``; ``value`` is ``batch`` frames over the wall
time of one such request, from the fastest of five runs of
``BENCH_ITERS`` requests after three warm-ups. Beside it:
``device_ms_per_forward``, the CUDA-event time of the same requests
sent back to back (``utils/timing.py``), and the net-resolution pair
(``return_raw=True``, a graph of the model's own forward) on the same
protocol. The JAX CLI's ``BENCH_PALLAS`` and ``BENCH_WEIGHT_ARGS`` have
no counterpart: the port's kernels always run on the card and its weights
are tensors, never constants of a program.

Baseline: 47 Hz (reference README.md:7). Prints ONE JSON line.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device

METRIC = "inference_hz_per_chip_swin2_tiny_256_full_contract"
BASELINE_HZ = 47.0
REPEATS = 5
WARMUP = 3


def _sequential(fn: Callable, x: torch.Tensor, n_iters: int) -> Tuple[float, float]:
    """Seconds per request, fastest and standard deviation over
    ``REPEATS`` runs of ``n_iters`` requests, each ending in a
    synchronize."""
    cuda = x.device.type == "cuda"

    def done():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(WARMUP):
        fn(x)
    done()
    ests = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fn(x)
            done()
        ests.append((time.perf_counter() - t0) / n_iters)
    return min(ests), float(np.std(ests, ddof=1))


def bench(
    cfg: Optional[ModelConfig] = None,
    batch: int = 1,
    n_iters: int = 201,
    device: Union[str, torch.device, None] = None,
) -> dict:
    """Measure, print the JSON line and return it as a dict. ``cfg``: the
    flagship V3 in bf16 unless given (a test passes a tiny one)."""
    from ..utils.timing import measure_forward_hz
    from .eval_timing import device_name, timed_forward, timing_model

    dev = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3, compute_dtype="bfloat16")
    model = timing_model(cfg, dev)
    full, frames = timed_forward(cfg, model, "full", batch, dev)
    per_full, std_full = _sequential(full, frames, n_iters)
    _, device_per_full = measure_forward_hz(full, frames, batch, n_iters=n_iters, repeats=3)
    raw, x = timed_forward(cfg, model, "raw", batch, dev)
    per_raw, _ = _sequential(raw, x, n_iters)

    hz = batch / per_full
    row = {
        "metric": METRIC,
        "value": round(hz, 1),
        "unit": "frames/s",
        "vs_baseline": round(hz / BASELINE_HZ, 2),
        "batch": batch,
        # d(hz) = hz^2 / batch * d(t)
        "hz_std": round(hz * hz / batch * std_full, 1),
        "ms_per_forward": round(per_full * 1e3, 3),
        "ms_std": round(std_full * 1e3, 4),
        "device_ms_per_forward": round(device_per_full * 1e3, 4),
        "raw_net_hz": round(batch / per_raw, 1),
        "raw_net_ms": round(per_raw * 1e3, 3),
        "model_type": cfg.model_type,
        "device": device_name(dev),
    }
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    bench(batch=int(os.environ.get("BENCH_BATCH", "1")),
          n_iters=int(os.environ.get("BENCH_ITERS", "201")))


if __name__ == "__main__":
    main()
