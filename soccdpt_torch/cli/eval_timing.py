"""Rate and parameter count across model types (the port of
``soccdpt_tpu/cli/eval_timing.py``; reference scripts/eval_timing.py).

    python -m soccdpt_torch.cli.eval_timing -t dpt_swin2_tiny_256 dpt_beit_large_512 \\
        [-v 3] [--batch 1] [--contract raw|full|occ] [--json] [--device cpu]

For each model type: build the model in bf16 with structural weights
(``utils/fake_init.py``), fold its attention biases as serving does,
count its parameters, and time one forward with
``utils/timing.py::measure_forward_hz``. On the card every timed forward
is one CUDA-graph replay: ``full`` and ``occ`` go through
``serving.make_serving_fn`` on uint8 frames at camera resolution, ``raw``
through a graph of the model's own forward (``return_raw=True``) on a
normalized net-size input. Runs on the card unless ``--device`` names
another device.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import MODEL_TYPES, ModelConfig
from ..core.device import resolve_device

CONTRACTS = {
    "raw": "inverse depth and segmentation at net resolution (return_raw=True)",
    "full": "the reference's 47 Hz contract: inverse depth, segmentation and points at "
            "camera resolution, compute_occ=False",
    "occ": "the full contract plus the 256x256x32xC semantic occupancy grid "
           "(compute_occ=True)",
}


def timing_model(cfg: ModelConfig, device: torch.device) -> torch.nn.Module:
    """The model of ``cfg`` with structural weights, its biases folded, in
    eval mode on ``device``."""
    from ..models.bias_cache import build_inference_cache
    from ..models.soccdpt import SOccDPT_versions
    from ..utils.fake_init import structural_init

    if cfg.version not in SOccDPT_versions:
        raise ValueError(f"SOccDPT has versions {sorted(SOccDPT_versions)}, not V{cfg.version}")
    model = structural_init(SOccDPT_versions[cfg.version](cfg)).to(device).eval()
    return build_inference_cache(model)


def timed_forward(cfg: ModelConfig, model: torch.nn.Module, contract: str, batch: int,
                  device: torch.device):
    """``(fn, example)``: what one timed call runs, and its input (seed 0)."""
    from ..serving import GraphedFunction, make_serving_fn

    rng = np.random.default_rng(0)
    if contract == "raw":
        net_w, net_h = cfg.net_size
        x = torch.from_numpy(rng.standard_normal((batch, 3, net_h, net_w)).astype(np.float32))
        fn = lambda inp: model(inp, return_raw=True)  # noqa: E731
        if device.type == "cuda":
            fn = GraphedFunction(fn, model, device)
        else:
            fn = torch.inference_mode()(fn)
        return fn, x.to(device)
    cam = cfg.camera
    frames = rng.integers(0, 256, (batch, cam.height, cam.width, 3), dtype=np.uint8)
    fn = make_serving_fn(cfg, model, compute_occ=contract == "occ", device=device)
    return fn, torch.from_numpy(frames).to(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    from ..utils.timing import measure_forward_hz

    parser = argparse.ArgumentParser(
        description="Timing harness",
        epilog="The JAX CLI's --use_pallas has no counterpart: on the card the port's "
               "hand-written kernels always run, on the CPU their plain versions.")
    parser.add_argument("-t", "--model_types", nargs="+", default=["dpt_swin2_tiny_256"],
                        choices=list(MODEL_TYPES))
    parser.add_argument("-v", "--version", type=int, default=3)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--contract", choices=list(CONTRACTS), default="raw",
                        help="what each timed forward computes: " + "; ".join(
                            f"'{k}' = {v}" for k, v in CONTRACTS.items()))
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    results = []
    for mt in args.model_types:
        cfg = ModelConfig(model_type=mt, version=args.version, compute_dtype="bfloat16")
        model = timing_model(cfg, device)
        n_params = sum(p.numel() for p in model.parameters())
        fn, x = timed_forward(cfg, model, args.contract, args.batch, device)
        hz, dt = measure_forward_hz(fn, x, batch=args.batch)
        row = {
            "model_type": mt,
            "params_M": round(n_params / 1e6, 2),
            "hz": round(hz, 1),
            "ms_per_forward": round(dt * 1e3, 3),
            "batch": args.batch,
            "contract": args.contract,
            "device": device_name(device),
        }
        results.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            print(f"{mt:28s} {row['params_M']:8.1f}M params  {row['hz']:9.1f} Hz  "
                  f"{row['ms_per_forward']:8.2f} ms  ({row['device']})", flush=True)
        del model, fn, x
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
