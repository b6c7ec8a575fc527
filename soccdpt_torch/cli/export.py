"""Model export (the port of ``soccdpt_tpu/cli/export.py``; reference
scripts/export_SOccDPT.py).

    python -m soccdpt_torch.cli.export -t dpt_swin2_tiny_256 [-v 3] \\
        [-l <weights>] [-o exports/soccdpt.pt2] [--batch N] [--with_points] \\
        [--device cpu]

The reference exports ONNX (opset 13, dynamic batch) and the JAX package
serialized StableHLO; the port's deployment artifact is a
``torch.export`` program: the bf16 forward with its weights, written once
by ``torch.export.save`` and run without the model's source by
``cli/run_exported.py``.

The attention kernels are nodes of the program: K1 (``soccdpt::window_attention``)
in every Swin-V2 block and K6 (``soccdpt::global_attention``) in every
ViT/BEiT block. Where the program runs on the card they launch the
hand-written kernels; on the CPU they run their plain versions. Loading
the program needs those ops registered (``soccdpt_torch.kernels.ops``)
and, on the card, their libraries built from ``soccdpt_torch/csrc/``. The
JAX CLI's ``use_pallas`` has no counterpart: on the card the port's
kernels are its only route.

The folded attention biases are bound before tracing
(``build_inference_cache``), so the program carries them as buffers and
reads what the served path reads; the weights' casts to bf16 are nodes of
the program, as in the JAX package's exported forward. The program runs
on the device it was exported on (the card unless ``--device`` says
otherwise).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.nn as nn

class _Forward(nn.Module):
    """The exported function: the raw net-resolution ``(inv_depth, seg)``,
    or with ``with_points`` the reference ONNX contract ``(inv_depth, seg,
    points)`` at camera resolution, without the grid."""

    def __init__(self, model: nn.Module, with_points: bool):
        super().__init__()
        self.model, self.with_points = model, with_points

    def forward(self, x: torch.Tensor):
        if self.with_points:
            inv_d, seg, points, _ = self.model(x, compute_occ=False)
            return inv_d, seg, points
        return self.model(x, return_raw=True)


def export_model(
    model_type: str,
    version: int,
    out_path: str,
    load: Optional[str] = None,
    batch: Optional[int] = None,
    with_points: bool = False,
    device=None,
) -> str:
    """Export the bf16 forward of ``model_type`` to ``out_path``; returns
    the path. Weights come from numpy seed 0, then ``load``: a
    ``.pth``/``.pt`` is a reference-layout checkpoint
    (``core/torch_import.py``), any other path a checkpoint of the port.
    ``batch=None`` gives the program a dynamic batch (the reference's
    dynamic axis 0), else it takes exactly ``batch`` images."""
    from ..core.config import MODEL_TYPES, ModelConfig
    from ..core.device import resolve_device
    from ..models.bias_cache import build_inference_cache
    from ..models.soccdpt import build_model
    from .train import load_weights

    dev = resolve_device(device)
    mcfg = ModelConfig(model_type=model_type, version=version, compute_dtype="bfloat16")
    model = build_model(mcfg, device=dev)
    if load:
        load_weights(model, load, version)
    build_inference_cache(model.eval())
    _, net_w, net_h = MODEL_TYPES[model_type]

    # an example batch of 2: torch.export specialises a dimension of size 1
    x = torch.zeros((batch or 2, 3, net_h, net_w), dtype=torch.float32, device=dev)
    dynamic = None
    if batch is None:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        program = torch.export.export(_Forward(model, with_points), (x,), dynamic_shapes=dynamic)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)
    print(f"exported {os.path.getsize(out_path)} bytes -> {out_path}")
    return out_path


def main(argv=None):
    from ..core.config import MODEL_TYPES

    parser = argparse.ArgumentParser(description="Export SOccDPT with torch.export")
    parser.add_argument("-v", "--version", type=int, choices=[1, 2, 3], default=3)
    parser.add_argument("-t", "--model_type", choices=list(MODEL_TYPES), required=True)
    parser.add_argument("-l", "--load", default=None)
    parser.add_argument("-o", "--out", default="exports/soccdpt.pt2")
    parser.add_argument("--batch", type=int, default=None, help="fix batch (default: dynamic)")
    parser.add_argument(
        "--with_points",
        action="store_true",
        help="export (disp, seg, points) at camera resolution like the reference's ONNX contract",
    )
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    return export_model(args.model_type, args.version, args.out, args.load, args.batch,
                        with_points=args.with_points, device=args.device)


if __name__ == "__main__":
    main()
