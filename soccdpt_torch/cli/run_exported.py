"""Run an exported program (the port of ``soccdpt_tpu/cli/run_exported.py``;
reference scripts/run_SOccDPT_onnx.py).

    python -m soccdpt_torch.cli.run_exported [-m exports/soccdpt.pt2] \\
        [--batch 1] [--size 256] [--iters 100] [--vis panel.png] [--device cpu]

Loads a program written by ``cli/export.py`` with ``torch.export.load``,
runs it on a seeded ``(batch, 3, size, size)`` input, prints the outputs'
shapes and the kernels it launched in that forward, saves a visualization,
and measures frames/s over ``--iters`` forwards, ended by a
synchronize: the reference's onnxruntime flow (InferenceSession and a
100-iteration loop, run_SOccDPT_onnx.py:32-176) without ONNX.

The process imports no model code: only ``soccdpt_torch.kernels.ops``,
which registers the ``soccdpt::`` custom ops the program calls (K1, K6)
and, on the card, builds their libraries from ``soccdpt_torch/csrc/`` at
the first launch. The program runs on the card unless ``--device`` names
another device; one exported on another device is moved there.
"""
from __future__ import annotations

import argparse
import time


def load_program(path: str, device):
    """The callable module of the program at ``path`` on ``device``, the
    ``soccdpt::`` ops registered; a program exported on another device is
    moved there."""
    import torch

    from ..kernels import ops  # noqa: F401  (registers the ops the program calls)

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    program = torch.export.load(path)
    tensors = [*program.state_dict.values(), *program.constants.values()]
    if any(isinstance(t, torch.Tensor) and t.device != device for t in tensors):
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module()


def main(argv=None):
    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..kernels import ops

    parser = argparse.ArgumentParser(description="Run exported SOccDPT")
    parser.add_argument("-m", "--model", default="exports/soccdpt.pt2")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--vis", default=None, help="save visualization PNG")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    fn = load_program(args.model, dev)

    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((args.batch, 3, args.size, args.size))
        .astype(np.float32)
    ).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.no_grad():
        before = ops.launches()
        out = fn(x)
        sync()
        launched = {k: n - before[k] for k, n in ops.launches().items()}
        print("outputs:", *(tuple(o.shape) for o in out))
        print("kernel launches in one forward:",
              ", ".join(f"{k} {n}" for k, n in launched.items()))

        if args.vis:
            from ..data.bdd import class_2_color
            from ..utils import visualize

            panel = visualize.side_by_side(
                visualize.colorize_disparity(out[0][0].float().cpu().numpy()),
                visualize.color_segmentation(out[1][0].float().cpu().numpy(), class_2_color),
            )
            visualize.save_image(args.vis, panel)
            print("saved", args.vis)

        # frames/s over the loaded program
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(x)
        sync()
        dt = (time.perf_counter() - t0) / args.iters
    print(f"{args.batch / dt:.1f} Hz ({dt * 1e3:.2f} ms/forward)")


if __name__ == "__main__":
    main()
