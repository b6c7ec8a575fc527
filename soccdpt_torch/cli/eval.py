"""Evaluation CLI (the port of ``soccdpt_tpu/cli/eval.py``; reference
scripts/eval_SOccDPT.py).

    python -m soccdpt_torch.cli.eval -v 3 -dt bdd -t dpt_swin2_tiny_256 \\
        -l <checkpoint> [--device cpu]

Loads a model (weights from numpy seed 0, then the checkpoint: a
reference-layout ``.pth``/``.pt`` through ``core/torch_import.py``, or one
that ``cli/train.py`` wrote), saves colormapped RGB/GT/pred panels for N
random-split samples under ``media/visuals/<model>_<ds>_v<ver>/``,
measures FPS (``utils/timing.measure_forward_hz``, the model in eval mode
with its attention biases folded, as served), and reports the reference's
metrics (SSI-aligned depth errors + class-averaged seg IoU,
``train/evaluate.py``). The network runs in bf16, as in the JAX CLI, on
the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    import torch

    from ..core.config import MODEL_TYPES, ModelConfig, TrainConfig
    from ..data.loader import iterate_batches, random_split
    from ..models.bias_cache import build_inference_cache
    from ..models.soccdpt import build_model
    from ..train.evaluate import evaluate_depth_seg, make_eval_forward
    from ..utils import visualize
    from ..utils.timing import measure_forward_hz
    from .train import build_datasets, dataset_camera, load_weights

    parser = argparse.ArgumentParser(description="Evaluate SOccDPT (PyTorch)")
    parser.add_argument("-v", "--version", type=int, choices=[1, 2, 3], required=True)
    parser.add_argument("-dt", "--dataset", choices=["bdd", "idd", "idd+bdd"], required=True)
    parser.add_argument("-t", "--model_type", choices=list(MODEL_TYPES), required=True)
    parser.add_argument("-l", "--load", default=None, help="checkpoint to load")
    parser.add_argument(
        "-b", "--base_path", default=os.path.expanduser("~/Datasets/Depth_Dataset_Bengaluru")
    )
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--media_dir", default="media/visuals")
    parser.add_argument(
        "--use_pallas",
        action="store_true",
        help="accepted for the JAX CLI's command lines and ignored: the port's "
        "hand-written kernels are its only route on the card",
    )
    parser.add_argument("--skip_fps", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    tcfg = TrainConfig(dataset=args.dataset, base_path=args.base_path)
    dataset, num_classes, class_2_color = build_datasets(tcfg, args.model_type)

    mcfg_kw = dict(
        model_type=args.model_type,
        version=args.version,
        num_classes=num_classes,
        compute_dtype="bfloat16",
    )
    cam = dataset_camera(dataset)
    if cam is not None:
        mcfg_kw["camera"] = cam
    mcfg = ModelConfig(**mcfg_kw)
    model = build_model(mcfg, device=args.device, seed=0)
    if args.load:
        load_weights(model, args.load, args.version)
    device = next(model.parameters()).device

    forward = make_eval_forward(model)

    # ---- visuals for N random samples (eval_SOccDPT.py:127-244) ----
    n = min(args.num_samples, len(dataset))
    subset, _ = random_split(dataset, [n, len(dataset) - n], seed=0)
    out_dir = os.path.join(args.media_dir, f"{args.model_type}_{args.dataset}_v{args.version}")
    for i in range(n):
        s = subset[i]
        inv_d, seg = forward(s["image"][None])
        panel = visualize.eval_panel(
            s["image_raw"],
            inv_d[0].float().cpu().numpy(),
            s.get("disparity"),
            seg[0].float().cpu().numpy(),
            s.get("seg"),
            class_2_color,
        )
        visualize.save_image(os.path.join(out_dir, f"sample_{i:03d}.png"), panel)
    print(f"saved {n} visual panels to {out_dir}")

    # ---- FPS (eval_SOccDPT.py:247-259) ----
    if not args.skip_fps:
        # fold the parameter-derived attention biases first, so the rate is
        # the served one (eval_timing and serving read the folded biases)
        model.eval()
        build_inference_cache(model)
        x0 = torch.as_tensor(dataset[0]["image"][None]).to(device)
        with torch.no_grad():
            hz, dt = measure_forward_hz(
                lambda x: model(x, return_raw=True)[0], x0, batch=1
            )
        print(f"FPS (batch=1): {hz:.1f} Hz ({dt * 1e3:.2f} ms/forward)")

    # ---- metrics (eval_SOccDPT.py:262-283) ----
    metrics = evaluate_depth_seg(
        forward, iterate_batches(subset, 1, shuffle=False), max_batches=n
    )
    for k, v in metrics.items():
        print(f"{k}: {v:.6f}")
    return metrics


if __name__ == "__main__":
    main()
