"""Dataset statistics (the port of ``soccdpt_tpu/cli/datasets_analysis.py``;
reference scripts/datasets_analysis.py): the sample count, each class's
share of the segmentation's pixels and the disparity's range.

    python -m soccdpt_torch.cli.datasets_analysis -dt bdd -b <tree>

Runs on the host alone: the samples come through ``cli/train.py::build_datasets``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def analyze(dataset, num_classes: int, max_samples: int = 50):
    counts = np.zeros(num_classes, np.int64)
    total_px = 0
    disp_stats = []
    n = min(len(dataset), max_samples)
    for i in range(n):
        s = dataset[i]
        if "seg" in s:
            seg = np.asarray(s["seg"]) > 0.5
            counts += seg.sum(axis=(1, 2)).astype(np.int64)
            total_px += seg.shape[1] * seg.shape[2]
        if "disparity" in s:
            d = np.asarray(s["disparity"])
            disp_stats.append((float(d.min()), float(d.mean()), float(d.max())))
    out = {
        "num_samples": len(dataset),
        "analyzed": n,
        "class_pixel_fraction": (counts / max(total_px, 1)).round(5).tolist(),
    }
    if disp_stats:
        arr = np.asarray(disp_stats)
        out["disparity"] = {
            "min": float(arr[:, 0].min()),
            "mean": float(arr[:, 1].mean()),
            "max": float(arr[:, 2].max()),
        }
    return out


def main(argv=None):
    from ..core.config import TrainConfig
    from .train import build_datasets

    parser = argparse.ArgumentParser(description="Dataset analysis")
    parser.add_argument("-dt", "--dataset", choices=["bdd", "idd"], required=True)
    parser.add_argument("-t", "--model_type", default="dpt_swin2_tiny_256")
    parser.add_argument(
        "-b", "--base_path", default=os.path.expanduser("~/Datasets/Depth_Dataset_Bengaluru")
    )
    parser.add_argument("--max_samples", type=int, default=50)
    args = parser.parse_args(argv)

    tcfg = TrainConfig(dataset=args.dataset, base_path=args.base_path)
    dataset, num_classes, _ = build_datasets(tcfg, args.model_type)
    out = analyze(dataset, num_classes, args.max_samples)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
