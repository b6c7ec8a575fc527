"""Post-hoc run graphing (the port of ``soccdpt_tpu/cli/graph_runs.py``;
reference scripts/wandb_graph_runs.py:10-159).

    python -m soccdpt_torch.cli.graph_runs [--log_dir logs] [--out_dir media/graphs]

The reference pulls run histories from the wandb API and renders metric
plots with fixed axis ranges (RMSE 12-14, a1 0.65-0.75,
wandb_graph_runs.py:104-107). Here runs are the JSONL files the trainers
write (``utils/logging.py``); this renders per-metric PNG comparisons
across runs with matplotlib, which is imported only to plot and is not
installed on every machine (a clear error says so). A host tool: it
touches no device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load_runs(log_dir: str) -> Dict[str, List[dict]]:
    runs = {}
    for path in sorted(glob.glob(os.path.join(log_dir, "metrics_*.jsonl"))):
        name = os.path.basename(path)[len("metrics_"):-len(".jsonl")]
        with open(path) as fh:
            runs[name] = [json.loads(line) for line in fh if line.strip()]
    return runs


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "graph_runs plots with matplotlib, which is not installed here"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metric(runs, metric: str, out_path: str, ylim=None) -> bool:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    plotted = False
    for name, records in runs.items():
        xs = [r["step"] for r in records if metric in r and r["step"] is not None]
        ys = [r[metric] for r in records if metric in r and r["step"] is not None]
        if xs:
            ax.plot(xs, ys, label=name)
            plotted = True
    if not plotted:
        plt.close(fig)
        return False
    ax.set_xlabel("step")
    ax.set_ylabel(metric)
    if ylim:
        ax.set_ylim(*ylim)
    ax.legend()
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


DEFAULT_METRICS = {
    # reference plot ranges (wandb_graph_runs.py:104-107)
    "val/rmse": (12.0, 14.0),
    "val/a1": (0.65, 0.75),
    "loss": None,
    "val/iou": None,
    "val/abs_rel": None,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Graph training runs")
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--out_dir", default="media/graphs")
    parser.add_argument("--metrics", nargs="*", default=None)
    parser.add_argument("--no_ylim", action="store_true")
    args = parser.parse_args(argv)

    runs = load_runs(args.log_dir)
    if not runs:
        print(f"no runs found in {args.log_dir}")
        return
    metrics = {m: None for m in args.metrics} if args.metrics else DEFAULT_METRICS
    for metric, ylim in metrics.items():
        out = os.path.join(args.out_dir, metric.replace("/", "_") + ".png")
        if plot_metric(runs, metric, out, None if args.no_ylim else ylim):
            print("wrote", out)


if __name__ == "__main__":
    main()
