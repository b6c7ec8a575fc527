"""Occupancy training CLI (the port of ``soccdpt_tpu/cli/train_occupancy.py``;
reference scripts/train_SOccDPT_Occupancy.py).

    python -m soccdpt_torch.cli.train_occupancy -b <BDD tree> [--device cpu]

Trains only the 3-D occupancy head (``occupancy_conv``) against GT
occupancy grids from the BDD pipeline: dataset = ``BDDOccupancy`` (host GT
voxelization), loss = masked BCE between predicted and GT grids, every
other parameter frozen (``requires_grad=False``, so the backward never
enters the trunk, the window attention or the voxelizer). The head is a
real 3-D CNN (``occupancy_head=True``), not the reference's identity.
Runs on the card unless ``--device`` names another device.

Grid calibration
----------------
The reference hardcodes ``pc_scale``/``pc_shift`` constants tuned by hand
to its trained model's depth scale; a base model at another scale (or a
random one) puts every unprojected point outside the 256x256x32 volume,
the grid comes out empty and BCE sits at ln 2. ``--calibrate_grid``
(default ``auto``) probes the base model's point cloud on two training
samples and maps its 2nd-98th percentiles into the middle 90 % of the
volume; ``auto`` does so only when the reference constants leave under 5 %
of the points in bounds.

The step runs in train mode (BatchNorm on batch statistics, dropout and
stochastic depth drawn from a ``torch.Generator`` seeded 0 on the
device), the counterpart of the JAX step's ``deterministic=False``; the
JAX step draws its dropout from ``PRNGKey(0)`` at every step instead.

Batches are read and copied to the device one after another, as the JAX
CLI does. At 1080p a sample costs the host about nine steps; a host
thread that read samples ahead, with their copies issued ahead on a side
stream, lengthened the loop on the card (the thread's numpy work and the
step's launches share the interpreter; PERF.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import GT_OCCUPANCY, ModelConfig, OccupancyConfig
from ..ops.geometry import rotation_matrix
from ..train.losses import masked_bce_loss

PROBE_SAMPLES = 2  # training samples the grid calibration probes
PROBE_POINTS = 200_000  # about this many points of each sample's cloud
FAR_PLANE = 9e7  # a depth past it is the clamp of a zero inverse depth


def grid_override(occ: OccupancyConfig, new_grid: Sequence[int]) -> OccupancyConfig:
    """Change the grid's resolution, not the volume it covers:
    ``occupancy_shape = grid / scale``, so the scale follows the grid (a
    bare ``grid_size`` override would shrink the volume and put every GT
    point out of bounds)."""
    factors = [n / o for n, o in zip(new_grid, occ.grid_size)]
    return dataclasses.replace(
        occ,
        grid_size=tuple(new_grid),
        scale=tuple(s * f for s, f in zip(occ.scale, factors)),
    )


def in_bounds_frac(points: np.ndarray, occ: OccupancyConfig) -> float:
    """Share of (N, 3) camera-frame points that ``occ``'s scale, shift and
    rotation put inside the grid volume."""
    q = points * np.asarray(occ.pc_scale, np.float32) + np.asarray(occ.pc_shift, np.float32)
    q = q.astype(np.float32) @ rotation_matrix(occ.correction_angle)
    shape_m = np.asarray(occ.occupancy_shape, np.float32)
    inb = np.isfinite(q).all(-1) & (q >= 0).all(-1) & (q < shape_m).all(-1)
    return float(inb.mean())


def probe_cloud(model: torch.nn.Module, images: Sequence[np.ndarray]) -> np.ndarray:
    """The model's camera-frame points on each (3, h, w) image, finite and
    before the far plane, about ``PROBE_POINTS`` of each, concatenated."""
    device = next(model.parameters()).device
    model.eval()
    clouds = []
    for image in images:
        with torch.no_grad():
            pts = model(torch.from_numpy(image[None]).to(device), compute_occ=False)[2]
        pts = pts.float().cpu().numpy().reshape(-1, 3)
        pts = pts[np.isfinite(pts).all(-1)]
        pts = pts[np.abs(pts).max(-1) < FAR_PLANE]
        clouds.append(pts[:: max(1, len(pts) // PROBE_POINTS)])
    return np.concatenate(clouds, 0) if clouds else np.zeros((0, 3), np.float32)


def calibrate_grid(
    cloud: np.ndarray, occ: OccupancyConfig, mode: str = "auto"
) -> Tuple[OccupancyConfig, Dict[str, float]]:
    """``occ`` with ``pc_scale``/``pc_shift`` that map the cloud's 2nd-98th
    percentiles onto the middle 90 % of the volume, when ``mode`` is
    ``"on"``, or ``"auto"`` and under 5 % of the cloud lies in bounds;
    else ``occ`` itself. Also the in-bounds shares before and after."""
    info: Dict[str, float] = {"points": float(len(cloud))}
    if mode == "off" or len(cloud) < 100:
        return occ, info
    info["in_bounds_before"] = frac = in_bounds_frac(cloud, occ)
    if not (mode == "on" or frac < 0.05):
        return occ, info
    shape_m = np.asarray(occ.occupancy_shape, np.float32)
    lo = np.percentile(cloud, 2.0, axis=0).astype(np.float32)
    hi = np.percentile(cloud, 98.0, axis=0).astype(np.float32)
    span = np.maximum(hi - lo, 1e-6)
    pc_scale = 0.9 * shape_m / span
    pc_shift = 0.05 * shape_m - lo * pc_scale
    occ = dataclasses.replace(
        occ,
        pc_scale=tuple(float(v) for v in pc_scale),
        pc_shift=tuple(float(v) for v in pc_shift),
    )
    info["in_bounds_after"] = in_bounds_frac(cloud, occ)
    return occ, info


def auto_pos_weight(grid: np.ndarray) -> Tuple[float, int]:
    """(weight of the positive BCE term that balances the classes of
    ``grid``, capped at 1e5; its occupied cells)."""
    n_pos = float((np.asarray(grid) > 0.5).sum())
    return min(float(grid.size - n_pos) / max(n_pos, 1.0), 1e5), int(n_pos)


def occupancy_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Trainability by flax path: ``occupancy_conv`` alone."""
    from ..weights import named_flax_params

    return {path: "occupancy_conv" in path.split(".") for path, _ in named_flax_params(model)}


def occupancy_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    image: torch.Tensor,
    grid: torch.Tensor,
    mask: torch.Tensor,
    pos_weight: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One optimizer step of the head in train mode; returns the loss (a
    device tensor): masked BCE of the predicted grid, clipped to [1e-6,
    1 - 1e-6], against ``grid``. The model's frozen parameters must have
    ``requires_grad=False`` (``main`` sets it)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    pred = model(image, compute_occ=True, generator=generator)[3]
    B = pred.shape[0]
    loss = masked_bce_loss(
        torch.clamp(pred.reshape(B, -1).float(), 1e-6, 1 - 1e-6),
        grid.reshape(B, -1).float(),
        mask.reshape(B, -1).float(),
        pos_weight=pos_weight,
    )
    loss.backward()
    optimizer.step()
    return loss.detach()


def val_iou(model: torch.nn.Module, val_set, limit: Optional[int] = None) -> float:
    """Mean occupancy IoU of the model's grid against the GT over
    ``val_set`` (its first ``limit`` samples), in eval mode."""
    from ..data.loader import iterate_batches
    from ..train.evaluate import evaluate_occupancy, make_occupancy_forward

    batches = iterate_batches(val_set, 1, shuffle=False)
    return evaluate_occupancy(make_occupancy_forward(model), batches, limit)["iou_3D"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train occupancy head")
    parser.add_argument("-t", "--model_type", default="dpt_swin2_tiny_256")
    parser.add_argument("-v", "--version", type=int, default=3)
    parser.add_argument(
        "-b", "--base_path", default=os.path.expanduser("~/Datasets/Depth_Dataset_Bengaluru")
    )
    parser.add_argument("-l", "--load", default=None, help="base model checkpoint")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument(
        "-c", "--checkpoint_dir", default=os.path.join(os.getcwd(), "checkpoints")
    )
    parser.add_argument("--val_percent", type=float, default=0.1)
    parser.add_argument(
        "--pos_weight",
        default="1.0",
        help="positive-class BCE weight; 'auto' balances classes from the "
        "first batch (occupied cells are ~1e-5 of the grid; unweighted "
        "BCE — the reference's choice — collapses to all-empty). "
        "1.0 = reference-exact",
    )
    parser.add_argument(
        "--calibrate_grid",
        choices=["auto", "on", "off"],
        default="auto",
        help="derive pc_scale/pc_shift from the base model's point cloud; "
        "auto = only when <5%% of points land in the grid volume under the "
        "reference constants",
    )
    parser.add_argument(
        "--grid",
        type=int,
        nargs=3,
        default=None,
        metavar=("GX", "GY", "GZ"),
        help="occupancy grid resolution override (default 256 256 32); "
        "applies to both the GT voxelizer and the model's grid/head. "
        "GX/GY and GZ must be divisible by 4 (two 2x pools in the head)",
    )
    parser.add_argument(
        "--iou_every",
        type=int,
        default=0,
        help="evaluate val occupancy IoU every N steps and log the "
        "trajectory (0 = final eval only)",
    )
    parser.add_argument(
        "--iou_samples", type=int, default=4, help="val samples per trajectory IoU point"
    )
    parser.add_argument(
        "--bench_jsonl",
        default=None,
        help="append {step, loss, val_iou} trajectory rows to this JSONL",
    )
    parser.add_argument(
        "--device", default=None, help="torch device (default: the CUDA card)"
    )
    return parser


def main(argv=None) -> float:
    from ..core.checkpoint import (
        checkpoint_dir,
        load_params_lenient,
        restore_checkpoint,
        save_checkpoint,
    )
    from ..core.device import resolve_device
    from ..data.bdd import BDDOccupancy, get_bdd_dataset
    from ..data.loader import iterate_batches, split_train_val
    from ..data.transforms import load_transforms
    from ..models.bias_cache import build_inference_cache
    from ..models.soccdpt import build_model
    from ..train.patchwise import select_trainable
    from ..utils.logging import MetricWriter

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    transform, _, _ = load_transforms(args.model_type)
    ds_kwargs = {}
    if args.grid:
        ds_kwargs["occ"] = grid_override(GT_OCCUPANCY, args.grid)
    dataset = get_bdd_dataset(BDDOccupancy, transform, args.base_path, dataset_kwargs=ds_kwargs)
    # GT frames and unprojection run at the calib camera resolution
    camera = dataset.datasets[0].seq.camera
    for d in dataset.datasets:
        d.target_size = (camera.width, camera.height)
    train_set, val_set = split_train_val(dataset, args.val_percent, seed=0)

    mcfg = ModelConfig(
        model_type=args.model_type,
        version=args.version,
        compute_occ=True,
        occupancy_head=True,  # real 3D CNN, not the reference's Identity
        compute_dtype="bfloat16",
        camera=camera,
    )
    if args.grid:
        mcfg = dataclasses.replace(mcfg, occupancy=grid_override(mcfg.occupancy, args.grid))
    model = build_model(mcfg, device=device, seed=0)
    if args.load:
        restored = restore_checkpoint(args.load)["params"]
        model.load_state_dict(load_params_lenient(restored, model.state_dict()))
        build_inference_cache(model)

    if args.calibrate_grid != "off":
        images = [train_set[k]["image"] for k in range(min(PROBE_SAMPLES, len(train_set)))]
        cloud = probe_cloud(model, images)
        occ, info = calibrate_grid(cloud, mcfg.occupancy, args.calibrate_grid)
        if "in_bounds_before" not in info:
            print(
                "[calibrate] base model predicts no usable depth "
                f"({len(cloud)} finite in-range points) — keeping reference "
                "constants. Train the base model first and pass it via --load."
            )
        else:
            print(f"[calibrate] in-bounds under reference constants: {info['in_bounds_before']:.4f}")
        if occ is not mcfg.occupancy:
            mcfg = dataclasses.replace(mcfg, occupancy=occ)
            model.cfg = mcfg  # the geometry tail reads the config at every call
            print(
                f"[calibrate] pc_scale={tuple(round(v, 4) for v in occ.pc_scale)} "
                f"pc_shift={tuple(round(v, 4) for v in occ.pc_shift)}"
                f" -> in-bounds {info['in_bounds_after']:.4f}"
            )

    # only occupancy_conv trains: the rest has requires_grad=False, so
    # autograd builds no graph through the trunk, decoder or voxelizer
    select_trainable(model, occupancy_mask(model))
    optimizer = torch.optim.Adam(model.occupancy_conv.parameters(), lr=args.learning_rate)

    if args.pos_weight == "auto":
        pos_weight, n_pos = auto_pos_weight(train_set[0]["occupancy_grid"])
        print(f"[pos_weight] auto -> {pos_weight:.1f} ({n_pos} occupied)")
    else:
        pos_weight = float(args.pos_weight)

    def bench_row(step, loss, iou):
        if not args.bench_jsonl:
            return
        with open(args.bench_jsonl, "a") as fh:
            row = {
                "tag": "occ_iou_train",
                "model_type": args.model_type,
                "grid": list(args.grid or mcfg.occupancy.grid_size),
                "step": step,
                "loss": None if loss is None else round(loss, 6),
                "val_iou": round(iou, 6),
            }
            fh.write(json.dumps(row) + "\n")

    generator = torch.Generator(device=device).manual_seed(0)
    writer = MetricWriter(log_dir="logs", run_id="occupancy")
    step = 0
    for epoch in range(1, args.epochs + 1):
        for batch in iterate_batches(train_set, args.batch_size, seed=0, epoch=epoch):
            image, grid, mask = (torch.from_numpy(batch[k]).to(device)
                                 for k in ("image", "occupancy_grid", "mask_occ"))
            loss = float(occupancy_step(model, optimizer, image, grid, mask, pos_weight, generator))
            metrics = {"loss": loss, "epoch": epoch}
            step += 1
            if args.iou_every and step % args.iou_every == 0:
                iou = val_iou(model, val_set, limit=args.iou_samples)
                metrics["val_iou"] = iou
                print(f"step {step}: loss {loss:.4f} val_iou {iou:.4f}")
                bench_row(step, loss, iou)
            writer.log(metrics, step - 1)
            if args.max_steps and step >= args.max_steps:
                break
        run_dir = checkpoint_dir(args.checkpoint_dir, "SOccDPT_Occupancy", "run")
        save_checkpoint(
            os.path.join(run_dir, f"checkpoint_epoch_{epoch}.pt"), {"params": model.state_dict()}
        )
        if args.max_steps and step >= args.max_steps:
            break

    final_iou = val_iou(model, val_set)
    print(f"val iou_3D: {final_iou:.4f}")
    bench_row(step, None, final_iou)
    writer.close()
    return final_iou


if __name__ == "__main__":
    main()
