"""Training CLI (the port of ``soccdpt_tpu/cli/train.py``; reference
scripts/train_SOccDPT.py).

    python -m soccdpt_torch.cli.train -v 3 -dt bdd -t dpt_swin2_tiny_256 \\
        --sweep_json config/SOccDPT_V3_dpt_swin2_tiny_256.json [--device cpu]

Reads the reference's sweep-JSON schema (config/*.json), applies the CLI
overrides (dataset, checkpoint_dir, base_path), runs grid/random trials
locally, and trains with ``train/trainer.py``'s ``Trainer`` on the card
(unless ``--device`` names another device): periodic eval rounds feed the
plateau controller of the learning rate and per-epoch checkpoints are
written under ``checkpoints/<project>/<run_id>/checkpoint_epoch_<n>`` as in
the reference (train_SOccDPT.py:437-449).

The sweep's ``load`` parameter starts a trial from weights: a ``.pth`` or
``.pt`` file is a reference-layout torch checkpoint, read through
``core/torch_import.py`` and merged leniently; anything else is a
checkpoint this CLI wrote, of which the weights are taken, with a fresh
optimizer (the reference's ``--load``).

Batches come as in the JAX CLI: ``iterate_batches``, a host thread
(``data.loader.prefetch``) that reads ``--host_prefetch`` batches ahead
(0: read on the loop's own thread), then ``device_prefetch`` with
``Trainer.to_device_batch`` (pinned memory, ``non_blocking`` copies), one
batch ahead of the step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Union

import torch

# batches the host thread reads ahead of the loop; 0 reads them on the
# loop's own thread
HOST_PREFETCH = 2


def build_datasets(tcfg, model_type: str):
    """Dataset selection (reference train_SOccDPT.py:179-202)."""
    from ..data.anue_labels import (
        LEVEL4_BASICS_ID,
        level4_basics_to_class,
        level4_basics_to_color,
    )
    from ..data.bdd import BDDDepthSegmentation, ConcatDataset, get_bdd_dataset
    from ..data.bdd import class_2_color as class_2_color_bdd
    from ..data.idd import get_all_IDD_Depth_Segmentation_datasets
    from ..data.transforms import load_transforms

    transform, _, _ = load_transforms(model_type)
    name = tcfg.dataset
    if "idd" in name:
        train_ds, val_ds = get_all_IDD_Depth_Segmentation_datasets(
            transform,
            level_id=LEVEL4_BASICS_ID,
            level_2_class=level4_basics_to_class,
        )
        dataset = ConcatDataset([train_ds, val_ds])
        num_classes = len(set(level4_basics_to_class.values()))
        class_2_color = level4_basics_to_color
    elif "bdd" in name:
        dataset = get_bdd_dataset(BDDDepthSegmentation, transform, tcfg.base_path)
        num_classes = 3
        class_2_color = class_2_color_bdd
    else:
        raise ValueError(f"unknown dataset {name!r}")
    return dataset, num_classes, class_2_color


def dataset_camera(dataset):
    """Camera intrinsics from the first BDD sequence, if any (IDD ships
    no calib -> None, callers fall back to the default CameraConfig)."""
    ds = dataset
    while hasattr(ds, "datasets"):
        ds = ds.datasets[0]
    seq = getattr(ds, "seq", None)
    return getattr(seq, "camera", None)


def load_weights(model: torch.nn.Module, path: str, version: int) -> Optional[Dict]:
    """Weights from ``path`` into ``model`` in place. A ``.pth``/``.pt`` file
    is a reference-layout torch checkpoint (``core/torch_import.py``, merged
    leniently, every leaf the file lacks kept); returns the merge's reports
    then. Anything else is a checkpoint of this package: its ``params``
    and, where it has them, ``batch_stats`` replace the model's (weights
    only: the optimizer starts afresh)."""
    from ..core.checkpoint import restore_checkpoint
    from ..core.torch_import import (
        family_of,
        import_soccdpt,
        load_imported,
        load_torch_state_dict,
    )
    from ..models.bias_cache import build_inference_cache

    if path.endswith((".pth", ".pt")):
        sd = load_torch_state_dict(path)
        params, stats = import_soccdpt(sd, version, family_of(model.cfg.backbone))
        return load_imported(model, params, stats)
    restored = restore_checkpoint(path)
    model.load_state_dict({**model.state_dict(), **restored["params"],
                           **restored.get("batch_stats", {})})
    build_inference_cache(model)
    return None


def training_checkpoint(model: torch.nn.Module, state) -> Dict:
    """What an epoch's checkpoint holds: the parameters and the BatchNorm
    statistics by the model's own names, Adam's moments by flax path, its
    step count and learning rate, and the patch-step count."""
    names = {name for name, _ in model.named_parameters()}
    sd = model.state_dict()
    return {
        "params": {k: v for k, v in sd.items() if k in names},
        "batch_stats": {k: v for k, v in sd.items() if k not in names},
        "opt_state": {"count": state.count, "learning_rate": state.learning_rate,
                      "mu": state.mu, "nu": state.nu},
        "step": state.step,
    }


def train_one(
    tcfg,
    model_type: str,
    version: int,
    run_id: str,
    max_steps: Optional[int] = None,
    log_dir: Optional[str] = None,
    camera=None,
    device: Union[str, torch.device, None] = None,
    host_prefetch: int = HOST_PREFETCH,
) -> Dict[str, float]:
    from ..core.checkpoint import checkpoint_dir, save_checkpoint
    from ..core.config import ModelConfig
    from ..data.loader import device_prefetch, iterate_batches, prefetch, split_train_val
    from ..train.evaluate import evaluate_depth_seg, make_eval_forward
    from ..train.trainer import Trainer
    from ..utils.logging import MetricWriter
    from ..utils.timing import StepTimer

    dataset, num_classes, class_2_color = build_datasets(tcfg, model_type)
    if camera is None:
        camera = dataset_camera(dataset)
    train_set, val_set = split_train_val(
        dataset, tcfg.val_percent, tcfg.dataset_percentage, seed=tcfg.seed
    )
    print(f"train={len(train_set)} val={len(val_set)}")

    mcfg_kw = dict(
        model_type=model_type,
        version=version,
        num_classes=num_classes,
        sigmoid=tcfg.sigmoid,
        compute_dtype="bfloat16" if tcfg.amp else "float32",
    )
    if camera is not None:
        mcfg_kw["camera"] = camera
    mcfg = ModelConfig(**mcfg_kw)

    trainer = Trainer(mcfg, tcfg, device=device)
    print(f"device: {trainer.device}")
    state = trainer.init_state(tcfg.seed)
    if tcfg.load:
        load_weights(trainer.model, tcfg.load, version)

    writer = MetricWriter(log_dir=log_dir, run_id=run_id)
    timer = StepTimer()
    generator = torch.Generator(device=trainer.device).manual_seed(tcfg.seed + 1)
    global_step = 0
    division_step = max(len(train_set) // (3 * tcfg.batch_size), 1)
    last_eval: Dict[str, float] = {}

    for epoch in range(1, tcfg.epochs + 1):
        batches = iterate_batches(train_set, tcfg.batch_size, shuffle=True, seed=tcfg.seed,
                                  epoch=epoch)
        if host_prefetch > 0:
            batches = prefetch(batches, size=host_prefetch)
        for batch in device_prefetch(batches, trainer.to_device_batch):
            state, metrics = trainer.train_step(state, batch, generator)
            timer.tick()
            loss = float(metrics["loss"])
            writer.log(
                {
                    **{k: float(v) for k, v in metrics.items()},
                    "epoch": epoch,
                    "lr": trainer.scheduler.lr,
                    "step_time_s": timer.mean,
                },
                step=global_step,
            )

            if global_step % division_step == 0:
                forward = make_eval_forward(trainer.model)
                last_eval = evaluate_depth_seg(
                    forward, iterate_batches(val_set, 1, shuffle=False), max_batches=16
                )
                writer.log({f"val/{k}": v for k, v in last_eval.items()}, global_step)
                if tcfg.log_histograms:
                    from ..utils.logging import param_histograms

                    writer.log(param_histograms(trainer.model), global_step)
                if tcfg.log_visuals and log_dir:
                    # eval-round side-by-side panel, like the reference's
                    # wandb.Image logging (utils/__init__.py:646-753)
                    from ..utils import visualize

                    s0 = val_set[0]
                    inv_d, seg_p = forward(s0["image"][None])
                    panel = visualize.eval_panel(
                        s0["image_raw"],
                        inv_d[0].float().cpu().numpy(),
                        s0.get("disparity"),
                        seg_p[0].float().cpu().numpy(),
                        s0.get("seg"),
                        class_2_color,
                    )
                    visualize.save_image(
                        os.path.join(log_dir, f"{run_id}_step{global_step:06d}.png"), panel
                    )
                state = trainer.on_plateau_metric(state, loss)
            global_step += 1
            if max_steps is not None and global_step >= max_steps:
                break
        if tcfg.save_checkpoint:
            run_dir = checkpoint_dir(tcfg.checkpoint_dir, tcfg.project_name, run_id)
            save_checkpoint(os.path.join(run_dir, f"checkpoint_epoch_{epoch}"),
                            training_checkpoint(trainer.model, state))
            print(f"Checkpoint {epoch} saved!")
        if max_steps is not None and global_step >= max_steps:
            break
    writer.close()
    return last_eval


def build_parser() -> argparse.ArgumentParser:
    from ..core.config import MODEL_TYPES

    parser = argparse.ArgumentParser(description="Train SOccDPT (PyTorch)")
    parser.add_argument("-v", "--version", type=int, choices=[1, 2, 3], required=True)
    parser.add_argument("-n", "--count", type=int, default=1)
    parser.add_argument("-dt", "--dataset", choices=["bdd", "idd", "idd+bdd"], required=True)
    parser.add_argument("-t", "--model_type", choices=list(MODEL_TYPES), required=True)
    parser.add_argument(
        "-c", "--checkpoint_dir", default=os.path.join(os.getcwd(), "checkpoints")
    )
    parser.add_argument(
        "-b", "--base_path", default=os.path.expanduser("~/Datasets/Depth_Dataset_Bengaluru")
    )
    parser.add_argument("--sweep_json", required=True)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument(
        "--use_pallas",
        action="store_true",
        help="accepted for the JAX CLI's command lines and ignored: the port's "
        "hand-written kernels are its only route on the card",
    )
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument(
        "--tp",
        type=int,
        default=1,
        help="tensor-parallel axis size; only 1: tensor parallelism is not "
        "ported yet (ROADMAP.md, queue 1, parallel/)",
    )
    parser.add_argument(
        "--host_prefetch",
        type=int,
        default=HOST_PREFETCH,
        help="batches a host thread reads ahead of the loop (0: read them on "
        "the loop's own thread)",
    )
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return parser


def main(argv=None):
    from ..core.config import SweepConfig, train_config_from_params

    args = build_parser().parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor parallelism (the JAX package's parallel/) is not "
            "ported to soccdpt_torch yet (ROADMAP.md, queue 1)"
        )

    sweep = SweepConfig.load(args.sweep_json)
    sweep.override(
        dataset=args.dataset,
        checkpoint_dir=args.checkpoint_dir,
        base_path=args.base_path,
    )
    project_name = f"SOccDPT_V{args.version}_{args.model_type}_{args.dataset}"

    results = []
    for i, params in enumerate(sweep.trials(count=args.count)):
        tcfg = train_config_from_params(params)
        tcfg = dataclasses.replace(tcfg, project_name=project_name)
        run_id = f"trial{i:03d}"
        print(f"=== {project_name} {run_id}: {params}")
        results.append(
            train_one(
                tcfg,
                args.model_type,
                args.version,
                run_id,
                max_steps=args.max_steps,
                log_dir=args.log_dir,
                device=args.device,
                host_prefetch=args.host_prefetch,
            )
        )
    return results


if __name__ == "__main__":
    main()
