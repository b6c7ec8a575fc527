#!/usr/bin/env python3
"""Wall of one training step of the flagship, V3 and V1, for one checkout
of the PyTorch port; run it on two checkouts in one call to compare them.

    python scripts/torch_train_step_ab.py --tree <checkout> [--out result.json]

On one CUDA card, with the port imported from ``<checkout>`` (its kernels
built there with nvcc): ``Trainer`` on ``dpt_swin2_tiny_256`` at batch 3,
``amp`` (bf16), encoder share 0.5, one patch, learning rate 1e-4 (the
training phase of ``chip_smoke.py``), weights from numpy seed 0 and a
synthetic batch with 1080p ground truth. For each version:

* ``step_ms``: the median wall of ``STEPS`` steps on a batch already on
  the card, synchronized, after ``WARMUP`` steps;
* ``host_batch_step_ms``: the same from the host batch (narrowed, pinned,
  copied at every step);
* ``device_ms`` and ``launches``: one profiled step's device time and
  device operations (kernels, copies, memsets).

Prints one JSON object, with the card's ``nvidia-smi`` name and power
limit. To compare a parent and a change, run parent, change, change,
parent in one session.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

WARMUP, STEPS = 3, 12


def median_wall_ms(torch, fn):
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def profiled_step(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith(("Optimizer.", "ProfilerStep#"))]
    return sum(ev.device_time_total for ev in rows) / 1e3, sum(ev.count for ev in rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="a checkout of the repo")
    parser.add_argument("--out", default=None, help="also write the JSON object here")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.tree)
    import torch

    import soccdpt_torch
    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.data.synthetic import make_batch
    from soccdpt_torch.kernels import _build
    from soccdpt_torch.train.trainer import Trainer

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"tree": args.tree, "package": soccdpt_torch.__file__, "card": card}
    for version in (3, 1):
        mcfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=version)
        net_w, net_h = mcfg.net_size
        batch = make_batch(0, 3, (1080, 1920), (net_h, net_w), mcfg.num_classes)
        tcfg = TrainConfig(amp=True, batch_size=3, encoder_percentage=0.5,
                           patchwise_percentage=1.0, learning_rate=1e-4)
        trainer = Trainer(mcfg, tcfg)
        state = trainer.init_state(seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        on_card = trainer.to_device_batch(batch)
        ms, times = median_wall_ms(torch, lambda: trainer.train_step(state, on_card, gen))
        host_ms, _ = median_wall_ms(torch, lambda: trainer.train_step(state, batch, gen))
        device_ms, launches = profiled_step(
            torch, lambda: trainer.train_step(state, on_card, gen))
        result[f"v{version}"] = {"step_ms": ms, "step_ms_all": times,
                                 "host_batch_step_ms": host_ms, "device_ms": device_ms,
                                 "launches": launches}
        del trainer, state, on_card
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
