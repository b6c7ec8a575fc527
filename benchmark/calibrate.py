"""Readings that the limits of ``correct`` and the cells' rates are set
from, at a cell's own sizes on the card, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 ... [--seconds 3]
        the program's numbers, one short run a seed (the benchmark's own path);
    python3 -m benchmark.calibrate --workload <name> --control 1 2 3
        the control: the reference in fp8 (its geometry in bf16) put in the
        program's place, on the same frames;
    python3 -m benchmark.calibrate --workload <name> --sweep 20 25 30 [--seconds 10]
        an open-loop cell at other tick rates: the tail, and whether the
        last ticks waited longer than the first (a queue that grows).

Each reading is one JSON line on standard output, with every number of
the comparison, those the cell's limits leave out too.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from . import reference, run, serve, spec, system
from .reference import precision


def program_readings(cell, seeds, seconds, device):
    for seed in seeds:
        numbers = {}
        out = run.execute(cell, seed, seconds, False, device, time.perf_counter(), numbers)
        print(json.dumps({"seed": seed, "side": "program", "correct": out["correct"],
                          "numbers": numbers, "metrics": out["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def control_readings(cell, seeds, device):
    run._reference_precision()
    tr, cfg = cell.traffic, cell.config
    for seed in seeds:
        ring = system.frames(seed, tr["ring"], tr["batch"], cfg, device).cpu()
        within = tr.get("sample_within", int(np.ceil(30 * tr.get("rate_hz", 1))))
        model = reference.build(cfg, system.make_weights(cfg, seed, device), device)
        kept = {}
        for i in sorted(serve.sample_indices(seed, within, tr["sample"])):
            slot = i % len(ring)
            with precision.precision("fp8"):
                outs = [reference.serve(model, ring[slot][f:f + 1].to(device), cfg)
                        for f in range(tr["batch"])]
            kept[i] = (slot, [torch.cat(parts) for parts in zip(*outs)])
        del model
        print(json.dumps({"seed": seed, "side": "control",
                          "numbers": serve.compare(cell, seed, kept, ring, device)}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def sweep(cell, rates, seconds, device):
    fn = serve.setup(cell, 1, device)
    for rate in rates:
        cell.traffic["rate_hz"] = float(rate)
        out = serve.run_rig(cell, fn, 1, seconds, False, device)
        lat = np.asarray(out["latencies_s"]) * 1e3
        q = len(lat) // 4
        print(json.dumps({"rate_hz": rate, "ticks": len(lat), "p50_ms": float(np.median(lat)),
                          "p90_ms": float(np.percentile(lat, 90)),
                          "first_quarter_mean_ms": float(lat[:q].mean()),
                          "last_quarter_mean_ms": float(lat[-q:].mean())}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--sweep", type=float, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = spec.load(run.ROOT, args.workload)
    device = run.find_device(cell.chips)
    if args.sweep:
        sweep(cell, args.sweep, args.seconds, device)
    if args.seeds:
        program_readings(cell, args.seeds, args.seconds, device)
    if args.control:
        control_readings(cell, args.control, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
