#!/usr/bin/env python3
"""Host cost of the attention kernels' dispatch, and eager and graph walls,
for one checkout of the PyTorch port; run it on two checkouts in one call
to compare them.

    python scripts/torch_dispatch_ab.py --tree <checkout> [--out result.json]

On one CUDA card, with the port imported from ``<checkout>`` (its kernels
built there with nvcc):

* a bare call's host microseconds: ``window_attention`` (K1, bf16, the
  flagship's stage-2 shape (1, 12, 256, 32)) and ``global_attention`` (K6,
  bf16, the hybrid's ViT-B shape (1, 12, 577, 64), no bias), each beside
  its module's ``_launch`` called directly. The host times ``CALLS`` calls
  in a row and the card's queue stays below its depth, so the time is the
  host's; the median of ``ROUNDS`` rounds;
* the wall of a bf16 batch-1 forward (``model(x, return_raw=True)``,
  synchronized, median of ``FORWARDS``) and of a served 1080p request
  without the grid, eagerly and through the serving fn's CUDA graph, for
  SOccDPT V3 on ``dpt_swin2_tiny_256`` (K1 12 times a forward) and on
  ``dpt_beit_large_512`` (K6 24 times), weights from numpy seed 0.

Prints one JSON object (the card's ``nvidia-smi`` name and power limit
with it). To compare a parent and a change, run parent, change, change,
parent in one session: host times move between sessions.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

CALLS, ROUNDS, FORWARDS = 400, 7, 40


def host_us(torch, fn):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        rounds.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def wall_ms(torch, fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(FORWARDS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dispatch_us(torch):
    """The bare calls' host µs: ``k1_call_us`` / ``k6_call_us`` through the
    public functions, ``k1_launch_us`` / ``k6_launch_us`` through ``_launch``."""
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    out = {}
    with torch.no_grad():
        q, k, v = (torch.randn(1, 12, 256, 32, device="cuda", generator=g).to(bf)
                   for _ in range(3))
        tau = torch.full((12, 1, 1), 10.0, device="cuda", dtype=bf)
        bias = torch.rand(12, 256, 256, device="cuda", generator=g)
        out["k1_call_us"] = host_us(torch, lambda: wa.window_attention(q, k, v, tau, bias))
        out["k1_launch_us"] = host_us(torch, lambda: wa._launch(q, k, v, tau, bias, None))
        q, k, v = (torch.randn(1, 12, 577, 64, device="cuda", generator=g).to(bf)
                   for _ in range(3))
        out["k6_call_us"] = host_us(torch, lambda: ga.global_attention(q, k, v, None, 0.125))
        out["k6_launch_us"] = host_us(torch, lambda: ga._launch(q, k, v, None, 0.125)[0])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", required=True, help="a checkout of the repo")
    parser.add_argument("--out", default=None, help="also write the JSON object here")
    args = parser.parse_args(argv)
    sys.path.insert(0, args.tree)
    import torch

    import soccdpt_torch
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.kernels import _build
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.serving import make_serving_fn

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"tree": args.tree, "package": soccdpt_torch.__file__, "card": card,
              **dispatch_us(torch)}
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, model_type in (("swin", "dpt_swin2_tiny_256"), ("beit", "dpt_beit_large_512")):
        cfg = ModelConfig(model_type=model_type, compute_dtype="bfloat16")
        model = build_model(cfg, device="cuda", seed=0)
        net_w, net_h = cfg.net_size
        x = torch.randn(1, 3, net_h, net_w, device="cuda", generator=g)
        frames = torch.randint(0, 256, (1, 1080, 1920, 3), device="cuda", generator=g,
                               dtype=torch.uint8)
        with torch.no_grad():
            result[f"{label}_forward_eager_ms"] = wall_ms(
                torch, lambda: model(x, return_raw=True))
        eager = make_serving_fn(cfg, model, graph=False)
        graphed = make_serving_fn(cfg, model)
        result[f"{label}_served_eager_ms"] = wall_ms(torch, lambda: eager(frames))
        result[f"{label}_served_graph_ms"] = wall_ms(torch, lambda: graphed(frames))
        del model, eager, graphed
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
