"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It makes its weights and inputs from
``--seed`` on the card, sets the cell up (the kernels build into the
checkout's ``build/`` on a first run), warms up the shapes the cell uses,
measures for ``--seconds``, checks the timed path's outputs against the
plain reference (``benchmark/reference``), and prints one JSON line: the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiled slice of the window. It exits with 2, printing no result,
without as many CUDA cards as the cell asks for, and with 3 if JAX or
the JAX package was loaded.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "soccdpt_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


class NoChip(RuntimeError):
    pass


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def find_device(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoChip(f"the cell needs {chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the allocator's statistics exist from here on
    return device


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _reference_precision():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def execute(cell, seed: int, seconds: float, trace: bool, device, start: float,
            numbers_out: Optional[dict] = None) -> dict:
    """Set up, measure, check; the result line as a dict. ``numbers_out``
    receives every number of the comparison, compared or not."""
    import torch

    from . import check, flops, serve

    kind = cell.traffic["kind"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if kind not in ("rig", "backlog"):
        raise ValueError(f"traffic kind {kind!r} is not rig or backlog")
    fn = serve.setup(cell, seed, device)
    run = (serve.run_rig if kind == "rig" else serve.run_backlog)(
        cell, fn, seed, seconds, trace, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    _reference_precision()
    k2_requests = None
    if trace and run["slices"][0].trace is not None:
        # K2's work on the very requests the device slice recorded, from
        # their ticks served again once the window has closed
        recorded = run["recorded"]()
        ring = run["ring"]
        work = serve.k2_work(cell, fn, ring, {i % len(ring) for i in recorded})
        k2_requests = [work[i % len(ring)] for i in recorded]
    del fn
    _free(device)

    e2e = {"setup_s": run["setup_end"] - start}
    if kind == "rig":
        e2e["latency_p90_ms"] = float(np.percentile(run["latencies_s"], 90)) * 1e3
    else:
        e2e["frames_per_s"] = run["frames"] / run["window_s"]

    numbers = serve.compare(cell, seed, run["kept"], run["ring"], device)
    correct, checks = check.decide(numbers, check.limits(cell.name))
    correct = correct and run["failed"] == 0
    if numbers_out is not None:
        numbers_out.update(numbers)

    out = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        dev_slice, host_slice = (sl.trace for sl in run["slices"])
        if dev_slice is None or host_slice is None:
            raise RuntimeError("the run ended before its traced slices")
        batch = cell.traffic["batch"]
        first = run["slices"][0]
        # the wall of an iteration untraced: the profiler slows the host
        unit_wall = (first.opened_at - run["setup_end"]) / first.first if first.first else None
        reading = SimpleNamespace(trace=dev_slice, spans=run["spans"], units=dev_slice.units,
                                  batch=batch, config=cell.config, traffic=cell.traffic,
                                  flops_per_unit=lambda: flops.request_flops(cell.config, batch),
                                  k2_requests=k2_requests, unit_wall_s=unit_wall)
        from . import spec

        values = {name: read(reading) for name, read in spec.readers(cell).items()}
        out["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                          if v is not None}
        dev["busy_s"] = dev_slice.busy_s
        dev["window_s"] = dev_slice.window_s
        out["breakdown"] = {"device_ops": [[n[:96], s] for n, s in dev_slice.top_ops()],
                            "idle_gaps": [[n[:96], s] for n, s in host_slice.idle_gaps()]}
    out["device"] = dev
    out["checks"] = checks
    return out


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    from . import spec

    cell = spec.load(ROOT, args.workload)
    try:
        device = find_device(cell.chips)
    except NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device, START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}, which the port must not use", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
