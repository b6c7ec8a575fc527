"""Serving cells: the program's grid request (``make_serving_fn``) under an
open loop of camera-rig ticks (``rig``) or a closed loop over recorded
ticks (``backlog``, through ``serve_stream``).

A traffic file of either kind gives ``batch`` (frames a request),
``ring`` (distinct ticks the loop cycles through), ``sample`` (requests
compared with the reference) and ``trace`` (the first request the
profiler records, the count it records the device over, then the count
it also records the host over); ``rig`` adds ``rate_hz``, ``backlog`` ``depth`` and
``sample_within`` (the sample is drawn from the first requests).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from . import check, reference, system
from . import trace as tracing
from .reference import geometry
from .trace import span

clock = time.perf_counter


def _steady(device) -> None:
    """Set-up is over: the memory peak from here on is the window's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _wait_until(t: float) -> None:
    """Sleep until a millisecond before ``t``, then spin: a sleep alone
    wakes late by the scheduler's tick."""
    ahead = t - clock() - 1e-3
    if ahead > 0:
        time.sleep(ahead)
    while clock() < t:
        pass


def setup(cell, seed: int, device):
    """The program's serving fn of the cell's configuration, bound to
    weights drawn from ``seed``."""
    from soccdpt_torch.serving import make_serving_fn

    cfg = cell.config
    model = system.program_model(cfg, system.make_weights(cfg, seed, device), device)
    return make_serving_fn(system.model_config(cfg), model, compute_occ=True, device=device,
                           graph=device.type == "cuda")


def run_rig(cell, serve, seed: int, seconds: float, trace: bool, device) -> dict:
    """Open loop: tick ``i`` is due ``i / rate_hz`` s after the window opens
    and served when due (or when the tick before it returns, if later);
    its latency runs from its due time until its outputs are complete on
    the card, as the host sees it. Ticks are due for ``seconds``."""
    tr = cell.traffic
    sync = tracing.sync_fn(device)
    ring = system.frames(seed, tr["ring"], tr["batch"], cell.config, device)
    if device.type == "cuda":  # a capture driver's DMA buffers
        ring = ring.cpu().pin_memory()
    else:
        ring = ring.cpu()
    for i in range(2):  # the first request captures the graph
        serve(ring[i % len(ring)])
    _steady(device)
    period = 1.0 / tr["rate_hz"]
    n = int(np.ceil(seconds * tr["rate_hz"]))
    picks = sample_indices(seed, n, tr["sample"])
    slices = tracing.slices(tr["trace"], trace)
    if trace:  # a traced run goes on until its slices are done
        n = max(n, slices[1].first + slices[1].count + 1)
    kept, lat, spans = {}, [], {}
    done = torch.cuda.Event() if device.type == "cuda" else None
    setup_end = clock()
    t0 = setup_end + 0.01
    for i in range(n):
        t0 += sum(s.at(i, sync) for s in slices)  # the profiler's start and stop
        due = t0 + i * period
        _wait_until(due)
        with span(spans if slices[0].active else {}, "serve_call"):
            out = serve(ring[i % len(ring)])
        if done is not None:
            done.record()
            done.synchronize()
        lat.append(clock() - due)
        if i in picks:
            kept[i] = (i % len(ring), out)
    for s in slices:
        s.close(sync, n)
    dev = slices[0]
    return {"setup_end": setup_end, "window_s": clock() - t0, "attempted": n, "failed": 0,
            "latencies_s": lat, "kept": kept, "ring": ring, "slices": slices, "spans": spans,
            "recorded": lambda: range(dev.first, dev.first + dev.trace.units)}


def run_backlog(cell, serve, seed: int, seconds: float, trace: bool, device) -> dict:
    """Closed loop: recorded ticks, host arrays, through ``serve_stream``
    at ``depth`` until ``seconds`` have passed; every request sent is
    completed and counted, and the window closes when the last one is."""
    from soccdpt_torch.serving import serve_stream

    tr = cell.traffic
    sync = tracing.sync_fn(device)
    ring = list(system.frames(seed, tr["ring"], tr["batch"], cell.config, device).cpu())
    for _ in serve_stream(serve, (ring[i % len(ring)] for i in range(2 * tr["depth"] + 1)),
                          depth=tr["depth"]):
        pass
    _steady(device)
    picks = sample_indices(seed, tr["sample_within"], tr["sample"])
    slices = tracing.slices(tr["trace"], trace)
    kept, spans = {}, {}
    t0 = clock()
    deadline = t0 + seconds

    def source():
        i = 0
        while clock() < deadline or any(s.pending for s in slices):
            yield ring[i % len(ring)]
            i += 1

    count = 0
    last = clock()
    for j, out in enumerate(serve_stream(serve, source(), depth=tr["depth"])):
        if slices[0].active:
            spans.setdefault("serve_call", []).append(clock() - last)
        if j in picks:
            kept[j] = (j % len(ring), out)
        count += 1
        for s in slices:
            s.at(j + 1, sync)
        last = clock()
    for s in slices:
        s.close(sync, count)
    # request j + depth - 1 is in flight when output j is handed out, and
    # the slice's synchronized start completes it: the device slice
    # records the requests from first + depth - 1 on
    dev, ahead = slices[0], tr["depth"] - 1
    return {"setup_end": t0, "window_s": clock() - t0, "attempted": count, "failed": 0,
            "frames": count * tr["batch"], "kept": kept, "ring": ring, "slices": slices,
            "spans": spans,
            "recorded": lambda: range(dev.first + ahead, dev.first + ahead + dev.trace.units)}


def k2_work(cell, serve, ring, slots) -> Dict[int, tuple]:
    """K2's work in the request of each ring slot in ``slots``, served
    again: (kept rows, distinct cells), each summed over the request's
    frames, the cells counted by the reference's voxelizer on the served
    points."""
    occ = cell.config["occupancy"]
    work = {}
    for r in sorted(slots):
        cells = geometry.slots(serve(ring[r])[2], occ)
        work[r] = (int((cells >= 0).sum()),
                   sum(int(torch.unique(c[c >= 0]).numel()) for c in cells))
    return work


def sample_indices(seed: int, within: int, k: int) -> set:
    g = torch.Generator().manual_seed((int(seed) << 3) | system.SAMPLE)
    return set(torch.randperm(within, generator=g)[:k].tolist())


def compare(cell, seed: int, kept: Dict, ring, device) -> Dict[str, float]:
    """The numbers that decide ``correct``, by the worst frame of the
    sampled requests (``kept``: request index -> (ring slot, outputs)):
    each served output of the network against the reference's from the
    same frames and weights, and each stage of the geometry against the
    reference's stage run on the served output before it. The control
    passes the reference's own outputs in the program's place."""
    cfg = cell.config
    state = system.make_weights(cfg, seed, device)
    model = reference.build(cfg, state, device)
    del state
    worst = dict.fromkeys(check.SERVE_NUMBERS, 0.0)
    for _, (r, out) in sorted(kept.items()):
        frames = ring[r]
        for f in range(frames.shape[0]):
            one = frames[f:f + 1].to(device)
            want = reference.serve(model, one, cfg)
            got = [t[f:f + 1] for t in out]
            for k, v in check.serve_numbers(got, want, cfg).items():
                worst[k] = max(worst[k], v) if np.isfinite(v) else float("inf")
    return worst
