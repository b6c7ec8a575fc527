#!/usr/bin/env python3
"""Drive the PyTorch port (``soccdpt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. set-up: the card's name and power limit, the kernels built from
   ``soccdpt_torch/csrc`` with nvcc, TF32 off for the parity phases;
2. every kernel against its plain PyTorch version on the card, at the
   flagship's shapes, with the stated tolerances, and timed with CUDA
   events beside its memory/compute bound and a library yardstick;
3. the served flagship (SOccDPT V3, ``dpt_swin2_tiny_256``, full width,
   weights from a numpy seed): 1080x1920 uint8 requests at batch 1 and 2,
   with and without the occupancy grid, through ``make_serving_fn``;
   launch counts prove the path ran through the kernels; the card's f32
   outputs are held to the same requests served on the CPU; then bf16
   latency per request.

It prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
The whole record goes to ``chiprun_out/chip_smoke.json``.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
K1_F32_ATOL, K1_BF16_ATOL = 2e-5, 5e-2
K2_RTOL, K2_ONE_CELL_RTOL, K2_ATOL = 1e-5, 1e-4, 1e-5
RECORD = {}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, graph=True):
    """Mean device milliseconds per call of ``fn``, from CUDA events.

    With ``graph`` the calls are captured once into a CUDA graph and the
    graph is replayed, so the time is the card's and not the host's
    Python and launch overhead. A function with a data-dependent shape
    (a boolean-mask index syncs the host) cannot be captured and is timed
    as launched (``graph=False``). Inputs stay warm in the 50 MB L2, as
    they are in the served forward, where their producer just wrote them.
    """
    fn()
    torch.cuda.synchronize()
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run, per_run = g.replay, iters
    else:
        def run():
            for _ in range(iters):
                fn()
        per_run = iters
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * per_run)


# ---------------------------------------------------------------------------
# K1: window attention
# ---------------------------------------------------------------------------

# (Bw, H, N, d, nW or None, launches per batch-1 forward): stage 0..3
K1_FORWARD = [
    (16, 3, 256, 32, None, 1), (16, 3, 256, 32, 16, 1),
    (4, 6, 256, 32, None, 1), (4, 6, 256, 32, 4, 1),
    (1, 12, 256, 32, None, 6),
    (1, 24, 64, 32, None, 2),
]


def k1_inputs(torch, Bw, H, N, d, nW, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(Bw, H, N, d, device=dev, generator=g)
    k = torch.randn(Bw, H, N, d, device=dev, generator=g)
    q, k = q / q.norm(dim=-1, keepdim=True), k / k.norm(dim=-1, keepdim=True)
    v = torch.randn(Bw, H, N, d, device=dev, generator=g)
    scale = torch.exp(torch.randn(H, 1, 1, device=dev, generator=g))
    bias = 16.0 * torch.sigmoid(torch.randn(H, N, N, device=dev, generator=g))
    mask = None
    if nW is not None:
        mask = torch.where(torch.rand(nW, N, N, device=dev, generator=g) > 0.8, -100.0, 0.0)
    return q.to(dtype), k.to(dtype), v.to(dtype), scale, bias, mask


def k1_bytes_flops(Bw, H, N, d, nW, itemsize):
    nbytes = 4 * Bw * H * N * d * itemsize + H * N * N * 4 + (nW * N * N * 4 if nW else 0)
    return nbytes, 4 * Bw * H * N * N * d


def phase_k1(torch, F, wa):
    checks, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (Bw, H, N, d, _, _) in enumerate(K1_FORWARD[::2] + [K1_FORWARD[-1]]):
        for nW in (None, Bw):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, s, b, m = k1_inputs(torch, Bw, H, N, d, nW, dtype, seed=i)
                got = wa.window_attention(q, k, v, s, b, m)
                torch.cuda.synchronize()
                want = wa.window_attention_plain(q, k, v, s, b, m)
                err = float((got.float() - want.float()).abs().max())
                name = str(dtype).split(".")[-1]
                tol = K1_F32_ATOL if dtype == torch.float32 else K1_BF16_ATOL
                checks.append({"shape": [Bw, H, N, d], "nW": nW, "dtype": name,
                               "max_abs_err": err, "tol": tol})
                worst[name] = max(worst[name], err)
                log(f"K1 {Bw}x{H}x{N}x{d} mask={nW} {name}: max|err| {err:.3g} (tol {tol})")
                if not err <= tol:
                    fail(f"K1 disagrees with its plain version at {Bw}x{H}x{N}x{d} {name}")

    # one batch-1 bf16 forward's 12 launches: kernel, plain, library
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
    per_shape = []
    for Bw, H, N, d, nW, count in K1_FORWARD:
        q, k, v, s, b, m = k1_inputs(torch, Bw, H, N, d, nW, torch.bfloat16, seed=7)
        # library yardstick: SDPA on tau*q with bias+mask folded beforehand
        qs = (q.float() * s).to(q.dtype)
        am = b[None] if m is None else b[None] + m[:, None]
        am = am.to(q.dtype)
        t = {
            "ms": cuda_ms(torch, lambda: wa.window_attention(q, k, v, s, b, m)),
            "plain_ms": cuda_ms(torch, lambda: wa.window_attention_plain(q, k, v, s, b, m)),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=am, scale=1.0)),
        }
        nbytes, flops = k1_bytes_flops(Bw, H, N, d, nW, 2)
        per_shape.append({"shape": [Bw, H, N, d], "nW": nW, "count": count, **t,
                          "bytes": nbytes, "flops": flops})
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += t[key] * count
        tot["bytes"] += nbytes * count
        tot["flops"] += flops * count
        log(f"K1 time {Bw}x{H}x{N}x{d} mask={nW} bf16 x{count}: kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms")
    byte_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    flop_ms = tot["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
    RECORD["k1"] = {"checks": checks, "per_shape": per_shape, "forward": tot}
    return {
        "name": "window_attention",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/window_attention.cu",
        "replaces": "soccdpt_tpu/ops/window_attention.py:218",
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "tolerance": {"float32": K1_F32_ATOL, "bfloat16": K1_BF16_ATOL},
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "timed": "the 12 launches of one bf16 batch-1 forward, summed",
    }


# ---------------------------------------------------------------------------
# K2: segment sum
# ---------------------------------------------------------------------------


def k2_bytes(lin, num_slots, C):
    kept = int(((lin >= 0) & (lin < num_slots)).sum())
    return lin.numel() * 4 + kept * C * 4 + num_slots * C * 4


def phase_k2(torch, ss, occ_problem):
    dev = "cuda"
    n_frame, cells, C, B = 1920 * 1080, 256 * 256 * 32, 3, 2
    g = torch.Generator(device=dev).manual_seed(3)
    S = B * cells
    lin = (torch.randint(0, cells, (B, n_frame), device=dev, generator=g, dtype=torch.int32)
           + torch.arange(B, device=dev, dtype=torch.int32)[:, None] * cells).reshape(-1)
    vals = torch.rand(B * n_frame, C, device=dev, generator=g)
    pick = torch.randint(0, B * n_frame, (60_000,), device=dev, generator=g)
    vals[pick[:20_000]] = float("nan")  # NaN rows, dropped as geometry drops them
    lin[pick[:20_000]] = -1
    lin[pick[20_000:40_000]] = S + torch.randint(0, 1000, (20_000,), device=dev, generator=g,
                                                 dtype=torch.int32)
    lin[pick[40_000:]] = -torch.randint(1, 1000, (20_000,), device=dev, generator=g,
                                        dtype=torch.int32)
    cases = [("flagship B=2, NaN/OOB/negative rows", lin, vals, S, K2_RTOL)]
    ones = torch.ones(n_frame, C, device=dev)
    cases.append(("all rows in one cell", torch.full((n_frame,), 7, device=dev,
                                                      dtype=torch.int32), ones, cells,
                  K2_ONE_CELL_RTOL))
    cases.append(("all rows dropped", torch.full((n_frame,), cells, device=dev,
                                                 dtype=torch.int32), ones, cells, K2_RTOL))
    cases.append(("N=0", torch.zeros(0, device=dev, dtype=torch.int32),
                  torch.zeros(0, C, device=dev), cells, K2_RTOL))
    worst, checks = 0.0, []
    for name, l, v, s, rtol in cases:
        got = ss.segment_sum(l, v, s)
        torch.cuda.synchronize()
        want = ss.segment_sum_plain(l, v, s)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= K2_ATOL + rtol * want.abs()).all())
        checks.append({"case": name, "max_abs_err": err, "rtol": rtol, "atol": K2_ATOL})
        worst = max(worst, err)
        log(f"K2 {name}: max|err| {err:.3g} (rtol {rtol}, atol {K2_ATOL})")
        if not ok:
            fail(f"K2 disagrees with its plain version: {name}")

    # timing on the served batch-1 frame's own keys and values
    l, v, s = occ_problem
    keep = (l >= 0) & (l < s)
    lk, vk = l[keep].long(), v[keep]
    acc = torch.zeros(s, v.shape[1], device=dev)
    t = {
        "ms": cuda_ms(torch, lambda: ss.segment_sum(l, v, s)),
        "plain_ms": cuda_ms(torch, lambda: ss.segment_sum_plain(l, v, s), graph=False),
        "library_ms": cuda_ms(torch, lambda: acc.index_add_(0, lk, vk)),
    }
    nbytes = k2_bytes(l, s, v.shape[1])
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = int(keep.sum()) * v.shape[1] / PEAK_FLOPS["float32"] * 1e3
    log(f"K2 time, served frame ({l.numel()} rows, {int(keep.sum())} kept, {s} cells): "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, index_add_ "
        f"{t['library_ms']:.4f} ms, bound {max(byte_ms, flop_ms):.4f} ms")
    RECORD["k2"] = {"checks": checks, "timing": {**t, "rows": l.numel(),
                                                 "kept": int(keep.sum()), "bytes": nbytes}}
    return {
        "name": "segment_sum",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/segment_sum.cu",
        "replaces": "soccdpt_tpu/ops/sorted_segment_sum.py:151",
        "max_abs_err": worst,
        "tolerance": {"rtol": K2_RTOL, "rtol_one_cell": K2_ONE_CELL_RTOL, "atol": K2_ATOL},
        **t,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "timed": "one served 1080p frame's keys into the 256x256x32x3 grid",
    }


# ---------------------------------------------------------------------------
# the served flagship
# ---------------------------------------------------------------------------


def frames_u8(torch, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (B, 1080, 1920, 3), device="cuda", generator=g,
                         dtype=torch.uint8)


def calibrated(cfg, points):
    """pc_scale/pc_shift that map this model's point cloud into the grid,
    as the JAX package's cli/train_occupancy.py --calibrate_grid does; the
    published constants fit the reference's trained depth scale, not
    random weights, and would leave the grid empty."""
    pts = points.reshape(-1, 3).float().cpu().numpy()
    pts = pts[np.isfinite(pts).all(-1) & (np.abs(pts).max(-1) < 9e7)][::16]
    shape_m = np.asarray(cfg.occupancy.occupancy_shape, np.float32)
    lo, hi = np.percentile(pts, 2.0, axis=0), np.percentile(pts, 98.0, axis=0)
    pc_scale = 0.9 * shape_m / np.maximum(hi - lo, 1e-6)
    pc_shift = 0.05 * shape_m - lo * pc_scale
    occ = dataclasses.replace(cfg.occupancy, pc_scale=tuple(map(float, pc_scale)),
                              pc_shift=tuple(map(float, pc_shift)))
    return dataclasses.replace(cfg, occupancy=occ)


def phase_serving(torch, card):
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.models.soccdpt import SOccDPT_V3, build_model
    from soccdpt_torch.ops.geometry import occupancy_slots, rotate_points
    from soccdpt_torch.serving import make_serving_fn

    cfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3)
    t0 = time.perf_counter()
    base = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        # keep inv_depth in a band where depth = 1/inv stays well conditioned
        base.depth_net.head.conv3.weight.mul_(0.01)
        base.depth_net.head.conv3.bias.fill_(0.3)
    probe = make_serving_fn(cfg, base)(frames_u8(torch, 1, 100))
    cfg32 = calibrated(cfg, probe[2])
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")

    def same_weights(c):
        m = SOccDPT_V3(c)
        m.load_state_dict(base.state_dict())
        return m

    model32, model16 = same_weights(cfg32), same_weights(cfg16)
    del base, probe
    log(f"model built and calibrated in {time.perf_counter() - t0:.1f} s; "
        f"pc_scale {cfg32.occupancy.pc_scale} pc_shift {cfg32.occupancy.pc_shift}")

    # --- the main path: bf16 serving, counts from 0 -------------------------
    serve = {occ: make_serving_fn(cfg16, model16, compute_occ=occ) for occ in (False, True)}
    runs = [(1, False), (1, True), (2, False), (2, True)]
    requests = 2
    wa.window_attention.launches = 0
    ss.segment_sum.launches = 0
    outs = {}
    for B, occ in runs:
        for r in range(requests):
            outs[(B, occ)] = serve[occ](frames_u8(torch, B, 10 * B + r))
    torch.cuda.synchronize()
    launches = {"window_attention": wa.window_attention.launches,
                "segment_sum": ss.segment_sum.launches}
    forwards = requests * len(runs)
    occ_requests = requests * sum(occ for _, occ in runs)
    log(f"main path: {forwards} requests, launches {launches}")
    if launches["window_attention"] != 12 * forwards:
        fail(f"K1 ran {launches['window_attention']} times, expected 12 x {forwards}")
    if launches["segment_sum"] != occ_requests:
        fail(f"K2 ran {launches['segment_sum']} times, expected {occ_requests}")
    for (B, occ), (inv, seg, pts, grid) in outs.items():
        shapes = [tuple(inv.shape), tuple(seg.shape), tuple(pts.shape)]
        if shapes != [(B, 1080, 1920), (B, 3, 1080, 1920), (B, 1080, 1920, 3)]:
            fail(f"served shapes {shapes} at batch {B}")
        if not all(bool(torch.isfinite(t).all()) for t in (inv, seg, pts)):
            fail(f"non-finite served output at batch {B}, occ={occ}")
        if occ:
            if tuple(grid.shape) != (B, 256, 256, 32, 3) or not bool(torch.isfinite(grid).all()):
                fail(f"bad grid {tuple(grid.shape)} at batch {B}")
            if not float(grid.sum()) > 0:
                fail(f"empty occupancy grid at batch {B}")
        elif grid is not None:
            fail("a grid came back with compute_occ=False")

    # --- parity: the card's f32 outputs against the CPU's --------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = frames_u8(torch, 2, 7)
    got = make_serving_fn(cfg32, model32, compute_occ=True)(frames)
    cpu_model = copy.deepcopy(model32).cpu()
    t0 = time.perf_counter()
    want = make_serving_fn(cfg32, cpu_model, compute_occ=True, device="cpu")(frames.cpu())
    log(f"CPU reference served in {time.perf_counter() - t0:.1f} s")
    parity = {}
    for name, g, w, atol in zip(("inv_depth", "seg", "points"), got, want, (1e-4, 1e-4, 5e-3)):
        err = float((g.cpu() - w).abs().max())
        parity[name] = {"max_abs_err": err, "atol": atol}
        log(f"served f32 {name}: card vs CPU max|err| {err:.3g} (atol {atol})")
        if not err <= atol:
            fail(f"served {name} differs from the CPU run by {err}")
    mass = float(want[3].sum())
    mism = float((got[3].cpu() - want[3]).abs().sum()) / max(mass, 1e-30)
    parity["grid"] = {"mismatched_mass_share": mism, "limit": 0.01, "mass": mass}
    log(f"served f32 grid: mismatched mass {mism:.3g} of {mass:.1f} (limit 0.01)")
    if not (mass > 0 and mism < 0.01):
        fail("served grid differs from the CPU run")
    inv_lo = float(got[0].min())
    log(f"served inv_depth min {inv_lo:.3f}")
    RECORD["parity"] = parity
    del cpu_model, want
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # --- latency per bf16 request (host clock ending in synchronize) --------
    latency = {}
    for B, occ in runs:
        fn = serve[occ]
        frames = [frames_u8(torch, B, 1000 + i) for i in range(4)]
        for i in range(3):
            fn(frames[i % 4])
        torch.cuda.synchronize()
        times = []
        for i in range(20):
            t0 = time.perf_counter()
            fn(frames[i % 4])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[f"b{B}_occ{int(occ)}"] = {"mean_ms": float(np.mean(times)),
                                          "median_ms": float(np.median(times)),
                                          "min_ms": float(np.min(times))}
        log(f"served bf16 batch {B} occ={occ}: {np.mean(times):.3f} ms/request mean, "
            f"{np.median(times):.3f} median ({card})")
    RECORD["latency_bf16"] = latency

    # --- device time by kernel for one bf16 batch-1 occupancy request -------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = serve[True]
    frame = frames_u8(torch, 1, 2000)
    fn(frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn(frame)
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy, memset), so nothing is
    # counted twice through the operator that launched it
    rows = [(ev.key, ev.device_time_total / 5.0, ev.count / 5.0)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_us = sum(us for _, us, _ in rows) * 5.0
    RECORD["served_kernel_device_ms_b1_occ"] = {
        name: sum(us for k, us, _ in rows if f"{name}_kernel" in k) / 1e3
        for name in ("window_attention", "segment_sum")}
    log(f"in the served request: {RECORD['served_kernel_device_ms_b1_occ']} ms of device time")
    RECORD["profile_b1_occ_us_per_request"] = [
        {"name": k[:120], "device_us": us, "calls": c} for k, us, c in rows[:40]]
    wall = latency["b1_occ1"]["median_ms"]
    RECORD["device_ms_per_request_b1_occ"] = device_us / 5.0 / 1e3
    log(f"profile (bf16, batch 1, occ): {device_us / 5.0 / 1e3:.3f} ms of device time per "
        f"request against {wall:.3f} ms median wall time: busy share "
        f"{device_us / 5.0 / 1e3 / wall:.3f}; top device time per request:")
    for k, us, c in rows[:12]:
        log(f"  {us:9.1f} us  x{c:5.1f}  {k[:90]}")

    # the served batch-1 frame's own segment-sum problem for K2's timing
    with torch.inference_mode():
        inv, seg, pts, _ = fn(frame)
        occ_cfg = cfg32.occupancy
        p = pts.reshape(1, -1, 3)
        p = p * torch.tensor(occ_cfg.pc_scale, device="cuda") + torch.tensor(
            occ_cfg.pc_shift, device="cuda")
        p = rotate_points(p, occ_cfg.correction_angle)
        sem = seg.reshape(1, 3, -1).transpose(1, 2)
        problem = occupancy_slots(p, sem, occ_cfg, 3)
    return launches, problem


def main():
    if not (HERE / "soccdpt_torch").is_dir():
        fail("soccdpt_torch/ is not beside this script: run it from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(HERE))
    import torch.nn.functional as F

    from soccdpt_torch.kernels import _build
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {seconds}")
    for name in ("window_attention", "segment_sum"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 is off for the parity phases (cudnn.allow_tf32 = matmul.allow_tf32 = False)")

    k1 = phase_k1(torch, F, wa)
    launches, problem = phase_serving(torch, card)
    k2 = phase_k2(torch, ss, problem)
    k1["launches"] = launches["window_attention"]
    k2["launches"] = launches["segment_sum"]
    for k in (k1, k2):
        k["served_device_ms"] = RECORD["served_kernel_device_ms_b1_occ"][k["name"]]
    kernels = [k1, k2]
    RECORD.update({"device": kind, "nvidia_smi": card, "kernels": kernels,
                   "build_seconds": seconds, "seconds": time.perf_counter() - t_start})
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
