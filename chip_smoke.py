#!/usr/bin/env python3
"""Drive the PyTorch port (``soccdpt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. set-up: the card's name and power limit, the kernels built from
   ``soccdpt_torch/csrc`` with nvcc (one process per source, all at once),
   TF32 off for the parity phases;
2. every kernel against its plain PyTorch version on the card, at the
   shapes its served path gives it, with the stated tolerances, and timed
   with CUDA events beside its memory/compute bound and a library
   yardstick: K1 window attention, K2 segment sum, K6 global attention,
   K7 its backward;
3. the decoder kernels K3 (fused residual conv unit), K4 (fusion-block
   tail) and K5 (depth-head tail), standalone ops on no path of the
   system, as in the JAX package: against their plain versions at the
   flagship's and BEiT-large's decoder shapes (batch 1 and 2) and at
   ragged ones, in f32 and bf16 (K3 and K4 run bf16 on the tensor cores,
   and ``cuobjdump -sass`` of their libraries must show ``HGMMA``); then on
   the live flagship decoder, whose modules' inputs and outputs forward
   hooks capture during one served request, each kernel held to the module
   it replaces on that module's weights (the launch counts set to 0 just
   before and read just after); the CUDA launches of one call of each op,
   from a profile; K5's gradient; times beside the plain version, the
   served modules' own cuDNN chain and the bound; K3's launch plan against
   its neighbouring plans at both decoders' map sizes;
4. four served configurations at full width and depth, weights from a
   numpy seed, 1080x1920 uint8 requests at batch 1 and 2, with and
   without the occupancy grid, through ``make_serving_fn``: SOccDPT V3 on
   the flagship ``dpt_swin2_tiny_256`` (K1, K2) and on
   ``dpt_beit_large_512`` (K6, K2), and SOccDPT V1 (two trunks, K1 24
   times a request) and V2 (one trunk, two heads) on the flagship. For
   each, the launch counts are set to 0 just before its requests and
   read just after, and prove the path ran through its kernels; the
   card's f32 outputs are held to the same request served on the CPU;
   then bf16 latency per request and a device-time profile. The BEiT path
   also serves one request through the real 3-D occupancy head and one
   with its folded biases stored in bf16;
5. training, through ``soccdpt_torch.train.trainer.Trainer`` on a fixed
   synthetic batch with GT at 1080x1920: ``dpt_beit_large_512`` at full
   width and depth, batch 2 (K6 forward and K7 backward, 24 launches each
   per step), and the flagship at batch 3 as V3 (K1 twelve times forward
   per step), V1 (24 times; its seg decoder has BatchNorm) and V2. For
   each: one f32 loss and its gradients on the card against the CPU's
   through the plain versions; five bf16 steps whose loss must stay
   finite and fall, with the launch counts read around every step; the
   median step time and a device-time profile of one step.

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
K6_F32_TOL, K6_BF16_TOL = 2e-5, 2e-2  # atol = rtol, as tests/test_global_attention.py
# K7, atol = rtol: that file's bound on the Pallas backward in f32; in bf16
# the forward's, which covers the rounding of dq, dk, dv and of the output
# delta is taken from (kernels/global_attention.py, "Rounding, backward")
K7_F32_TOL, K7_BF16_TOL = 3e-5, 2e-2
RECORD = {}
PHASE_SECONDS = {}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


class phase:
    """Time a phase and print its seconds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        PHASE_SECONDS[self.name] = time.perf_counter() - self.t0
        log(f"[phase {self.name}: {PHASE_SECONDS[self.name]:.1f} s]")


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
# K6: global attention
# ---------------------------------------------------------------------------

# (B, H, T, d): beitl16_512 at batch 1, the 384-px base models at batch 2,
# and the test config's ragged tiles
K6_CHECKS = [(1, 16, 1025, 64), (2, 12, 577, 64), (2, 2, 65, 16)]
# timed: (label, (B, H, T, d), bias dtype name or None), 24 launches per bf16 forward
K6_FORWARDS = [
    ("beitl16_512, f32 bias", (1, 16, 1025, 64), "float32"),
    ("beitl16_512, bf16 bias", (1, 16, 1025, 64), "bfloat16"),
    ("vitl16_384, no bias", (1, 16, 577, 64), None),
    ("beitl16_512 at batch 2, f32 bias", (2, 16, 1025, 64), "float32"),
]
K6_LAUNCHES_PER_FORWARD = 24


def k6_inputs(torch, B, H, T, d, bias_dtype, dtype, seed, n_bias=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    biases = [None] * n_bias
    if bias_dtype is not None:  # randn: a kernel that dropped the bias fails
        biases = [torch.randn(H, T, T, device="cuda", generator=g).to(bias_dtype)
                  for _ in range(n_bias)]
    return q, k, v, biases


def k6_bytes_flops(B, H, T, d, itemsize, bias_itemsize):
    return 4 * B * H * T * d * itemsize + H * T * T * bias_itemsize, 4 * B * H * T * T * d


def phase_k6(torch, F, ga):
    checks, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, H, T, d) in enumerate(K6_CHECKS):
        for bias_dtype in (torch.float32, torch.bfloat16, None):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, (bias,) = k6_inputs(torch, B, H, T, d, bias_dtype, dtype, seed=i)
                scale = d ** -0.5
                got = ga.global_attention(q, k, v, bias, scale)
                torch.cuda.synchronize()
                want = ga.global_attention_plain(q, k, v, bias, scale)
                name = str(dtype).split(".")[-1]
                bname = str(bias_dtype).split(".")[-1]
                tol = K6_F32_TOL if dtype == torch.float32 else K6_BF16_TOL
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                ok = bool(torch.isfinite(got).all()) and bool(
                    (diff <= tol + tol * want.float().abs()).all())
                checks.append({"shape": [B, H, T, d], "bias": bname, "dtype": name,
                               "max_abs_err": err, "atol": tol, "rtol": tol})
                worst[name] = max(worst[name], err)
                log(f"K6 {B}x{H}x{T}x{d} bias={bname} {name}: max|err| {err:.3g} "
                    f"(atol = rtol = {tol})")
                if not ok:
                    fail(f"K6 disagrees with its plain version at {B}x{H}x{T}x{d} "
                         f"bias={bname} {name}")

    # One bf16 batch-1 forward is 24 launches, each block with a bias of its
    # own, so no launch finds its bias in L2: three distinct biases in turn.
    forwards = []
    for label, (B, H, T, d), bias_name in K6_FORWARDS:
        bias_dtype = getattr(torch, bias_name) if bias_name else None
        q, k, v, biases = k6_inputs(torch, B, H, T, d, bias_dtype, torch.bfloat16, seed=9,
                                    n_bias=3)
        scale = d ** -0.5
        # the library yardstick needs the mask in q's dtype, cast beforehand
        masks = [None if b is None else b.to(q.dtype)[None] for b in biases]
        per_forward = K6_LAUNCHES_PER_FORWARD / len(biases)
        t = {
            "ms": per_forward * cuda_ms(torch, lambda: [
                ga.global_attention(q, k, v, b, scale) for b in biases]),
            "plain_ms": per_forward * cuda_ms(torch, lambda: [
                ga.global_attention_plain(q, k, v, b, scale) for b in biases], iters=5),
            "library_ms": per_forward * cuda_ms(torch, lambda: [
                F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)
                for m in masks]),
        }
        nbytes, flops = k6_bytes_flops(B, H, T, d, 2, biases[0].element_size() if bias_name else 0)
        byte_ms = K6_LAUNCHES_PER_FORWARD * nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = K6_LAUNCHES_PER_FORWARD * flops / PEAK_FLOPS["bfloat16"] * 1e3
        forwards.append({"forward": label, "shape": [B, H, T, d], "bias": bias_name,
                         **t,
                         "bytes": K6_LAUNCHES_PER_FORWARD * nbytes,
                         "flops": K6_LAUNCHES_PER_FORWARD * flops,
                         "bound_ms": max(byte_ms, flop_ms),
                         "bound_by": "bytes" if byte_ms >= flop_ms else "operations"})
        log(f"K6 time, 24 launches, bf16, {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
            f"{max(byte_ms, flop_ms):.4f} ms ({forwards[-1]['bound_by']})")
    RECORD["k6"] = {"checks": checks, "forwards": forwards}
    main = forwards[0]
    return {
        "name": "global_attention",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/global_attention.cu",
        "replaces": "soccdpt_tpu/ops/global_attention.py:85",
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "tolerance": {"float32": K6_F32_TOL, "bfloat16": K6_BF16_TOL},
        **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "timed": "the 24 launches of one bf16 batch-1 forward of beitl16_512, f32 bias",
        "other_forwards": forwards[1:],
    }


# ---------------------------------------------------------------------------
# K7: global attention, backward
# ---------------------------------------------------------------------------

# (B, H, T, d, with a bias): beitl16_512 at batch 1 and 2 (dbias sums the
# images), vitl16_384 without a bias, and the test config's ragged tiles
K7_CHECKS = [(1, 16, 1025, 64, True), (2, 16, 1025, 64, True), (1, 16, 577, 64, False),
             (2, 2, 65, 16, True)]
K7_BACKWARDS = [
    ("beitl16_512, f32 bias", (1, 16, 1025, 64), "float32"),
    ("vitl16_384, no bias", (1, 16, 577, 64), None),
    ("beitl16_512 at batch 2, f32 bias", (2, 16, 1025, 64), "float32"),
]


def k7_bytes_flops(B, H, T, d, itemsize, bias_itemsize):
    """q, k, v, g read and dq, dk, dv written once; the bias read and dbias
    (f32) written once; five products."""
    nbytes = 7 * B * H * T * d * itemsize
    if bias_itemsize:
        nbytes += H * T * T * (bias_itemsize + 4)
    return nbytes, 10 * B * H * T * T * d


def phase_k7(torch, F, ga):
    checks, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, H, T, d, with_bias) in enumerate(K7_CHECKS):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, (bias,) = k6_inputs(torch, B, H, T, d,
                                         torch.float32 if with_bias else None, dtype, seed=20 + i)
            g = torch.randn(B, H, T, d, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(40 + i)).to(dtype)
            scale = d ** -0.5
            got = ga.global_attention_backward(q, k, v, bias, scale, g)
            torch.cuda.synchronize()
            want = ga.global_attention_backward_plain(q, k, v, bias, scale, g)
            name = str(dtype).split(".")[-1]
            tol = K7_F32_TOL if dtype == torch.float32 else K7_BF16_TOL
            errs = {}
            for part, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
                if w is None:
                    if a is not None:
                        fail(f"K7 gave a {part} where there is no bias")
                    continue
                diff = (a.float() - w.float()).abs()
                errs[part] = float(diff.max())
                if not (bool(torch.isfinite(a).all())
                        and bool((diff <= tol + tol * w.float().abs()).all())):
                    fail(f"K7 {part} disagrees with its plain version at {B}x{H}x{T}x{d} "
                         f"bias={with_bias} {name}: max|err| {errs[part]:.3g}")
            checks.append({"shape": [B, H, T, d], "bias": with_bias, "dtype": name,
                           "max_abs_err": errs, "atol": tol, "rtol": tol})
            worst[name] = max(worst[name], *errs.values())
            log(f"K7 {B}x{H}x{T}x{d} bias={with_bias} {name}: max|err| "
                + ", ".join(f"{part} {e:.3g}" for part, e in errs.items())
                + f" (atol = rtol = {tol})")

    # One bf16 batch-1 backward is 24 launches, each block with a bias of its
    # own: three distinct biases in turn, as for K6. K7 alone is timed: the
    # output and the row statistics come from a forward made beforehand.
    backwards = []
    for label, (B, H, T, d), bias_name in K7_BACKWARDS:
        bias_dtype = getattr(torch, bias_name) if bias_name else None
        q, k, v, biases = k6_inputs(torch, B, H, T, d, bias_dtype, torch.bfloat16, seed=29,
                                    n_bias=3)
        g = torch.randn(B, H, T, d, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(49)).bfloat16()
        scale = d ** -0.5
        fwd = [ga.global_attention_with_lse(q, k, v, b, scale) for b in biases]
        per_backward = K6_LAUNCHES_PER_FORWARD / len(biases)
        # the library yardstick: autograd through SDPA, mask cast beforehand
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        masks = [None if b is None else b.to(q.dtype)[None].requires_grad_() for b in biases]
        outs = [F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m, scale=scale)
                for m in masks]

        def library():
            for o, m in zip(outs, masks):
                torch.autograd.grad(o, (ql, kl, vl) if m is None else (ql, kl, vl, m), g,
                                    retain_graph=True)

        t = {
            "ms": per_backward * cuda_ms(torch, lambda: [
                ga.global_attention_backward(q, k, v, b, scale, g, out=o, lse=l)
                for b, (o, l) in zip(biases, fwd)], iters=5),
            "plain_ms": per_backward * cuda_ms(torch, lambda: [
                ga.global_attention_backward_plain(q, k, v, b, scale, g) for b in biases],
                iters=3),
            # autograd's engine is not captured into a graph; at milliseconds a
            # call the host's launch overhead does not show
            "library_ms": per_backward * cuda_ms(torch, library, iters=5, graph=False),
        }
        nbytes, flops = k7_bytes_flops(B, H, T, d, 2, biases[0].element_size() if bias_name else 0)
        byte_ms = K6_LAUNCHES_PER_FORWARD * nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = K6_LAUNCHES_PER_FORWARD * flops / PEAK_FLOPS["bfloat16"] * 1e3
        backwards.append({"backward": label, "shape": [B, H, T, d], "bias": bias_name, **t,
                          "bytes": K6_LAUNCHES_PER_FORWARD * nbytes,
                          "flops": K6_LAUNCHES_PER_FORWARD * flops,
                          "bound_ms": max(byte_ms, flop_ms),
                          "bound_by": "bytes" if byte_ms >= flop_ms else "operations"})
        log(f"K7 time, 24 launches, bf16, {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa backward {t['library_ms']:.4f} ms, bound "
            f"{max(byte_ms, flop_ms):.4f} ms ({backwards[-1]['bound_by']})")
        del fwd, outs, masks
    RECORD["k7"] = {"checks": checks, "backwards": backwards}
    main = backwards[0]
    return {
        "name": "global_attention_backward",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/global_attention_bwd.cu",
        "replaces": "soccdpt_tpu/ops/global_attention.py:315",
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "tolerance": {"float32": K7_F32_TOL, "bfloat16": K7_BF16_TOL},
        **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "timed": "the 24 launches of one bf16 batch-1 backward of beitl16_512, f32 bias",
        "other_backwards": backwards[1:],
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
# K3, K4, K5: the decoder convolutions, standalone ops as in the JAX package
# ---------------------------------------------------------------------------

# f32 (TF32 off): the bounds tests/test_fused_{rcu,fusion,head}.py hold the
# Pallas kernels to, atol with rtol = atol for K5 as there; K3 and K4 take
# rtol = atol as well on the live decoder, whose activations reach tens.
# bf16: the kernel rounds each intermediate once where the plain version
# and the served modules round twice (a conv's output, then the residual
# sum): one bf16 step (2^-8) of the intermediate, which the next conv
# carries on. An output where the conv's output and the residual cancel is
# small while that step is not, so atol is the bound times the tensor's
# largest value, and rtol the bound.
DECODER_F32_TOL = {"fused_rcu": 2e-4, "fused_rcu_tail": 3e-4, "fused_head_tail": 2e-5}
DECODER_BF16_TOL = 2e-2
# (B, H, W, C): the fusion maps of the flagship (8..64) and BEiT-large
# (16..128) at batch 1 and 2, and ragged small maps
K3_CHECKS = ([(B, s, s, 256) for B in (1, 2) for s in (8, 16, 32, 64, 128)]
             + [(1, 7, 9, 16), (2, 5, 13, 64)])
K4_CHECKS = [(B, s, s, 256) for B in (1, 2) for s in (64, 128)] + [(1, 7, 9, 16), (2, 5, 13, 64)]
# (B, H, W, Ci, Cm): the depth head after conv1, flagship and BEiT-large
K5_CHECKS = ([(B, s, s, 128, 32) for B in (1, 2) for s in (128, 256)]
             + [(1, 7, 9, 16, 8), (2, 5, 13, 64, 36)])
# BEiT-large's decoder at batch 1, timed beside the flagship's live one:
# (H, RCUs at that size)
BEIT_RCUS = [(16, 1), (32, 2), (64, 2), (128, 2)]


def decoder_inputs(torch, shape, seed, head=False):
    """Random NHWC activations and HWIO weights, scaled so that each conv
    keeps unit variance (the JAX tests' 0.05 at C <= 64, 0.02 at C = 256)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    if head:
        B, H, W, Ci, Cm = shape
        # b3 small, so that the final ReLU keeps about half the outputs
        return [rnd(B, H, W, Ci), rnd(3, 3, Ci, Cm, scale=(9 * Ci) ** -0.5),
                rnd(Cm, scale=0.1), rnd(Cm, scale=Cm ** -0.5), rnd(1, scale=0.1)]
    B, H, W, C = shape
    s = 0.05 if C <= 64 else 0.02
    return [rnd(B, H, W, C), rnd(3, 3, C, C, scale=s), rnd(C, scale=0.1),
            rnd(3, 3, C, C, scale=s), rnd(C, scale=0.1), rnd(C, C, scale=s), rnd(C, scale=0.1)]


def close(torch, got, want, name):
    """(max |err|, within the tolerance, atol, rtol) of ``name`` in got's
    dtype."""
    want = want.float()
    if got.dtype == torch.bfloat16:
        rtol = DECODER_BF16_TOL
        atol = rtol * float(want.abs().max())
    else:
        atol = rtol = DECODER_F32_TOL[name]
    diff = (got.float() - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok, atol, rtol


def conv_work(B, H, W, Ci, Co, taps):
    return 2 * B * H * W * Ci * Co * taps


def rcu_bytes_flops(B, H, W, C, itemsize):
    """x read and the output written once, two 3x3 weights and biases."""
    return 2 * B * H * W * C * itemsize + 2 * (9 * C * C + C) * itemsize, 2 * conv_work(
        B, H, W, C, C, 9)


def tail_bytes_flops(B, H, W, C, itemsize):
    """s read and the (B, 2H, 2W, C) output written once, the RCU's and the
    1x1 conv's weights; the RCU, the 1x1 conv at input resolution (the
    kernel's order) and the upsample's blend, 6 operations an output value."""
    n = B * H * W * C
    nbytes = (5 * n + 2 * (9 * C * C + C) + C * C + C) * itemsize
    return nbytes, 2 * conv_work(B, H, W, C, C, 9) + conv_work(B, H, W, C, C, 1) + 6 * 4 * n


def head_bytes_flops(B, H, W, Ci, Cm, itemsize):
    """x read, (B, 2H, 2W) written; the blend of x at output resolution, the
    3x3 conv, the 1x1 conv to one channel."""
    P = 4 * B * H * W
    nbytes = (B * H * W * Ci + P + 9 * Ci * Cm + 2 * Cm + 1) * itemsize
    return nbytes, 6 * P * Ci + 2 * P * 9 * Ci * Cm + 2 * P * Cm


def bound(nbytes, flops, dtype_name):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def decoder_weights(mods):
    """HWIO kernels and biases of the port's convs, through the wrappers'
    one layout conversion (``_conv.conv_weights``), detached."""
    from soccdpt_torch.kernels._conv import conv_weights

    return [t.detach() for m in mods for t in conv_weights(m)]


def live_decoder(torch, dtype):
    """One served 1080p request of the flagship V3 (seed 0) in ``dtype``,
    with forward hooks on the depth DPT's residual conv units, on
    ``refinenet1`` and on the depth head: (model, [(path, module, input,
    output)] of the RCUs, refinenet1's (tail input, output), the head's
    (input, output))."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.dpt import ResidualConvUnit
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.serving import make_serving_fn

    name = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3, compute_dtype=name)
    model = build_model(cfg, device="cuda", seed=0)
    dpt = model.depth_net
    rcus, seen = [], {}

    def keep(key):
        def hook(mod, args, out):
            seen[key] = (args[0].detach(), out.detach())
        return hook

    handles = []
    for path, mod in dpt.named_modules():
        if isinstance(mod, ResidualConvUnit):
            rcus.append((path, mod))
            handles.append(mod.register_forward_hook(keep(path)))
    handles.append(dpt.refinenet1.register_forward_hook(keep("refinenet1")))
    handles.append(dpt.head.register_forward_hook(keep("head")))
    make_serving_fn(cfg, model, compute_occ=False)(frames_u8(torch, 1, 300))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    if len(rcus) != 7:
        fail(f"the flagship's depth decoder has {len(rcus)} residual conv units, expected 7")
    tail = (seen["refinenet1.res_conv_unit2"][0], seen["refinenet1"][1])
    return model, [(p, m, *seen[p]) for p, m in rcus], tail, seen["head"]


def decoder_kernels():
    from soccdpt_torch.kernels import fused_fusion as ff
    from soccdpt_torch.kernels import fused_head as fh
    from soccdpt_torch.kernels import fused_rcu as fr

    return {"fused_rcu": (fr.fused_rcu, fr.fused_rcu_plain),
            "fused_rcu_tail": (ff.fused_rcu_tail, ff.fused_rcu_tail_plain),
            "fused_head_tail": (fh.fused_head_tail, fh.fused_head_tail_plain)}


def live_cases(torch, F, model, rcus, tail, head_io):
    """(kernel, what, its arguments, the served module's output, the
    module's own chain as a function of the input) for each live input."""
    from soccdpt_torch.models.layers import conv_nhwc
    from soccdpt_torch.ops.resize import upsample2x_hw

    block, head = model.depth_net.refinenet1, model.depth_net.head

    def head_tail(m):  # DepthHead.forward after conv1
        y = F.relu(conv_nhwc(head.conv2, upsample2x_hw(m, "bilinear", align_corners=True)))
        return F.relu(conv_nhwc(head.conv3, y))[..., 0]

    with torch.no_grad():
        mid = conv_nhwc(head.conv1, head_io[0])
    cases = [("fused_rcu", path, (x, *decoder_weights([m.conv1, m.conv2])), y, m)
             for path, m, x, y in rcus]
    rcu2 = block.res_conv_unit2
    # refinenet1 called without a skip and without a size is exactly the tail
    cases.append(("fused_rcu_tail", "refinenet1 tail",
                  (tail[0], *decoder_weights([rcu2.conv1, rcu2.conv2, block.out_conv])),
                  tail[1], block))
    cases.append(("fused_head_tail", "depth head after conv1",
                  (mid, *decoder_weights([head.conv2, head.conv3])), head_io[1][..., 0],
                  head_tail))
    return cases


def work(name, args):
    """(bytes, operations) of one call, in its working dtype."""
    x = args[0]
    if name == "fused_rcu":
        return rcu_bytes_flops(*x.shape, x.element_size())
    if name == "fused_rcu_tail":
        return tail_bytes_flops(*x.shape, x.element_size())
    return head_bytes_flops(*x.shape, args[1].shape[-1], x.element_size())


def time_calls(torch, kernels, calls, label):
    """Kernel, plain and library ms of ``calls`` [(kernel, args, library
    function of the input, count)], summed per kernel, beside the bound of
    the same work."""
    out = {}
    with torch.no_grad():
        for name, (kernel, plain) in kernels.items():
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
                   "calls": 0}
            for kname, args, library, count in calls:
                if kname != name:
                    continue
                tot["ms"] += count * cuda_ms(torch, lambda: kernel(*args))
                tot["plain_ms"] += count * cuda_ms(torch, lambda: plain(*args))
                tot["library_ms"] += count * cuda_ms(torch, lambda: library(args[0]))
                nbytes, flops = work(name, args)
                tot["bytes"] += count * nbytes
                tot["flops"] += count * flops
                tot["calls"] += count
            tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flops"], "bfloat16")
            out[name] = tot
            log(f"{name} time, {label}, bf16, {tot['calls']} call(s): kernel {tot['ms']:.4f} ms, "
                f"plain {tot['plain_ms']:.4f} ms, cuDNN chain {tot['library_ms']:.4f} ms, bound "
                f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}: {tot['flops'] / 1e9:.2f} GFLOP, "
                f"{tot['bytes'] / 1e6:.1f} MB): {tot['flops'] / tot['ms'] / 1e9:.2f} TFLOP/s, "
                f"{tot['bound_ms'] / tot['ms']:.1%} of the roofline")
    return out


def beit_calls(torch, cases):
    """BEiT-large's decoder at batch 1 (maps 16..128, head input 256x256):
    random bf16 inputs through the flagship's modules and weights, which
    have its widths: 7 RCUs, refinenet1's tail, the head after conv1."""
    by_name = {}
    for name, _, args, _, library in cases:
        by_name.setdefault(name, (args[1:], library))
    calls = []
    for i, (s, count) in enumerate(BEIT_RCUS):
        x = decoder_inputs(torch, (1, s, s, 256), 200 + i)[0].bfloat16()
        calls.append(("fused_rcu", (x, *by_name["fused_rcu"][0]), by_name["fused_rcu"][1], count))
    x = decoder_inputs(torch, (1, 128, 128, 256), 210)[0].bfloat16()
    calls.append(("fused_rcu_tail", (x, *by_name["fused_rcu_tail"][0]),
                  by_name["fused_rcu_tail"][1], 1))
    x = decoder_inputs(torch, (1, 256, 256, 128, 32), 211, head=True)[0].bfloat16()
    calls.append(("fused_head_tail", (x, *by_name["fused_head_tail"][0]),
                  by_name["fused_head_tail"][1], 1))
    return calls


# the planner's choice for K3's convolutions against its neighbours: (B, map
# size) at C = 256, and (tile config, splits) to try beside the planned one
PLAN_CHECK_SHAPES = [(1, 8), (1, 16), (1, 32), (1, 64), (1, 128), (2, 64)]
PLAN_CHECK_VARIANTS = [(0, 1), (1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (2, 9), (2, 36)]


def plan_check(torch, weights):
    """One bf16 RCU at each of PLAN_CHECK_SHAPES through the wrapper's own
    bf16 route, planned and with each neighbouring plan, on the live
    decoder's weights (OIHW f32 seen as HWIO, f32 biases), by CUDA-graph
    replay; plans of more than 1,100 CTAs are left out."""
    from soccdpt_torch.kernels import _conv
    from soccdpt_torch.kernels import fused_rcu as fr

    out = []
    with torch.no_grad():
        for B, n in PLAN_CHECK_SHAPES:
            x = decoder_inputs(torch, (B, n, n, 256), 300 + n)[0].bfloat16()
            planned = _conv.plan_conv(B, n, n, 256, taps=9)
            row = {"shape": [B, n, n, 256], "plain_ms": cuda_ms(torch, lambda: fr.fused_rcu_plain(
                x, *weights)), "plans": []}
            for config, splits in [(planned.config, planned.splits)] + PLAN_CHECK_VARIANTS:
                plan = dataclasses.replace(planned, splits=splits, config=config)
                box_h, box_w, bn = plan.box
                plan = dataclasses.replace(plan, boxes_y=-(-n // box_h), boxes_x=-(-n // box_w),
                                           n_tiles=-(-256 // bn))
                if (plan.ksteps % splits or plan.ctas > 1100
                        or (row["plans"] and (config, splits) == (planned.config, planned.splits))):
                    continue
                row["plans"].append({"config": config, "box": list(plan.box), "splits": splits,
                                     "ctas": plan.ctas, "planned": not row["plans"],
                                     "ms": cuda_ms(torch, lambda: fr._launch_bf16(x, *weights,
                                                                                  plan))})
            out.append(row)
            log(f"planner check, one bf16 RCU {row['shape']}: plain {row['plain_ms']:.4f} ms; "
                + ", ".join(f"{'planned ' if p['planned'] else ''}{p['box']} s{p['splits']} "
                            f"({p['ctas']} CTAs) {p['ms']:.4f}" for p in row["plans"]))
    return out


def tensor_core_proof(_build):
    """``HGMMA`` (wgmma in SASS) and ``UTMALDG`` (TMA loads) counted in the
    built K3 and K4 libraries: their bf16 route must run on the tensor
    cores, fed by TMA."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("fused_rcu", "fused_fusion"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = {"HGMMA": sass.count("HGMMA"), "UTMALDG": sass.count("UTMALDG")}
        if counts[name]["HGMMA"] == 0 or counts[name]["UTMALDG"] == 0:
            fail(f"the SASS of {name}'s library shows no HGMMA or no UTMALDG: {counts[name]}")
    log(f"tensor cores in the decoder libraries (cuobjdump -sass): {counts}")
    return counts


def cuda_launches(torch, fn):
    """(device operations (kernels, memsets, copies), device µs by operation)
    of one call of ``fn``, from a profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    return sum(ev.count for ev in rows), {ev.key[:80]: ev.device_time_total for ev in rows}


def phase_decoder(torch, F, sass):
    kernels = decoder_kernels()
    checks = {name: [] for name in kernels}
    worst = {name: {"float32": 0.0, "bfloat16": 0.0} for name in kernels}

    def record(name, got, want, shape, what, dname):
        err, ok, atol, rtol = close(torch, got, want, name)
        top = float(want.float().abs().max())
        checks[name].append({"shape": list(shape), "dtype": dname, "what": what,
                             "max_abs_err": err, "atol": atol, "rtol": rtol, "max_abs_value": top})
        worst[name][dname] = max(worst[name][dname], err)
        log(f"{name} {what} {list(shape)} {dname}: max|err| {err:.3g} (atol {atol:.3g}, rtol "
            f"{rtol}; values up to {top:.3g})")
        if not ok:
            fail(f"{name} disagrees at {list(shape)} {dname} ({what})")

    # --- (a) against the plain versions: random inputs at the decoders'
    # shapes and at ragged ones ---------------------------------------------
    arity = {"fused_rcu": 5, "fused_rcu_tail": 7, "fused_head_tail": 5}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for name, table, seed in (("fused_rcu", K3_CHECKS, 0),
                                      ("fused_rcu_tail", K4_CHECKS, 50),
                                      ("fused_head_tail", K5_CHECKS, 80)):
                fn, plain = kernels[name]
                for i, shape in enumerate(table):
                    args = decoder_inputs(torch, shape, seed + i, head=name == "fused_head_tail")
                    args = [args[0].to(dtype)] + args[1:arity[name]]
                    got = fn(*args)
                    torch.cuda.synchronize()
                    record(name, got, plain(*args), shape, "against the plain version", dname)

    # --- (b) the live flagship decoder: each kernel against the served
    # modules' own outputs, on their own weights, counts from 0 --------------
    live, grad, timed, beit, per_call, by_op, planner = {}, None, None, None, {}, {}, None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model, rcus, tail, head_io = live_decoder(torch, dtype)
        cases = live_cases(torch, F, model, rcus, tail, head_io)
        for fn, _ in kernels.values():
            fn.launches = 0
        with torch.no_grad():
            outs = [kernels[name][0](*args) for name, _, args, _, _ in cases]
        torch.cuda.synchronize()
        live[dname] = {name: fn.launches for name, (fn, _) in kernels.items()}
        for (name, what, args, want, _), got in zip(cases, outs):
            record(name, got, want, args[0].shape, f"live {what}, against the served module",
                   dname)
        with torch.no_grad():
            per_call[dname], by_op[dname] = {}, {}
            for name, _, args, _, _ in cases:
                if name not in per_call[dname]:
                    per_call[dname][name], by_op[dname][name] = cuda_launches(
                        torch, lambda: kernels[name][0](*args))
        log(f"CUDA launches of one call, live decoder, {dname}: {per_call[dname]}; device µs by "
            f"operation (the first call of each): {by_op[dname]}")
        if dtype == torch.float32:
            grad = k5_gradient(torch, kernels["fused_head_tail"], cases[-1][2])
        else:
            timed = time_calls(torch, kernels, [(n, a, lib, 1) for n, _, a, _, lib in cases],
                               "live flagship decoder")
            beit = time_calls(torch, kernels, beit_calls(torch, cases),
                              "dpt_beit_large_512's decoder shapes")
            planner = plan_check(torch, cases[0][2][1:])
        del model, rcus, tail, head_io, cases, outs
        torch.cuda.empty_cache()
    log(f"decoder kernels' launches on the live decoder: {live}")
    for name in kernels:
        if not all(counts[name] >= 1 for counts in live.values()):
            fail(f"{name} was launched no time on the live decoder")
    RECORD["decoder"] = {"checks": checks, "live_launches": live, "k5_gradient": grad,
                         "timed_flagship_bf16": timed, "timed_beit_large_bf16": beit,
                         "cuda_launches_per_call": per_call, "device_us_by_operation": by_op,
                         "sass": sass,
                         "plan_check_bf16": planner}
    sources = {"fused_rcu": ("fused_rcu.cu", "fused_rcu.py:137", "the 7 residual conv units"),
               "fused_rcu_tail": ("fused_fusion.cu", "fused_fusion.py:179", "refinenet1's tail"),
               "fused_head_tail": ("fused_head.cu", "fused_head.py:179",
                                   "the depth head after conv1")}
    entries = []
    for name, (src, replaces, what) in sources.items():
        t = timed[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"soccdpt_torch/csrc/{src}",
            "replaces": f"soccdpt_tpu/ops/{replaces}", "path": "standalone",
            "max_abs_err": worst[name]["float32"], "max_abs_err_bf16": worst[name]["bfloat16"],
            "tolerance": {"float32": DECODER_F32_TOL[name],
                          "bfloat16": f"rtol {DECODER_BF16_TOL}, atol {DECODER_BF16_TOL} of the "
                                      "largest |value|"},
            **{k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "roofline_share": t["bound_ms"] / t["ms"],
            "timed": f"{what} of one bf16 batch-1 flagship forward, on its live inputs",
            "library": "the served modules' own chain, bf16 NHWC (cuDNN convs, F.interpolate)",
            "beit_large_batch1": {k: beit[name][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "launches": sum(counts[name] for counts in live.values()),
            "launches_by_path": {f"decoder_live_{d}": counts[name] for d, counts in live.items()},
            "cuda_launches_per_call": {d: counts[name] for d, counts in per_call.items()},
        })
        if name in ("fused_rcu", "fused_rcu_tail"):
            entries[-1]["tensor_cores"] = {"bfloat16": "wgmma fed by TMA (csrc/conv_wgmma.cuh)",
                                           "float32": "none: CUDA cores",
                                           "sass": sass[src.split(".")[0]]}
    return entries


def k5_gradient(torch, k5, args):
    """K5's autograd.Function on the card (kernel forward, recompute
    backward) against autograd through its plain version, f32, on the live
    head's input and weights, every input."""
    fn, plain = k5
    x = args[0]
    g = torch.randn(x.shape[0], 2 * x.shape[1], 2 * x.shape[2], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    fn(*a).backward(g)
    plain(*b).backward(g)
    out, tol = {}, DECODER_F32_TOL["fused_head_tail"]
    for name, p, q in zip(("x", "w2", "b2", "w3", "b3"), a, b):
        diff = (p.grad - q.grad).abs()
        out[name] = float(diff.max())
        if p.grad.shape != p.shape or not bool((diff <= tol + tol * q.grad.abs()).all()):
            fail(f"K5's gradient of {name} leaves autograd through the plain version")
    log(f"fused_head_tail gradient, f32, live head input, card kernel vs plain autograd: max|err| "
        f"{out} (atol = rtol = {tol})")
    return out


# ---------------------------------------------------------------------------
# the served configurations
# ---------------------------------------------------------------------------

# launches per request of each attention kernel; K2 runs once per grid request
SERVED = {
    "swin": {"model_type": "dpt_swin2_tiny_256", "version": 3, "parity_batch": 2,
             "latency_reps": 10, "per_request": {"window_attention": 12, "global_attention": 0}},
    "beit": {"model_type": "dpt_beit_large_512", "version": 3, "parity_batch": 1,
             "latency_reps": 10, "per_request": {"window_attention": 0, "global_attention": 24}},
    # SOccDPT V1: two whole DPTs, each with its own Swin-V2 trunk
    "swin_v1": {"model_type": "dpt_swin2_tiny_256", "version": 1, "parity_batch": 2,
                "latency_reps": 10,
                "per_request": {"window_attention": 24, "global_attention": 0}},
    # SOccDPT V2: one trunk, two heads
    "swin_v2": {"model_type": "dpt_swin2_tiny_256", "version": 2, "parity_batch": 2,
                "latency_reps": 10,
                "per_request": {"window_attention": 12, "global_attention": 0}},
}
PARITY_ATOL = {"inv_depth": 1e-4, "seg": 1e-4, "points": 5e-3}
GRID_MISMATCH_LIMIT = 0.01
# the refined grid: a point that lands one cell apart moves the head's
# input, so the probabilities are held on average and cell by cell
HEAD_MEAN_ABS_LIMIT, HEAD_CELL_ATOL, HEAD_CELL_SHARE_LIMIT = 1e-3, 1e-2, 0.01
BF16_CACHE_MEAN_ABS_LIMIT = 1e-2


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


def set_tf32(torch, on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def check_parity(torch, got, want, label):
    """The card's f32 (inv_depth, seg, points, grid) against the CPU's."""
    parity = {}
    for name, g, w in zip(PARITY_ATOL, got, want):
        atol = PARITY_ATOL[name]
        err = float((g.cpu() - w).abs().max())
        parity[name] = {"max_abs_err": err, "atol": atol}
        log(f"{label} served f32 {name}: card vs CPU max|err| {err:.3g} (atol {atol})")
        if not err <= atol:
            fail(f"{label}: served {name} differs from the CPU run by {err}")
    mass = float(want[3].sum())
    mism = float((got[3].cpu() - want[3]).abs().sum()) / max(mass, 1e-30)
    parity["grid"] = {"mismatched_mass_share": mism, "limit": GRID_MISMATCH_LIMIT, "mass": mass}
    log(f"{label} served f32 grid: mismatched mass {mism:.3g} of {mass:.1f} "
        f"(limit {GRID_MISMATCH_LIMIT})")
    if not (mass > 0 and mism < GRID_MISMATCH_LIMIT):
        fail(f"{label}: served grid differs from the CPU run")
    log(f"{label} served inv_depth min {float(got[0].min()):.3f}")
    return parity


def phase_serving(torch, card, label):
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.models.soccdpt import SOccDPT_versions, build_model
    from soccdpt_torch.ops.geometry import occupancy_slots, rotate_points
    from soccdpt_torch.serving import make_serving_fn
    from soccdpt_torch.weights import init_random_

    spec = SERVED[label]
    record = RECORD.setdefault(label, {"model_type": spec["model_type"]})
    counters = {"window_attention": wa.window_attention,
                "global_attention": ga.global_attention, "segment_sum": ss.segment_sum}
    cfg = ModelConfig(model_type=spec["model_type"], version=spec["version"])
    t0 = time.perf_counter()
    base = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        # keep inv_depth in a band where depth = 1/inv stays well conditioned
        head = base.depth_net.head if cfg.version != 2 else base.depth_head
        head.conv3.weight.mul_(0.01)
        head.conv3.bias.fill_(0.3)
    probe = make_serving_fn(cfg, base)(frames_u8(torch, 1, 100))
    cfg32 = calibrated(cfg, probe[2])
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    weights = base.state_dict()
    del base, probe

    def same_weights(c):
        m = SOccDPT_versions[c.version](c)
        if c.occupancy_head:  # the 3-D head's own weights, from a seed of their own
            init_random_(m.occupancy_conv, seed=1)
        missing, unexpected = m.load_state_dict(weights, strict=False)
        if unexpected or any(not k.startswith("occupancy_conv.") for k in missing):
            fail(f"{label}: weights do not fit: missing {missing}, unexpected {unexpected}")
        return m

    model32, model16 = same_weights(cfg32), same_weights(cfg16)
    log(f"{label}: SOccDPT V{cfg.version} {spec['model_type']} built and calibrated in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"pc_scale {cfg32.occupancy.pc_scale} pc_shift {cfg32.occupancy.pc_shift}")

    # --- the main path: bf16 serving, counts from 0 -------------------------
    serve = {occ: make_serving_fn(cfg16, model16, compute_occ=occ) for occ in (False, True)}
    runs = [(1, False), (1, True), (2, False), (2, True)]
    requests = 2
    for fn in counters.values():
        fn.launches = 0
    outs = {}
    for B, occ in runs:
        for r in range(requests):
            outs[(B, occ)] = serve[occ](frames_u8(torch, B, 10 * B + r))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    forwards = requests * len(runs)
    expected = {name: n * forwards for name, n in spec["per_request"].items()}
    expected["segment_sum"] = requests * sum(occ for _, occ in runs)
    log(f"{label} main path: {forwards} requests, launches {launches}")
    for name, want_n in expected.items():
        if launches[name] != want_n:
            fail(f"{label}: {name} ran {launches[name]} times in {forwards} requests, "
                 f"expected {want_n}")
    for (B, occ), (inv, seg, pts, grid) in outs.items():
        shapes = [tuple(inv.shape), tuple(seg.shape), tuple(pts.shape)]
        if shapes != [(B, 1080, 1920), (B, 3, 1080, 1920), (B, 1080, 1920, 3)]:
            fail(f"{label}: served shapes {shapes} at batch {B}")
        if not all(bool(torch.isfinite(t).all()) for t in (inv, seg, pts)):
            fail(f"{label}: non-finite served output at batch {B}, occ={occ}")
        if occ:
            if tuple(grid.shape) != (B, 256, 256, 32, 3) or not bool(torch.isfinite(grid).all()):
                fail(f"{label}: bad grid {tuple(grid.shape)} at batch {B}")
            if not float(grid.sum()) > 0:
                fail(f"{label}: empty occupancy grid at batch {B}")
        elif grid is not None:
            fail(f"{label}: a grid came back with compute_occ=False")
    del outs

    # --- parity: the card's f32 outputs against the CPU's, TF32 off ----------
    set_tf32(torch, False)
    frames = frames_u8(torch, spec["parity_batch"], 7)
    got = make_serving_fn(cfg32, model32, compute_occ=True)(frames)
    cpu_model = copy.deepcopy(model32).cpu()
    t0 = time.perf_counter()
    want = make_serving_fn(cfg32, cpu_model, compute_occ=True, device="cpu")(frames.cpu())
    log(f"{label}: CPU reference served in {time.perf_counter() - t0:.1f} s")
    record["parity"] = check_parity(torch, got, want, label)
    del cpu_model, want, got

    if label == "beit":
        # one batch-1 grid request through the real 3-D occupancy head
        cfg_head = dataclasses.replace(cfg32, occupancy_head=True)
        head_model = same_weights(cfg_head)
        frames = frames_u8(torch, 1, 8)
        before = ga.global_attention.launches
        got = make_serving_fn(cfg_head, head_model, compute_occ=True)(frames)
        if ga.global_attention.launches != before + 24:
            fail("beit: the occupancy-head request did not run K6 24 times")
        cpu_model = copy.deepcopy(head_model).cpu()
        want = make_serving_fn(cfg_head, cpu_model, compute_occ=True, device="cpu")(frames.cpu())
        diff = (got[3].cpu() - want[3]).abs()
        head = {"mean_abs_err": float(diff.mean()), "mean_abs_limit": HEAD_MEAN_ABS_LIMIT,
                "cells_off_share": float((diff > HEAD_CELL_ATOL).float().mean()),
                "cell_atol": HEAD_CELL_ATOL, "cells_off_limit": HEAD_CELL_SHARE_LIMIT,
                "spread": float(want[3].max() - want[3].min())}
        record["occupancy_head"] = head
        log(f"beit occupancy head, card vs CPU: {head}")
        if tuple(got[3].shape) != (1, 256, 256, 32, 3) or not bool(torch.isfinite(got[3]).all()):
            fail("beit: bad refined grid")
        if not (0.0 <= float(got[3].min()) and float(got[3].max()) <= 1.0 and head["spread"] > 0.05):
            fail("beit: the refined grid is no spread of probabilities")
        if not (head["mean_abs_err"] < HEAD_MEAN_ABS_LIMIT
                and head["cells_off_share"] < HEAD_CELL_SHARE_LIMIT):
            fail("beit: the refined grid differs from the CPU run")
        del cpu_model, head_model, want, got
    del model32
    set_tf32(torch, True)

    # --- latency per bf16 request (host clock ending in synchronize) --------
    latency = {}
    for B, occ in runs:
        fn = serve[occ]
        frames = [frames_u8(torch, B, 1000 + i) for i in range(4)]
        for i in range(3):
            fn(frames[i % 4])
        torch.cuda.synchronize()
        times = []
        for i in range(spec["latency_reps"]):
            t0 = time.perf_counter()
            fn(frames[i % 4])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[f"b{B}_occ{int(occ)}"] = {"mean_ms": float(np.mean(times)),
                                          "median_ms": float(np.median(times)),
                                          "min_ms": float(np.min(times))}
        log(f"{label} served bf16 batch {B} occ={occ}: {np.mean(times):.3f} ms/request mean, "
            f"{np.median(times):.3f} median ({card})")
    record["latency_bf16"] = latency

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
    record["served_kernel_device_ms_b1_occ"] = {
        name: sum(us for k, us, _ in rows if f"{name}_kernel" in k) / 1e3 for name in counters}
    log(f"{label}, in the served request: {record['served_kernel_device_ms_b1_occ']} ms of "
        f"device time")
    record["profile_b1_occ_us_per_request"] = [
        {"name": k[:120], "device_us": us, "calls": c} for k, us, c in rows[:40]]
    wall = latency["b1_occ1"]["median_ms"]
    record["device_ms_per_request_b1_occ"] = device_us / 5.0 / 1e3
    record["launches_per_request_b1_occ"] = sum(c for _, _, c in rows)
    log(f"{label} profile (bf16, batch 1, occ): {device_us / 5.0 / 1e3:.3f} ms of device time in "
        f"{record['launches_per_request_b1_occ']:.0f} launches per request against {wall:.3f} ms "
        f"median wall time: busy share {device_us / 5.0 / 1e3 / wall:.3f}; top device time per "
        f"request:")
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

    if label == "beit":
        # the same request with the folded biases stored in bf16: K6 reads
        # them as they are. Held to the f32-cached outputs on average; both
        # run in bf16, whose own step near 0.3 is 2e-3.
        ref = fn(frame)
        half = make_serving_fn(cfg16, model16, compute_occ=True, bias_cache_dtype=torch.bfloat16)
        got = half(frame)
        if model16.depth_net.backbone.block0.bias_cache.dtype != torch.bfloat16:
            fail("beit: bias_cache_dtype=torch.bfloat16 did not store bf16 biases")
        diffs = {name: float((g - r).abs().mean())
                 for name, g, r in zip(("inv_depth", "seg"), got, ref)}
        torch.cuda.synchronize()
        times = []
        for i in range(spec["latency_reps"]):
            t0 = time.perf_counter()
            half(frame)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        record["bf16_bias_cache_b1_occ"] = {"mean_abs_diff": diffs, "limit": BF16_CACHE_MEAN_ABS_LIMIT,
                                            "median_ms": float(np.median(times))}
        log(f"beit with a bf16 bias cache (batch 1, occ): mean |diff| to the f32 cache {diffs} "
            f"(limit {BF16_CACHE_MEAN_ABS_LIMIT}), {np.median(times):.3f} ms median")
        if not all(bool(torch.isfinite(t).all()) for t in got) or not all(
                d < BF16_CACHE_MEAN_ABS_LIMIT for d in diffs.values()):
            fail("beit: serving with a bf16 bias cache left the f32-cached outputs")
    return launches, problem


# ---------------------------------------------------------------------------
# the trained configurations
# ---------------------------------------------------------------------------

# launches per training step of each attention kernel (K1's backward is a
# recompute through its plain version and launches nothing)
TRAINED = {
    "beit": {"model_type": "dpt_beit_large_512", "version": 3, "batch": 2,
             "encoder_percentage": 1.0,
             "per_step": {"window_attention": 0, "global_attention": 24,
                          "global_attention_backward": 24}},
    "swin": {"model_type": "dpt_swin2_tiny_256", "version": 3, "batch": 3,
             "encoder_percentage": 0.5,
             "per_step": {"window_attention": 12, "global_attention": 0,
                          "global_attention_backward": 0}},
    # V1: two trunks, and a seg decoder with BatchNorm in its fusion blocks
    "swin_v1": {"model_type": "dpt_swin2_tiny_256", "version": 1, "batch": 3,
                "encoder_percentage": 0.5,
                "per_step": {"window_attention": 24, "global_attention": 0,
                             "global_attention_backward": 0}},
    # V2: its whole trunk, decoder included, counts as encoder (``pretrained``)
    "swin_v2": {"model_type": "dpt_swin2_tiny_256", "version": 2, "batch": 3,
                "encoder_percentage": 0.5,
                "per_step": {"window_attention": 12, "global_attention": 0,
                             "global_attention_backward": 0}},
}
TRAIN_STEPS = 5
TRAIN_LR = 1e-4  # of the five bf16 steps; the config's default of 1e-5 moves little in five
TRAIN_LOSS_RTOL = 1e-4  # card against CPU, f32, TF32 off
# every leaf's |g_card - g_cpu| / |g_cpu| (2-norms): two f32 stacks that sum
# in other orders through up to 24 blocks and a 1080p loss. Most leaves
# agree to 1e-5 (the median is printed). The leaves behind an attention bias
# (BEiT's tables, Swin-V2's CPB MLPs) are the worst, at a few 1e-3: softmax
# ignores a shift of a row's bias, so their gradients are sums of terms that
# cancel, and f32 rounding is measured against what is left. A wrong
# gradient is off by its own size.
TRAIN_GRAD_REL_LIMIT = 1e-2
# plus this share of the largest leaf's norm, as tests/test_torch_training.py
# adds it: a conv bias ahead of a training-mode BatchNorm (V1's seg decoder)
# has a gradient that vanishes in exact arithmetic, since the norm subtracts
# the batch mean, so both devices give rounding noise of the other terms
TRAIN_GRAD_ATOL_OF_MAX = 1e-6


def loss_and_grads(trainer, batch):
    """One loss of ``batch`` and its gradients, left in ``.grad``, with the
    dropout and the stochastic depth off (the card and the CPU draw
    different numbers) and BatchNorm on batch statistics."""
    from soccdpt_torch.train.patchwise import select_trainable

    model = trainer.model
    for mod in model.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
        if hasattr(mod, "drop_path_rates"):
            mod.drop_path_rates = [0.0] * len(mod.drop_path_rates)
    select_trainable(model, trainer.masks[0])
    model.zero_grad(set_to_none=True)
    loss, _ = trainer.loss(trainer.to_device_batch(batch))
    loss.backward()
    return float(loss.detach())


def phase_training(torch, card, label):
    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.data.synthetic import make_batch
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.train.trainer import Trainer
    from soccdpt_torch.weights import named_flax_params

    spec = TRAINED[label]
    record = RECORD.setdefault(f"train_{label}", {"model_type": spec["model_type"],
                                                  "batch": spec["batch"]})
    counters = {"window_attention": wa.window_attention,
                "global_attention": ga.global_attention,
                "global_attention_backward": ga.global_attention_backward}
    mcfg = ModelConfig(model_type=spec["model_type"], version=spec["version"])
    net_w, net_h = mcfg.net_size
    batch = make_batch(0, spec["batch"], (1080, 1920), (net_h, net_w), mcfg.num_classes)
    base = dict(batch_size=spec["batch"], encoder_percentage=spec["encoder_percentage"],
                patchwise_percentage=1.0, learning_rate=TRAIN_LR)

    # --- (a) f32: one loss and its gradients, card against CPU, TF32 off ------
    set_tf32(torch, False)
    t0 = time.perf_counter()
    trainer = Trainer(mcfg, TrainConfig(**base))
    trainer.init_state(seed=0)
    log(f"train {label}: SOccDPT V{mcfg.version} {spec['model_type']} built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M weights, "
        f"{sum(trainer.masks[0].values())} of {len(trainer.masks[0])} leaves trainable")
    loss_card = loss_and_grads(trainer, batch)
    torch.cuda.synchronize()
    cpu = Trainer(mcfg, TrainConfig(**base), device="cpu")
    cpu.masks, cpu.model = trainer.masks, copy.deepcopy(trainer.model).cpu()
    t0 = time.perf_counter()
    loss_cpu = loss_and_grads(cpu, batch)
    cpu_seconds = time.perf_counter() - t0
    backbone = next(m for n, m in trainer.model.named_modules() if n.endswith("backbone"))
    depth = getattr(backbone.cfg, "depth", None)
    log(f"train {label}: CPU loss and gradients in {cpu_seconds:.1f} s at full width and "
        f"depth{f' ({depth} blocks)' if depth else ''}")
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    leaves = []  # (path, |g_card - g_cpu|, |g_cpu|)
    for (path, p), (_, pc) in zip(named_flax_params(trainer.model), named_flax_params(cpu.model)):
        if (p.grad is None) != (pc.grad is None):
            fail(f"train {label}: {path} has a gradient on one device only")
        if p.grad is None:
            continue
        ref = float(pc.grad.norm())
        if not ref > 0:
            fail(f"train {label}: the CPU gradient of {path} is zero")
        leaves.append((path, float((p.grad.cpu() - pc.grad).norm()), ref))
    floor = TRAIN_GRAD_ATOL_OF_MAX * max(ref for _, _, ref in leaves)
    # each leaf's error as a share of its bound; a NaN takes the lead and fails below
    worst = ("", 0.0, 0.0)
    for path, err, ref in leaves:
        share = err / (TRAIN_GRAD_REL_LIMIT * ref + floor)
        if not share <= worst[1]:
            worst = (path, share, err / ref)
    compared, median_rel = len(leaves), float(np.median([e / r for _, e, r in leaves]))
    record["parity_f32"] = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
                            "loss_rtol": TRAIN_LOSS_RTOL, "leaves_compared": compared,
                            "worst_leaf": worst[0], "worst_leaf_share_of_bound": worst[1],
                            "worst_leaf_rel_err": worst[2], "median_leaf_rel_err": median_rel,
                            "grad_rel_limit": TRAIN_GRAD_REL_LIMIT, "grad_floor": floor,
                            "cpu_seconds": cpu_seconds}
    log(f"train {label} f32, card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f} (rel "
        f"{loss_rel:.3g}, limit {TRAIN_LOSS_RTOL}); {compared} leaves' gradients, worst "
        f"{worst[0]} at {worst[1]:.3g} of its bound ({worst[2]:.3g} of its norm; bound "
        f"{TRAIN_GRAD_REL_LIMIT} of the norm + {floor:.3g}), median {median_rel:.3g} of the norm")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst[1] <= 1.0 and compared > 0):
        fail(f"train {label}: the card's f32 loss or gradients left the CPU's")
    del trainer, cpu
    torch.cuda.empty_cache()
    set_tf32(torch, True)

    # --- (b) the main path: five bf16 steps on that batch, counts from 0 ------
    trainer = Trainer(mcfg, TrainConfig(amp=True, **base))
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    launches = {name: 0 for name in counters}
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        for name, fn in counters.items():
            if fn.launches != spec["per_step"][name]:
                fail(f"train {label}: {name} ran {fn.launches} times in step {step}, expected "
                     f"{spec['per_step'][name]}")
            launches[name] += fn.launches
    log(f"train {label} bf16, {TRAIN_STEPS} steps at lr {TRAIN_LR}: losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}")
    if not all(np.isfinite(losses)):
        fail(f"train {label}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train {label}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    if state.step != TRAIN_STEPS or state.count != TRAIN_STEPS:
        fail(f"train {label}: the state counts {state.step} steps")

    # --- (c) step time, and the device time of one step by kernel ------------
    # the first step also builds the allocator's pools: the median leaves it out.
    # A step takes the batch from the host (masks narrowed to uint8, pinned,
    # copied); the same steps on a batch that is already on the card show what
    # of the step time that is.
    t0 = time.perf_counter()
    device_batch = trainer.to_device_batch(batch)
    torch.cuda.synchronize()
    to_device_ms = (time.perf_counter() - t0) * 1e3
    on_device = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, device_batch, gen)
        torch.cuda.synchronize()
        on_device.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(float(metrics["loss"])):
        fail(f"train {label}: the loss left the finite numbers after {state.step} steps")
    record["steps_bf16"] = {"losses": losses, "learning_rate": TRAIN_LR, "step_ms": times,
                            "median_step_ms": float(np.median(times[1:])),
                            "to_device_batch_ms": to_device_ms,
                            "step_ms_batch_on_device": on_device,
                            "median_step_ms_batch_on_device": float(np.median(on_device)),
                            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, device_batch, gen)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.device_time_total, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(us for _, us, _ in rows) / 1e3
    marks = {"window_attention": "window_attention_kernel",
             "global_attention": "global_attention_kernel",
             "global_attention_backward": "global_attention_bwd"}
    by_kernel = {name: sum(us for k, us, _ in rows if mark in k) / 1e3
                 for name, mark in marks.items()}
    record["step_kernel_device_ms"] = by_kernel
    record["device_ms_per_step"] = device_ms
    record["launches_per_step"] = sum(c for _, _, c in rows)
    record["profile_us_per_step"] = [
        {"name": k[:120], "device_us": us, "calls": c} for k, us, c in rows[:40]]
    median = record["steps_bf16"]["median_step_ms"]
    resident = record["steps_bf16"]["median_step_ms_batch_on_device"]
    log(f"train {label} bf16 batch {spec['batch']}: {median:.3f} ms median step from a host "
        f"batch (steps {[round(t, 1) for t in times]}; the host-to-device batch alone "
        f"{to_device_ms:.1f} ms), {resident:.3f} ms with the batch on the card (steps "
        f"{[round(t, 1) for t in on_device]}), peak memory "
        f"{record['steps_bf16']['peak_memory_gb']:.2f} GB ({card}); one profiled step: "
        f"{device_ms:.3f} ms of device time in {record['launches_per_step']} launches, busy "
        f"share {device_ms / resident:.3f} of the step with the batch on the card; by kernel "
        + ", ".join(f"{n} {ms:.3f} ms ({ms / device_ms:.1%})" for n, ms in by_kernel.items())
        + "; top device time:")
    for k, us, c in rows[:12]:
        log(f"  {us:9.1f} us  x{c:5d}  {k[:90]}")
    return launches


def main():
    if not (HERE / "soccdpt_torch").is_dir():
        fail("soccdpt_torch/ is not beside this script: run it from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(HERE))
    import torch.nn.functional as F

    from soccdpt_torch.kernels import _build
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    with phase("build"):
        seconds = _build.build_all()
        log(f"kernels built: {seconds}")
        for name in ("window_attention", "segment_sum", "global_attention",
                     "global_attention_bwd", "fused_rcu", "fused_fusion", "fused_head"):
            for line in _build.build_log(name).splitlines():
                if "spill" in line and " 0 bytes spill stores" not in line:
                    log(f"  ptxas {name}: {line.strip()}")
    set_tf32(torch, False)
    log("TF32 is off for the parity phases (cudnn.allow_tf32 = matmul.allow_tf32 = False)")

    with phase("K1 against its plain version"):
        k1 = phase_k1(torch, F, wa)
    with phase("K6 against its plain version"):
        k6 = phase_k6(torch, F, ga)
    with phase("K7 against its plain version"):
        k7 = phase_k7(torch, F, ga)
    with phase("K3, K4, K5 against their plain versions and the live decoder"):
        k3, k4, k5 = phase_decoder(torch, F, tensor_core_proof(_build))
    torch.cuda.empty_cache()
    # launches of the attention kernels and K2 on each main path
    path_launches = {}
    for label, name in (("swin", "serving dpt_swin2_tiny_256"),
                        ("beit", "serving dpt_beit_large_512"),
                        ("swin_v1", "serving V1 dpt_swin2_tiny_256"),
                        ("swin_v2", "serving V2 dpt_swin2_tiny_256")):
        set_tf32(torch, False)
        with phase(name):
            path_launches[f"serve_{label}"], served_problem = phase_serving(torch, card, label)
        if label == "swin":
            problem = served_problem
        torch.cuda.empty_cache()
    set_tf32(torch, False)
    with phase("K2 against its plain version"):
        k2 = phase_k2(torch, ss, problem)
    torch.cuda.empty_cache()
    for label, name in (("beit", "training dpt_beit_large_512"),
                        ("swin", "training dpt_swin2_tiny_256"),
                        ("swin_v1", "training V1 dpt_swin2_tiny_256"),
                        ("swin_v2", "training V2 dpt_swin2_tiny_256")):
        with phase(name):
            path_launches[f"train_{label}"] = phase_training(torch, card, label)
        torch.cuda.empty_cache()
    del served_problem
    # each kernel's time inside a served request, from the profile of the
    # configuration whose attention it is (K2: the flagship's), and inside a
    # training step
    served_in = {"window_attention": "swin", "segment_sum": "swin", "global_attention": "beit"}
    trained_in = {"window_attention": "train_swin", "global_attention": "train_beit",
                  "global_attention_backward": "train_beit"}
    for k in (k1, k2, k6, k7):
        name = k["name"]
        by_path = {path: counts.get(name, 0) for path, counts in path_launches.items()}
        k["path"] = "main"
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if name in served_in:
            k["served_device_ms"] = RECORD[served_in[name]][
                "served_kernel_device_ms_b1_occ"][name]
        if name in trained_in:
            k["train_step_device_ms"] = RECORD[trained_in[name]]["step_kernel_device_ms"][name]
        if k["launches"] < 1:
            fail(f"{name} was launched no time on the main paths")
    # K3-K5 are on no path of the system, as in the JAX package: their
    # launches are those of their own phase's live-decoder run, checked there
    for k in (k3, k4, k5):
        if k["launches"] < 1:
            fail(f"{k['name']} was launched no time in its phase")
    kernels = [k1, k2, k3, k4, k5, k6, k7]
    RECORD.update({"device": kind, "nvidia_smi": card, "kernels": kernels,
                   "build_seconds": seconds, "phase_seconds": PHASE_SECONDS,
                   "seconds": time.perf_counter() - t_start})
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(f"all phases passed in {RECORD['seconds']:.1f} s: {PHASE_SECONDS}")
    log(json.dumps({"kernels": kernels}))
    log(smi())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
