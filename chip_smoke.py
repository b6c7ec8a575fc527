#!/usr/bin/env python3
"""Drive the PyTorch port (``soccdpt_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. set-up: the card's name and power limit, the kernels built from
   ``soccdpt_torch/csrc`` with nvcc (one process per source, all at once),
   TF32 off for the parity phases;
2. every kernel against its plain PyTorch version on the card, at the
   shapes its served path gives it, with the stated tolerances, and timed
   by CUDA-graph replay beside its memory/compute bound and a library
   yardstick: K1 window attention (also on the strided q, k, v views and
   the bf16 tau the Swin block hands it, one CUDA launch a call), K2
   segment sum (on contiguous rows and on the served channel-major
   views, at batch 1 and 2, against the grid's zeros and ``index_add_``;
   its backward bit for bit, beside ``index_select``; the
   gradient through ``points_to_occupancy_grid`` against the CPU's; the
   runs of equal slots of the served frames), K6 global
   attention, K7 its backward (against SDPA's backward, replayed alone);
   ``cuobjdump -sass`` of the K1, K3, K4, K5, K6 and K7 libraries must show
   ``HGMMA`` and ``UTMALDG``;
2b. the decoder's bf16 2x bilinear upsample (``kernels/upsample.py``, the
   ``soccdpt::upsample2x`` op) at the six calls a batch-6 request of each
   benchmark cell makes (BEiT-L/512 and Swin-V2-T/256): one launch a call
   and within one bf16 step of its plain version (``F.interpolate``, aten's
   NHWC kernel), the share bit for bit; then timed by CUDA-graph replay
   beside the plain version, aten's NCHW kernel on a contiguous NCHW copy
   (the library) and the bytes bound;
2c. the 1080p geometry tail (``kernels/unproject_slots.py``, the
   ``soccdpt::unproject_slots`` op) at a batch-6 request of each benchmark
   configuration's camera and grid: one launch a call, the points bit for
   bit and the slots within 1e-5 of the plain path on the card, then
   kernel and plain ms (the aten composition it replaced), with slots and
   with points alone, beside the bytes bound;
3. the decoder kernels K3 (fused residual conv unit), K4 (fusion-block
   tail) and K5 (depth-head tail), standalone ops on no path of the
   system, as in the JAX package: against their plain versions at the
   flagship's and BEiT-large's decoder shapes (batch 1 and 2) and at
   ragged ones, in f32 and bf16 (all three run bf16 on the tensor cores); then on
   the live flagship decoder, whose modules' inputs and outputs forward
   hooks capture during one served request, each kernel held to the module
   it replaces on that module's weights (the launch counts set to 0 just
   before and read just after): K3 to the RCU's output, K4 and K5 to their
   modules' chain with ``F.interpolate`` as the upsample, since the served
   bf16 modules and K4's and K5's bf16 routes share the port's upsample
   kernel; the CUDA launches of one call of each op,
   from a profile (K5 in bf16 at most three); K5's gradient; times beside the plain version, the
   modules' own chain (cuDNN convs, ``F.interpolate``) and the bound; K3's
   launch plan against its neighbouring plans at both decoders' map sizes;
4. eight served configurations at full width and depth, weights from a
   numpy seed, 1080x1920 uint8 requests at batch 1 and 2, with and
   without the occupancy grid, through ``make_serving_fn``'s CUDA graphs
   (one a batch size): SOccDPT V3 on the flagship ``dpt_swin2_tiny_256``
   (K1, K2), on ``dpt_beit_large_512`` (K6, K2) and on the ViT-hybrid
   ``dpt_hybrid_384`` (K6 12 times a request, K2), SOccDPT V1 (two
   trunks, K1 24 times a request) and V2 (one trunk, two heads) on the
   flagship, and V3 on the last three backbone families, whose attention
   is plain PyTorch as in the JAX package, so K2 is their kernel:
   ``dpt_swin_large_384`` (Swin-V1 large, padded windows of 12),
   ``dpt_levit_224`` (LeViT-384 and its stem transpose) and
   ``dpt_next_vit_large_384`` (its BatchNorm statistics first set from two
   frames, ``calibrate_batchnorm``). For each, the launch counts are set to 0 just before its
   requests and read just after; the graphs' kernel nodes, read through
   libcuda's graph API, times their replays prove the path ran through its
   kernels (on BEiT-L/512 and the flagship also the upsample, 6 nodes a
   graph and no bilinear resize left to ``F.interpolate``; on every
   configuration the geometry kernel, 1 node a graph and no tail left to
   the plain path); the graphs'
   outputs are held to the eager path's on the same frames; the card's f32
   outputs are held to the same request served on
   the CPU; then bf16 latency per request, graph against eager, with a
   device-time profile of each, the host calls a request, the graph's
   nodes, capture time and memory pool, the copy out of the pool and the
   weight check. The flagship also loads other weights after a graph
   request, which must then equal a freshly bound serving fn's; the
   flagship's V3 and V1 serve a request after ``model.train()``, which
   must give bit for bit what the request before it gave, with no
   recapture and the BatchNorm statistics untouched. The BEiT
   path also serves one request through the real 3-D occupancy head and
   one with its folded biases stored in bf16;
4b. ``serve_stream`` on the flagship, bf16, batch 1, with and without the
   grid: 50 pageable 1080p frames at depth 1, 2 and 3, with the host
   thread and fed serially, each output held to ``serve()`` of its frame;
   frames/s, latency percentiles, busy share and the frame's copy;
5. training, through ``soccdpt_torch.train.trainer.Trainer`` on a fixed
   synthetic batch with GT at 1080x1920: ``dpt_beit_large_512`` at full
   width and depth, batch 2 (K6 forward and K7 backward, 24 launches each
   per step), the flagship at batch 3 as V3 (K1 twelve times forward
   per step), V1 (24 times; its seg decoder has BatchNorm) and V2, and V3
   on the last three families at batch 2 (no kernel of the table). For
   each: one f32 loss and its gradients on the card against the CPU's
   through the plain versions, and every BatchNorm's statistics after its
   forward (LeViT's and Next-ViT's trunks: each bound widened by the CPU's
   own spread under one rounding of the image); five bf16 steps whose loss
   must stay finite and fall, with the launch counts read around every
   step; the median step time, the step's peak memory above what is
   allocated when the peak is reset, and a device-time profile of one
   step; then ViT3D, the standalone volumetric refiner, on a full
   256x256x32x3 grid: card against CPU in f32, and its time;
6. occupancy training, through the data layer and
   ``soccdpt_torch.cli.train_occupancy``: a BDD fixture tree of 2 x 4
   frames at 1920x1080 written from seed 0; the host library (built with
   g++) against its plain versions on one frame (voxelizer, PNG unfilter);
   one sample's GT; the host time of a sample by part and the copy of a
   batch; one f32 step, card against CPU (loss, every ``occupancy_conv``
   gradient); the bf16 step with the 3-D head's pairwise-maximum pools
   against ``max_pool3d`` (equal forward values, wall and device time,
   launches); then the CLI's main path
   on the flagship at full width (V3, 256x256x32x3 grid, batch 1, six bf16
   steps, a base checkpoint with the depth head scaled as in phase 4):
   K1 twelve times and K2 once a step and nothing else of the table, the
   losses, the checkpoint, the val IoU against predicting every cell
   occupied, the step time and a profile of one step;
7. the timing CLIs: ``python -m soccdpt_torch.cli.bench`` (through its
   ``main``), ``eval_timing --contract full`` and ``--contract occ`` for the
   eight served configurations, ``eval_patchwise`` on the flagship at batch
   1, 2 and 4 and patch-wise 1.0, 0.5 and 0.25 (any error row fails);
8. the training and eval CLIs on a BDD fixture tree of 2 x 10 frames at
   1920x1080: ``soccdpt_torch.cli.train`` on the flagship (its published
   sweep file with ``load`` set to a reference-layout ``.pth`` written from
   a seeded model by ``reference_state_dict``, the inverse of the reader;
   every leaf must land and equal the source; six steps with the host
   thread, then six without it, for the loop's period), then
   ``soccdpt_torch.cli.eval`` on the checkpoint the first run wrote (four
   panels, finite metrics, the FPS line), then the training CLI on
   ``dpt_hybrid_384`` from its published sweep file as it is (batch 2,
   ``amp``, encoder 0.5, patch-wise 0.5), four steps, after one f32 loss
   and its gradients on the card against the CPU's; K6 12 times a patch
   step's forward and K7 once for each ViT block its backward runs
   through; step times, a profile of one step, peak memory;
9. deployment and baselines, on the same tree: ``cli/export.py`` of the
   flagship from a reference-layout ``.pth`` (dynamic batch; K1 is a
   ``soccdpt::window_attention`` node of the program, 12 of them, the
   upsample a ``soccdpt::upsample2x`` node, 6 of them; with points the
   geometry tail one ``soccdpt::unproject_slots`` node), run by
   ``python -m soccdpt_torch.cli.run_exported`` in fresh processes at
   batch 1 and 2, and loaded here at batch 1 and 2 against the eager model
   (bit for bit, or within the ladder of tests/test_composition_oracle.py),
   with K1's launches a forward; the same with points at 1920x1080 and for
   ``dpt_hybrid_384`` (12 K6 nodes); export seconds and bytes, the
   program's wall, as a CUDA graph and its device time against the eager
   model's; ``cli/eval_others.py``'s builtin adapter on the flagship and
   its ``pt2:`` adapter on the program over the tree (equal metrics),
   ``--list``, an external name's clean hub error (the hub a stub: no
   network); ``cli/datasets_analysis.py``; MiDaS v2.1 at full width
   (ResNeXt-101 32x8d), 256x256: the card's f32 against the CPU's, its own
   spread under a nudge of the image with drawn and with calibrated
   BatchNorm statistics, bf16 walls and device time at batch 1 and 2;
   identical grid requests of the flagship compared bit for bit (K2's
   atomics); a bare call's host µs through the custom ops against the
   launch alone;
10. data and tensor parallelism (``soccdpt_torch/parallel/``): (a) the
   flagship V3 at batch 3 in bf16 takes a step through the mesh trainer at
   world size 1 over NCCL (``init_distributed`` from a torchrun
   environment set for the call) and through the trainer with no process
   group, from the same weights and batch: the loss to 1e-5 relative, each
   leaf's update, both moments and every BatchNorm statistic to the
   training phase's bounds, K1 twelve times a step; the step walls and the
   NCCL kernels' device time; (b) two ranks spawned on the one card over
   gloo, f32, TF32 off, global batch 2, one step on a (2, 1) and one on a
   (1, 2) mesh: each rank's loss against one process's step on that batch
   to 2e-4 relative; the moments' bytes per rank at tp 2 against tp 1 and
   the leaves sharded.

It prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.
The whole record goes to ``chiprun_out/chip_smoke.json``.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
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


def cuda_ms(torch, fn, iters=20, graph=True, stream=None):
    """Mean device milliseconds per call of ``fn``, from CUDA events.

    With ``graph`` the calls are captured once into a CUDA graph and the
    graph is replayed, so the time is the card's and not the host's
    Python and launch overhead. A function with a data-dependent shape
    (a boolean-mask index syncs the host) cannot be captured and is timed
    as launched (``graph=False``). ``stream``: warm up and capture on this
    stream (autograd runs a backward op on its forward's stream, so a
    backward is captured on the stream its forward ran on). Inputs stay
    warm in the 50 MB L2, as they are in the served forward, where their
    producer just wrote them.
    """
    if stream is None:
        fn()
    torch.cuda.synchronize()
    if graph:
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
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


# the live block's operands, checked and timed: stage 0 shifted, stage 2
K1_VIEWS = [(16, 3, 256, 32, 16), (1, 12, 256, 32, None)]


def k1_views(torch, Bw, H, N, d, nW, seed):
    """K1's bf16 operands as ``WindowAttentionV2`` hands them over: q, k, v
    strided views of one (Bw, N, 3, H, d) qkv tensor (q and k normalised),
    a bf16 tau (H, 1, 1), the f32 bias and mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(Bw, N, 3, H, d, device="cuda", generator=g)
    qkv[:, :, :2] = qkv[:, :, :2] / qkv[:, :, :2].norm(dim=-1, keepdim=True)
    q, k, v = qkv.bfloat16().permute(2, 0, 3, 1, 4)
    _, _, _, scale, bias, mask = k1_inputs(torch, Bw, H, N, d, nW, torch.bfloat16, seed)
    return q, k, v, scale.bfloat16(), bias, mask


def k1_library(torch, F, q, k, v, s, b, m):
    """SDPA on tau*q with bias+mask folded beforehand, q, k, v contiguous:
    the library yardstick of one K1 call."""
    qs = (q.float() * s.float()).to(q.dtype)
    am = (b[None] if m is None else b[None] + m[:, None]).to(q.dtype)
    k, v = k.contiguous(), v.contiguous()
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=am, scale=1.0)


def k1_bytes_flops(Bw, H, N, d, nW, itemsize):
    nbytes = 4 * Bw * H * N * d * itemsize + H * N * N * 4 + (nW * N * N * 4 if nW else 0)
    return nbytes, 4 * Bw * H * N * N * d


def phase_k1(torch, F, wa, sass):
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

    # the live block's operands: strided q, k, v views and a bf16 tau, read
    # in place by one launch; the same bits twice
    views, launches = [], {}
    for i, (Bw, H, N, d, nW) in enumerate(K1_VIEWS):
        q, k, v, s, b, m = k1_views(torch, Bw, H, N, d, nW, seed=20 + i)
        got = wa.window_attention(q, k, v, s, b, m)
        torch.cuda.synchronize()
        err = float((got.float() - wa.window_attention_plain(q, k, v, s, b, m).float()).abs().max())
        log(f"K1 {Bw}x{H}x{N}x{d} mask={nW} bf16, strided q/k/v views and a bf16 tau: "
            f"max|err| {err:.3g} (tol {K1_BF16_ATOL})")
        if not err <= K1_BF16_ATOL:
            fail(f"K1 disagrees with its plain version on strided views at {Bw}x{H}x{N}x{d}")
        if not torch.equal(got, wa.window_attention(q, k, v, s, b, m)):
            fail(f"K1 gave other bits on a second call at {Bw}x{H}x{N}x{d}")
        _, by_op = cuda_launches(torch, lambda: wa.window_attention(q, k, v, s, b, m))
        ops = graph_launches(torch, lambda: wa.window_attention(q, k, v, s, b, m))
        if ops != 1:
            fail(f"a bf16 K1 call on the block's views made {ops} CUDA launches: {by_op}")
        views.append({"shape": [Bw, H, N, d], "nW": nW, "max_abs_err": err,
                      "cuda_launches_per_call": ops, "device_us_by_operation": by_op,
                      "ms": cuda_ms(torch, lambda: wa.window_attention(q, k, v, s, b, m)),
                      "plain_ms": cuda_ms(torch, lambda: wa.window_attention_plain(
                          q, k, v, s, b, m)),
                      "library_ms": cuda_ms(torch, k1_library(torch, F, q, k, v, s, b, m))})
        launches["bfloat16, the block's views"] = ops
        log(f"K1 time on the block's views {Bw}x{H}x{N}x{d} mask={nW}: kernel "
            f"{views[-1]['ms']:.4f} ms, plain {views[-1]['plain_ms']:.4f} ms, sdpa "
            f"{views[-1]['library_ms']:.4f} ms; CUDA launches a call: {ops} ({by_op})")
    q, k, v, s, b, m = k1_inputs(torch, *K1_VIEWS[0], torch.float32, seed=0)
    launches["float32"] = graph_launches(torch, lambda: wa.window_attention(q, k, v, s, b, m))

    # one batch-1 bf16 forward's 12 launches: kernel, plain, library
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0}
    per_shape = []
    for Bw, H, N, d, nW, count in K1_FORWARD:
        q, k, v, s, b, m = k1_inputs(torch, Bw, H, N, d, nW, torch.bfloat16, seed=7)
        t = {
            "ms": cuda_ms(torch, lambda: wa.window_attention(q, k, v, s, b, m)),
            "plain_ms": cuda_ms(torch, lambda: wa.window_attention_plain(q, k, v, s, b, m)),
            "library_ms": cuda_ms(torch, k1_library(torch, F, q, k, v, s, b, m)),
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
    RECORD["k1"] = {"checks": checks, "views": views, "per_shape": per_shape, "forward": tot}
    bound_ms = max(byte_ms, flop_ms)
    log(f"K1 time, 12 launches, bf16: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"sdpa {tot['library_ms']:.4f} ms, bound {bound_ms:.4f} ms: {bound_ms / tot['ms']:.1%} of "
        f"the roofline")
    return {
        "name": "window_attention",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/window_attention.cu",
        "replaces": "soccdpt_tpu/ops/window_attention.py:218",
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "tolerance": {"float32": K1_F32_ATOL, "bfloat16": K1_BF16_ATOL},
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "timed": "the 12 launches of one bf16 batch-1 forward, summed",
        "roofline_share": bound_ms / tot["ms"],
        "cuda_launches_per_call": launches,
        "tensor_cores": {"bfloat16": "wgmma fed by TMA (csrc/attention_wgmma.cuh)",
                         "float32": "none: CUDA cores", "sass": sass["window_attention"]},
        "strided_views": views,
    }


# ---------------------------------------------------------------------------
# K6: global attention
# ---------------------------------------------------------------------------

# (B, H, T, d): beitl16_512 at batch 1 and 2 (the training step's), the
# 384-px base models at batch 2, and the test config's ragged tiles
K6_CHECKS = [(1, 16, 1025, 64), (2, 16, 1025, 64), (2, 12, 577, 64), (2, 2, 65, 16)]
# timed: (label, (B, H, T, d), bias dtype name or None, launches per bf16
# forward: one a block); the hybrid's ViT-B at batch 2, its training batch
K6_FORWARDS = [
    ("beitl16_512, f32 bias", (1, 16, 1025, 64), "float32", 24),
    ("beitl16_512, bf16 bias", (1, 16, 1025, 64), "bfloat16", 24),
    ("vitl16_384, no bias", (1, 16, 577, 64), None, 24),
    ("beitl16_512 at batch 2, f32 bias", (2, 16, 1025, 64), "float32", 24),
    ("vitb_rn50_384 at batch 2, no bias", (2, 12, 577, 64), None, 12),
]


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


def phase_k6(torch, F, ga, sass):
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
                if not torch.equal(got, ga.global_attention(q, k, v, bias, scale)):
                    fail(f"K6 gave other bits on a second call at {B}x{H}x{T}x{d} {name}")

    # One bf16 batch-1 forward is 24 launches, each block with a bias of its
    # own, so no launch finds its bias in L2: three distinct biases in turn.
    forwards = []
    for label, (B, H, T, d), bias_name, n in K6_FORWARDS:
        bias_dtype = getattr(torch, bias_name) if bias_name else None
        q, k, v, biases = k6_inputs(torch, B, H, T, d, bias_dtype, torch.bfloat16, seed=9,
                                    n_bias=3)
        scale = d ** -0.5
        # the library yardstick needs the mask in q's dtype, cast beforehand
        masks = [None if b is None else b.to(q.dtype)[None] for b in biases]
        per_forward = n / len(biases)
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
        byte_ms = n * nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = n * flops / PEAK_FLOPS["bfloat16"] * 1e3
        forwards.append({"forward": label, "shape": [B, H, T, d], "bias": bias_name,
                         "launches_per_forward": n, **t,
                         "bytes": n * nbytes,
                         "flops": n * flops,
                         "bound_ms": max(byte_ms, flop_ms),
                         "bound_by": "bytes" if byte_ms >= flop_ms else "operations"})
        log(f"K6 time, {n} launches, bf16, {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
            f"{max(byte_ms, flop_ms):.4f} ms ({forwards[-1]['bound_by']}): "
            f"{max(byte_ms, flop_ms) / t['ms']:.1%} of the roofline")
        if label == K6_FORWARDS[0][0]:
            launches, by_op = cuda_launches(torch, lambda: ga.global_attention(
                q, k, v, biases[0], scale))
    RECORD["k6"] = {"checks": checks, "forwards": forwards}
    main = forwards[0]
    log(f"K6: CUDA launches of one bf16 call at {main['shape']}: {launches} ({by_op})")
    return {
        "name": "global_attention",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/global_attention.cu",
        "replaces": "soccdpt_tpu/ops/global_attention.py:135",
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "tolerance": {"float32": K6_F32_TOL, "bfloat16": K6_BF16_TOL},
        **{key: main[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "timed": "the 24 launches of one bf16 batch-1 forward of beitl16_512, f32 bias",
        "roofline_share": main["bound_ms"] / main["ms"],
        "cuda_launches_per_call": launches,
        "tensor_cores": {"bfloat16": "wgmma fed by TMA (csrc/attention_wgmma.cuh)",
                         "float32": "none: CUDA cores", "sass": sass["global_attention"]},
        "other_forwards": forwards[1:],
    }


# ---------------------------------------------------------------------------
# K7: global attention, backward
# ---------------------------------------------------------------------------

# (B, H, T, d, with a bias): beitl16_512 at batch 1 and 2 (dbias sums the
# images), vitl16_384 without a bias, and the test config's ragged tiles
K7_CHECKS = [(1, 16, 1025, 64, True), (2, 16, 1025, 64, True), (1, 16, 577, 64, False),
             (2, 12, 577, 64, False), (2, 2, 65, 16, True)]
# (label, (B, H, T, d), bias dtype name or None, launches per bf16 backward)
K7_BACKWARDS = [
    ("beitl16_512, f32 bias", (1, 16, 1025, 64), "float32", 24),
    ("vitl16_384, no bias", (1, 16, 577, 64), None, 24),
    ("beitl16_512 at batch 2, f32 bias", (2, 16, 1025, 64), "float32", 24),
    ("vitb_rn50_384 at batch 2, no bias", (2, 12, 577, 64), None, 12),
]


def k7_bytes_flops(B, H, T, d, itemsize, bias_itemsize):
    """q, k, v, g read and dq, dk, dv written once; the bias read and dbias
    (f32) written once; five products."""
    nbytes = 7 * B * H * T * d * itemsize
    if bias_itemsize:
        nbytes += H * T * T * (bias_itemsize + 4)
    return nbytes, 10 * B * H * T * T * d


def phase_k7(torch, F, ga, sass):
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
    for label, (B, H, T, d), bias_name, n in K7_BACKWARDS:
        bias_dtype = getattr(torch, bias_name) if bias_name else None
        q, k, v, biases = k6_inputs(torch, B, H, T, d, bias_dtype, torch.bfloat16, seed=29,
                                    n_bias=3)
        g = torch.randn(B, H, T, d, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(49)).bfloat16()
        scale = d ** -0.5
        fwd = [ga.global_attention_with_lse(q, k, v, b, scale) for b in biases]
        per_backward = n / len(biases)
        # the library yardstick: autograd through SDPA, mask cast beforehand.
        # Its forward runs on a stream of its own, so that autograd runs the
        # backward there and the backward alone is captured and replayed
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        masks = [None if b is None else b.to(q.dtype)[None].requires_grad_() for b in biases]
        sdpa_stream = torch.cuda.Stream()
        sdpa_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(sdpa_stream):
            outs = [F.scaled_dot_product_attention(ql, kl, vl, attn_mask=m, scale=scale)
                    for m in masks]

        def library():
            for o, m in zip(outs, masks):
                torch.autograd.grad(o, (ql, kl, vl) if m is None else (ql, kl, vl, m), g,
                                    retain_graph=True)

        with torch.cuda.stream(sdpa_stream):
            as_launched = per_backward * cuda_ms(torch, library, iters=5, graph=False)
        t = {
            "ms": per_backward * cuda_ms(torch, lambda: [
                ga.global_attention_backward(q, k, v, b, scale, g, out=o, lse=l)
                for b, (o, l) in zip(biases, fwd)], iters=5),
            "plain_ms": per_backward * cuda_ms(torch, lambda: [
                ga.global_attention_backward_plain(q, k, v, b, scale, g) for b in biases],
                iters=3),
            "library_ms": per_backward * cuda_ms(torch, library, iters=5, stream=sdpa_stream),
            "library_ms_as_launched": as_launched,
        }
        if B >= 2:  # the dq kernel holding one image's dq at a time, or two
            t["ms_by_images_per_dq_cta"] = {n: per_backward * cuda_ms(torch, lambda: [
                ga._launch_backward(q, k, v, b, o, l, g, scale, b is not None, img=n)
                for b, (o, l) in zip(biases, fwd)], iters=5) for n in (1, 2)}
        nbytes, flops = k7_bytes_flops(B, H, T, d, 2, biases[0].element_size() if bias_name else 0)
        byte_ms = n * nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = n * flops / PEAK_FLOPS["bfloat16"] * 1e3
        backwards.append({"backward": label, "shape": [B, H, T, d], "bias": bias_name,
                          "launches_per_backward": n, **t,
                          "bytes": n * nbytes,
                          "flops": n * flops,
                          "bound_ms": max(byte_ms, flop_ms),
                          "bound_by": "bytes" if byte_ms >= flop_ms else "operations"})
        log(f"K7 time, {n} launches, bf16, {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa backward {t['library_ms']:.4f} ms by graph replay "
            f"({t['library_ms_as_launched']:.4f} ms as launched), bound "
            f"{max(byte_ms, flop_ms):.4f} ms ({backwards[-1]['bound_by']}): "
            f"{max(byte_ms, flop_ms) / t['ms']:.1%} of the roofline"
            + (f"; by images a dq CTA holds {t['ms_by_images_per_dq_cta']}" if B >= 2 else ""))
        if label == K7_BACKWARDS[0][0]:
            launches, by_op = cuda_launches(torch, lambda: ga.global_attention_backward(
                q, k, v, biases[0], scale, g, out=fwd[0][0], lse=fwd[0][1]))
        del fwd, outs, masks
    RECORD["k7"] = {"checks": checks, "backwards": backwards}
    main = backwards[0]
    log(f"K7: CUDA launches of one bf16 call at {main['shape']}: {launches} ({by_op})")
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
        "library": "autograd through SDPA (mask cast beforehand), its backward alone by "
                   "CUDA-graph replay",
        "library_ms_as_launched": main["library_ms_as_launched"],
        "roofline_share": main["bound_ms"] / main["ms"],
        "cuda_launches_per_call": launches,
        "tensor_cores": {"bfloat16": "wgmma fed by TMA (csrc/attention_wgmma.cuh)",
                         "float32": "none: CUDA cores", "sass": sass["global_attention_bwd"]},
        "other_backwards": backwards[1:],
    }


# ---------------------------------------------------------------------------
# K2: segment sum
# ---------------------------------------------------------------------------


def k2_bytes(lin, num_slots, C):
    kept = int(((lin >= 0) & (lin < num_slots)).sum())
    return lin.numel() * 4 + kept * C * 4 + num_slots * C * 4


def k2_backward_bytes(torch, lin, num_slots, C):
    """The gather's bytes: the keys, the cotangent rows of the distinct kept
    slots, the (N, C) gradient."""
    keep = (lin >= 0) & (lin < num_slots)
    return lin.numel() * 4 + torch.unique(lin[keep]).numel() * C * 4 + lin.numel() * C * 4


def k2_runs(torch, lin, num_slots, B, C):
    """Runs of equal consecutive kept slots of a served problem, and the
    reductions K2 sends for it: one a channel for each run inside a
    128-row tile of one image (a dropped row ends a run)."""
    keep = (lin >= 0) & (lin < num_slots)
    k = lin[keep]
    starts = torch.ones_like(k, dtype=torch.bool)
    starts[1:] = k[1:] != k[:-1]
    first = torch.nonzero(starts).flatten()
    lengths = torch.diff(first, append=torch.tensor([k.numel()], device=k.device))
    key = torch.where(keep, lin, -1).view(B, -1)
    tile_start = torch.ones_like(key, dtype=torch.bool)
    tile_start[:, 1:] = key[:, 1:] != key[:, :-1]
    tile_start[:, ::128] = True
    return {"rows": lin.numel(), "kept": k.numel(), "runs": first.numel(),
            "mean_run": k.numel() / max(first.numel(), 1),
            "max_run": int(lengths.max()) if k.numel() else 0,
            "distinct_slots": torch.unique(k).numel(),
            "reductions_sent": int((tile_start & (key >= 0)).sum()) * C,
            "reductions_per_row_and_channel_before": k.numel() * C}


def k2_sass(_build):
    """The f32 add reductions and atomics in the K2 library's SASS: the
    scatter's adds are fire-and-forget (``RED``), none returns (``ATOM``)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path("segment_sum"))],
                          capture_output=True, text=True, check=True).stdout
    ops = {}
    for op in re.findall(r"\b((?:RED|ATOM)[A-Z]*\.[A-Z0-9_.]*ADD\.F32[A-Z0-9_.]*)", sass):
        ops[op] = ops.get(op, 0) + 1
    red = sum(n for op, n in ops.items() if op.startswith("RED"))
    atom = sum(n for op, n in ops.items() if op.startswith("ATOM"))
    log(f"K2 SASS f32 add reductions: {ops}")
    if red == 0 or atom:
        fail(f"K2's SASS shows {red} RED and {atom} ATOM f32 adds: its adds must be REDs")
    return ops


def phase_k2(torch, ss, problems, _build):
    """K2 against its plain version, forward and backward, on random, strided, long-run and degenerate problems; the gradient
    through ``points_to_occupancy_grid`` against the CPU's; times on the
    served frames (``problems``: batch 1 and 2, the served (B, N, C) views)."""
    from soccdpt_torch.ops.geometry import points_to_occupancy_grid

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
    # the same keys and values as a (B, N, C) view of a channel-major tensor
    view = vals.reshape(B, n_frame, C).transpose(1, 2).contiguous().transpose(1, 2)
    cases.append(("the same, values a transposed (B, N, C) view", lin, view, S, K2_RTOL))
    # image-ordered keys: runs of equal slots up to 2,000 rows, some dropped
    runs = torch.randint(1, 2000, (n_frame,), device=dev, generator=g)
    start = torch.randint(0, cells, (n_frame,), device=dev, generator=g, dtype=torch.int32)
    ordered = torch.cat([torch.repeat_interleave(start, runs)[:n_frame] + b * cells
                         for b in range(B)])
    ordered[torch.rand(B * n_frame, device=dev, generator=g) < 0.05] = -1
    served = torch.rand(B, C, n_frame, device=dev, generator=g).transpose(1, 2)
    cases.append(("image-ordered keys, long runs, B=2 view", ordered, served, S, K2_RTOL))
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
        want = ss.segment_sum_plain(l, v, s)
        got = ss.segment_sum(l, v, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= K2_ATOL + rtol * want.abs()).all())
        checks.append({"case": name, "max_abs_err": err, "rtol": rtol, "atol": K2_ATOL})
        worst = max(worst, err)
        log(f"K2 {name}: max|err| {err:.3g} (rtol {rtol}, atol {K2_ATOL})")
        if not ok:
            fail(f"K2 disagrees with its plain version: {name}")

    # the backward: a gather, the same bits as the plain version
    cot = torch.randn(S, C, device=dev, generator=g)
    for name, l, s in (("flagship B=2", lin, S), ("served frame", problems[1][0], problems[1][2])):
        c = cot[:s]
        got = ss.segment_sum_backward(l, c)
        torch.cuda.synchronize()
        want = ss.segment_sum_backward_plain(l, c)
        dropped = (l < 0) | (l >= s)
        same = torch.equal(got, want) and not bool(got[dropped].any())
        checks.append({"case": f"backward, {name}", "bit_for_bit": same})
        log(f"K2 backward, {name}: the same bits as the plain version, zeros on "
            f"{int(dropped.sum())} dropped rows: {same}")
        if not same:
            fail(f"K2's backward differs from its plain version: {name}")

    # the gradient through points_to_occupancy_grid on the card against the
    # CPU's: the same points and semantics, made on the CPU, so every row
    # lands in the same slot on both; the semantics a (1, N, C) view of a
    # channel-major leaf, as the served path hands them over
    occ_cfg, points = problems["geometry"]
    points = points.clone()
    rng = np.random.default_rng(5)
    sem = torch.from_numpy(rng.random((1, C, points.shape[1]), dtype=np.float32))
    w = torch.from_numpy(rng.random((1, *occ_cfg.grid_size, C), dtype=np.float32))
    grads = {}
    for d in ("cpu", dev):
        x = sem.detach().to(d).requires_grad_()
        for fn in (ss.segment_sum, ss.segment_sum_backward):
            fn.launches = 0
        grid = points_to_occupancy_grid(points.to(d), x.transpose(1, 2), occ_cfg, C)
        (grid * w.to(d)).sum().backward()
        grads[d] = (grid.detach().cpu(), x.grad.cpu())
        if d == dev and (ss.segment_sum.launches, ss.segment_sum_backward.launches) != (1, 1):
            fail(f"the card's gradient took {ss.segment_sum.launches} forward and "
                 f"{ss.segment_sum_backward.launches} backward launches, expected 1 and 1")
    grid_err = float((grads[dev][0] - grads["cpu"][0]).abs().max())
    grad_err = float((grads[dev][1] - grads["cpu"][1]).abs().max())
    log(f"K2 gradient through points_to_occupancy_grid, card against CPU: grid max|err| "
        f"{grid_err:.3g}, gradient max|err| {grad_err:.3g} (atol = rtol = {K2_ATOL})")
    checks.append({"case": "gradient through points_to_occupancy_grid", "grid_max_abs_err":
                   grid_err, "grad_max_abs_err": grad_err, "atol": K2_ATOL, "rtol": K2_ATOL})
    if not all(bool(((a - b).abs() <= K2_ATOL + K2_ATOL * b.abs()).all())
               for a, b in zip(grads[dev], grads["cpu"])):
        fail("K2's gradient through points_to_occupancy_grid differs from the CPU's")

    # times by graph replay on the served frames: batch 1 and 2, the served
    # channel-major view and contiguous values. K2 makes and zeroes its grid
    # in every call, so the library call does too: the grid's zeros, then
    # index_add_ of the kept rows (filtered beforehand, which K2 does inside).
    timing, launches = {}, {}
    for B_ in (1, 2):
        l, v, s = problems[B_]
        rows = v.reshape(-1, C)
        cont = rows.contiguous()
        keep = (l >= 0) & (l < s)
        lk, vk = l[keep].long(), cont[keep]
        cot_b = cot[:s]
        t = {f"{name}_ms": cuda_ms(torch, lambda v_=v_: ss.segment_sum(l, v_, s))
             for name, v_ in (("view", v), ("contiguous", cont))}
        t["library_ms"] = cuda_ms(torch, lambda: torch.zeros(s, C, device=dev).index_add_(
            0, lk, vk))
        t["backward_ms"] = cuda_ms(torch, lambda: ss.segment_sum_backward(l, cot_b))
        t["index_select_ms"] = cuda_ms(torch, lambda: cot_b.index_select(0, lk))
        if B_ == 1:
            acc = torch.zeros(s, C, device=dev)
            t["index_add_without_the_fill_ms"] = cuda_ms(torch, lambda: acc.index_add_(0, lk, vk))
            t["plain_ms"] = cuda_ms(torch, lambda: ss.segment_sum_plain(l, v, s), graph=False)
            t["backward_plain_ms"] = cuda_ms(
                torch, lambda: ss.segment_sum_backward_plain(l, cot_b))
            launches = {"forward": graph_launches(torch, lambda: ss.segment_sum(l, v, s)),
                        "backward": graph_launches(
                            torch, lambda: ss.segment_sum_backward(l, cot_b))}
        nbytes, bbytes = k2_bytes(l, s, C), k2_backward_bytes(torch, l, s, C)
        t.update({"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "flop_bound_ms": int(keep.sum()) * C / PEAK_FLOPS["float32"] * 1e3,
                  "backward_bytes": bbytes, "backward_bound_ms": bbytes / HBM_BYTES_PER_S * 1e3,
                  "runs": k2_runs(torch, l, s, B_, C)})
        timing[f"b{B_}"] = t
        log(f"K2, served batch {B_} ({l.numel()} rows, {int(keep.sum())} kept, {s} cells): "
            + ", ".join(f"{k} {x:.4f}" for k, x in t.items() if k.endswith("_ms"))
            + f"; runs {t['runs']}")
    log(f"K2 CUDA launches a call (nodes of a captured graph): {launches}")
    design = {"forward": 2, "backward": 1}  # the memset and the kernel; the gather
    if any(launches[k] > n for k, n in design.items()):
        fail(f"K2 takes more CUDA launches a call than its design's {design}: {launches}")
    sass = k2_sass(_build)
    b1 = timing["b1"]
    RECORD["k2"] = {"checks": checks, "timing": timing, "cuda_launches_per_call": launches,
                    "sass_f32_adds": sass}
    return {
        "name": "segment_sum",
        "route": "cuda",
        "source": "soccdpt_torch/csrc/segment_sum.cu",
        "replaces": "soccdpt_tpu/ops/sorted_segment_sum.py:205",
        "max_abs_err": worst,
        "tolerance": {"rtol": K2_RTOL, "rtol_one_cell": K2_ONE_CELL_RTOL, "atol": K2_ATOL},
        "ms": b1["view_ms"],
        "plain_ms": b1["plain_ms"],
        "library_ms": b1["library_ms"],
        "bound_ms": max(b1["bound_ms"], b1["flop_bound_ms"]),
        "bound_by": "bytes" if b1["bound_ms"] >= b1["flop_bound_ms"] else "operations",
        "backward_ms": b1["backward_ms"],
        "backward_library_ms": b1["index_select_ms"],
        "backward_bound_ms": b1["backward_bound_ms"],
        "launches_per_call": launches["forward"],
        "timed": "one served 1080p frame's keys into the 256x256x32x3 grid, its zero fill "
                 "included, the values the served channel-major view",
        "library": "torch.zeros of the grid, then index_add_ of the rows kept; backward: "
                   "index_select of the kept rows",
    }


# ---------------------------------------------------------------------------
# The decoder's upsample: bf16 2x bilinear, align_corners=True
# ---------------------------------------------------------------------------

# (call, map size, channels) of the six upsamples a batch-6 request of each
# benchmark cell makes: the four refinenets, the depth head after conv1, the
# seg head after conv2
UPSAMPLE_CALLS = {
    "beitl512.rig6.20hz.grid": [("refinenet4", 16, 256), ("refinenet3", 32, 256),
                                ("refinenet2", 64, 256), ("refinenet1", 128, 256),
                                ("depth_head", 256, 128), ("seg_head", 256, 3)],
    "swin2t.backlog.b6.grid": [("refinenet4", 8, 256), ("refinenet3", 16, 256),
                               ("refinenet2", 32, 256), ("refinenet1", 64, 256),
                               ("depth_head", 128, 128), ("seg_head", 128, 3)],
}
UPSAMPLE_BATCH = 6
# the kernel rounds aten's f32 blend once, as aten does: bit for bit but for
# a rare step where the two contract the blend's products differently
UPSAMPLE_BF16_STEPS = 1


def bf16_steps(torch, got, want):
    """(largest distance in bf16 steps, share of elements bit for bit): the
    bit patterns as integers in the order of their values, +0 and -0 both 0."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    d = (ordered(got) - ordered(want)).abs()
    return int(d.max()), float((d == 0).float().mean())


def phase_upsample(torch, F, _build):
    """The upsample op on the card at ``UPSAMPLE_CALLS``: one launch a call
    (the count set to 0 first) within ``UPSAMPLE_BF16_STEPS`` of
    ``upsample2x_plain``; then kernel, plain and library ms by CUDA-graph
    replay beside the bytes bound, summed a request. The first cell's request
    is the entry's; the second's sits beside it."""
    from soccdpt_torch.kernels import upsample as up

    up.upsample2x.launches = 0
    calls, cells, worst, least_equal = [], {}, 0, 1.0
    with torch.no_grad():
        for cell, table in UPSAMPLE_CALLS.items():
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
            for i, (call, n, C) in enumerate(table):
                B = UPSAMPLE_BATCH
                g = torch.Generator(device="cuda").manual_seed(500 + i)
                x = (torch.randn(B, n, n, C, device="cuda", generator=g) * 3).bfloat16()
                before = up.upsample2x.launches
                got = up.upsample2x(x)
                torch.cuda.synchronize()
                if up.upsample2x.launches - before != 1:
                    fail(f"upsample {cell} {call}: the op launched the kernel "
                         f"{up.upsample2x.launches - before} times")
                steps, same = bf16_steps(torch, got, up.upsample2x_plain(x))
                worst, least_equal = max(worst, steps), min(least_equal, same)
                if got.shape != (B, 2 * n, 2 * n, C) or steps > UPSAMPLE_BF16_STEPS:
                    fail(f"upsample {cell} {call} {[B, n, n, C]}: {tuple(got.shape)}, {steps} bf16 "
                         f"steps from F.interpolate")
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                row = {"cell": cell, "call": call, "shape": [B, n, n, C], "max_bf16_steps": steps,
                       "bit_equal_share": same,
                       "ms": cuda_ms(torch, lambda: up.upsample2x(x)),
                       "plain_ms": cuda_ms(torch, lambda: up.upsample2x_plain(x)),
                       "library_ms": cuda_ms(torch, lambda: F.interpolate(
                           x_nchw, size=(2 * n, 2 * n), mode="bilinear", align_corners=True)),
                       "bytes": up.upsample_bytes(B, n, n, C)}
                row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
                row["roofline_share"] = row["bound_ms"] / row["ms"]
                calls.append(row)
                for k in tot:
                    tot[k] += row[k]
                log(f"upsample {cell} {call} {row['shape']}: bit for bit {same:.6f}, at most "
                    f"{steps} step(s); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                    f"NCHW {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                    f"({row['roofline_share']:.1%})")
                del x, x_nchw, got
            tot["bound_ms"] = tot["bytes"] / HBM_BYTES_PER_S * 1e3
            tot["roofline_share"] = tot["bound_ms"] / tot["ms"]
            cells[cell] = tot
            log(f"upsample, a request of {cell}: kernel {tot['ms']:.4f} ms, plain "
                f"{tot['plain_ms']:.4f}, NCHW {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} "
                f"ms ({tot['roofline_share']:.1%} of the roofline)")
        torch.cuda.empty_cache()
        x = torch.randn(UPSAMPLE_BATCH, 64, 64, 256, device="cuda").bfloat16()
        per_call = graph_launches(torch, lambda: up.upsample2x(x))
    ptxas = [line.strip() for line in _build.build_log("upsample").splitlines()
             if "registers" in line or "spill" in line]
    launches = up.upsample2x.launches
    RECORD["upsample"] = {"calls": calls, "requests": cells, "ptxas": ptxas}
    (rig, rig_t), (backlog, backlog_t) = cells.items()
    return {
        "name": "upsample2x", "route": "cuda", "source": "soccdpt_torch/csrc/upsample.cuh",
        "replaces": "none: soccdpt_tpu/ops/resize.py's interpolation matrices, which XLA "
                    "multiplies", "path": "main",
        "max_bf16_steps": worst, "least_bit_equal_share": least_equal,
        "tolerance": f"{UPSAMPLE_BF16_STEPS} bf16 step of upsample2x_plain (F.interpolate)",
        **{k: rig_t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "roofline_share")},
        "bound_by": "bytes",
        "timed": f"the six upsamples of a batch-6 request of {rig}, by CUDA-graph replay",
        "plain": "F.interpolate on the NHWC tensor's NCHW view: aten's NHWC kernel, which the "
                 "served decoder ran before this kernel",
        "library": "F.interpolate on a contiguous NCHW copy: aten's NCHW kernel",
        backlog: {k: backlog_t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "roofline_share")},
        "launches_in_phase": launches, "cuda_launches_per_call": per_call, "ptxas": ptxas,
    }


# ---------------------------------------------------------------------------
# G: the 1080p geometry tail, inverse depth to points and slot keys
# ---------------------------------------------------------------------------

# the benchmark's configurations, whose camera and occupancy values the
# phase takes (benchmark/configs/<name>.json); the first is the entry's
GEOMETRY_CONFIGS = ("soccdpt-v3-swin2t256", "soccdpt-v3-beitl512", "soccdpt-v3-hybrid384")
GEOMETRY_BATCH = 6
# slots that may differ from the plain path's, where cuBLAS's rotation and the
# kernel's FMA chain round a point onto the two sides of a cell's face
GEOMETRY_SLOT_MISMATCH = 1e-5


def geometry_configs(name):
    """(camera, occupancy) of a benchmark configuration's file."""
    from soccdpt_torch.core.config import CameraConfig, OccupancyConfig

    cfg = json.loads((HERE / "benchmark" / "configs" / f"{name}.json").read_text())
    o = cfg["occupancy"]
    return CameraConfig(**cfg["camera"]), OccupancyConfig(
        grid_size=tuple(o["grid_size"]), scale=tuple(o["scale"]), shift=tuple(o["shift"]),
        pc_scale=tuple(o["pc_scale"]), pc_shift=tuple(o["pc_shift"]),
        correction_angle=tuple(o["correction_angle"]))


def phase_geometry(torch, _build):
    """The geometry kernel (the ``soccdpt::unproject_slots`` op) at a batch-6
    1080p request of each ``GEOMETRY_CONFIGS``: one launch a call (the count
    set to 0 first), the points bit for bit and the slots within
    ``GEOMETRY_SLOT_MISMATCH`` of the plain path on the card; then kernel
    and plain ms (the composition the kernel replaced) by CUDA-graph replay,
    with slots and with points alone, beside the bytes bound."""
    from soccdpt_torch.kernels import unproject_slots as us
    from soccdpt_torch.ops import geometry

    us.unproject_slots.launches = 0
    B, (H, W) = GEOMETRY_BATCH, (1080, 1920)
    rows = {}
    with torch.no_grad():
        for i, name in enumerate(GEOMETRY_CONFIGS):
            cam, occ = geometry_configs(name)
            g = torch.Generator(device="cuda").manual_seed(600 + i)
            inv = torch.rand(B, H, W, device="cuda", generator=g) * 0.6 + 0.1

            def plain(slots=True):
                points = geometry.camera_frame_points(inv, cam)
                if not slots:
                    return points
                frame = geometry.occupancy_frame(points.reshape(B, -1, 3), occ)
                return points, geometry.slot_keys(frame, occ)

            before = us.unproject_slots.launches
            points, slot = us.unproject_slots(inv, cam, occ, True)
            torch.cuda.synchronize()
            if us.unproject_slots.launches - before != 1:
                fail(f"geometry {name}: the op launched the kernel "
                     f"{us.unproject_slots.launches - before} times")
            want_points, want_slot = plain()
            equal = torch.equal(points.view(torch.int32), want_points.view(torch.int32))
            mismatch = float((slot != want_slot).float().mean())
            if not equal or mismatch > GEOMETRY_SLOT_MISMATCH:
                fail(f"geometry {name}: points bit for bit {equal}, slots mismatched {mismatch}")
            row = {"config": name, "shape": [B, H, W], "points_bit_equal": equal,
                   "slot_mismatch_share": mismatch,
                   "kept_share": float((want_slot >= 0).float().mean()),
                   "ms": cuda_ms(torch, lambda: us.unproject_slots(inv, cam, occ, True)),
                   "plain_ms": cuda_ms(torch, plain),
                   "points_ms": cuda_ms(torch, lambda: us.unproject_slots(inv, cam, occ, False)),
                   "plain_points_ms": cuda_ms(torch, lambda: plain(False)),
                   "bytes": us.tail_bytes(B, H, W)}
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            row["points_bound_ms"] = us.tail_bytes(B, H, W, slots=False) / HBM_BYTES_PER_S * 1e3
            rows[name] = row
            log(f"geometry {name} {row['shape']}: points bit for bit, slots mismatched "
                f"{mismatch:.3g} (kept {row['kept_share']:.4f}); kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({row['roofline_share']:.1%}); points alone {row['points_ms']:.4f} ms, plain "
                f"{row['plain_points_ms']:.4f}, bound {row['points_bound_ms']:.4f}")
            del points, slot, want_points, want_slot
        per_call = graph_launches(torch, lambda: us.unproject_slots(inv, cam, occ, True))
        del inv
    torch.cuda.empty_cache()
    ptxas = [line.strip() for line in _build.build_log("unproject_slots").splitlines()
             if "registers" in line or "spill" in line]
    RECORD["geometry"] = {"configs": rows, "ptxas": ptxas}
    first, *others = rows.values()
    columns = ("ms", "plain_ms", "bound_ms", "roofline_share")
    return {
        "name": "unproject_slots", "route": "cuda",
        "source": "soccdpt_torch/csrc/unproject_slots.cu",
        "replaces": "none: soccdpt_tpu/ops/geometry.py leaves the tail to XLA, which fuses it",
        "path": "main", "points_bit_equal": all(r["points_bit_equal"] for r in rows.values()),
        "largest_slot_mismatch_share": max(r["slot_mismatch_share"] for r in rows.values()),
        "tolerance": f"points bit for bit, at most {GEOMETRY_SLOT_MISMATCH} of the slots",
        **{k: first[k] for k in columns}, "bound_by": "bytes",
        "timed": f"a batch-{B} 1080p request of {first['config']}, by CUDA-graph replay",
        "plain": "the composition it replaced: camera_frame_points, occupancy_frame, slot_keys",
        **{r["config"]: {k: r[k] for k in columns} for r in others},
        "launches_in_phase": us.unproject_slots.launches, "cuda_launches_per_call": per_call,
        "ptxas": ptxas,
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
    with forward hooks on the depth DPT's residual conv units and on the
    depth head: (model, [(path, module, input, output)] of the RCUs,
    refinenet1's tail input, the head's input)."""
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
    handles.append(dpt.head.register_forward_hook(keep("head")))
    # eager: a hook inside a capture would keep tensors of the graph's pool
    make_serving_fn(cfg, model, compute_occ=False, graph=False)(frames_u8(torch, 1, 300))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    if len(rcus) != 7:
        fail(f"the flagship's depth decoder has {len(rcus)} residual conv units, expected 7")
    return (model, [(p, m, *seen[p]) for p, m in rcus], seen["refinenet1.res_conv_unit2"][0],
            seen["head"][0])


def decoder_kernels():
    from soccdpt_torch.kernels import fused_fusion as ff
    from soccdpt_torch.kernels import fused_head as fh
    from soccdpt_torch.kernels import fused_rcu as fr

    return {"fused_rcu": (fr.fused_rcu, fr.fused_rcu_plain),
            "fused_rcu_tail": (ff.fused_rcu_tail, ff.fused_rcu_tail_plain),
            "fused_head_tail": (fh.fused_head_tail, fh.fused_head_tail_plain)}


def live_cases(torch, F, model, rcus, tail_in, head_in):
    """(kernel, what, its arguments, the reference output, the module's own
    chain as a function of the input) for each live input. An RCU's
    reference is the served module's output. refinenet1's tail and the depth
    head after conv1 are held to their modules' chain with ``F.interpolate``
    as the upsample (``upsample2x_plain``): the served bf16 modules upsample
    through the port's kernel, which K4's and K5's bf16 routes launch too,
    so the reference and the library time stay apart from the code under
    test. In f32 the chain is the served module's own computation. ``up``
    swaps the chain's upsample (``served_chain_ms``)."""
    from soccdpt_torch.kernels.upsample import upsample2x_plain
    from soccdpt_torch.models.layers import conv_nhwc

    block, head = model.depth_net.refinenet1, model.depth_net.head
    rcu2 = block.res_conv_unit2

    def tail_chain(s, up=upsample2x_plain):  # FeatureFusionBlock.forward, no skip, no size
        return up(conv_nhwc(block.out_conv, rcu2(s)))

    def head_tail(m, up=upsample2x_plain):  # DepthHead.forward after conv1
        y = F.relu(conv_nhwc(head.conv2, up(m)))
        return F.relu(conv_nhwc(head.conv3, y))[..., 0]

    with torch.no_grad():
        mid = conv_nhwc(head.conv1, head_in)
        tail_want, head_want = tail_chain(tail_in), head_tail(mid)
    cases = [("fused_rcu", path, (x, *decoder_weights([m.conv1, m.conv2])), y, m)
             for path, m, x, y in rcus]
    cases.append(("fused_rcu_tail", "refinenet1 tail",
                  (tail_in, *decoder_weights([rcu2.conv1, rcu2.conv2, block.out_conv])),
                  tail_want, tail_chain))
    cases.append(("fused_head_tail", "depth head after conv1",
                  (mid, *decoder_weights([head.conv2, head.conv3])), head_want, head_tail))
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


def served_chain_ms(torch, calls):
    """ms of K4's and K5's modules as the served bf16 decoder runs them now:
    their chain with ``ops/resize.upsample2x_hw``, which sends the upsample
    to the port's kernel, summed per kernel over ``calls``."""
    from soccdpt_torch.ops.resize import upsample2x_hw

    out = {}
    with torch.no_grad():
        for name, args, library, count in calls:
            if name in ("fused_rcu_tail", "fused_head_tail"):
                out[name] = out.get(name, 0.0) + count * cuda_ms(
                    torch, lambda: library(args[0], up=upsample2x_hw))
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
    built K1, K3, K4, K5, K6 and K7 libraries: their bf16 route must run on
    the tensor cores, fed by TMA."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("window_attention", "fused_rcu", "fused_fusion", "fused_head",
                 "global_attention", "global_attention_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = {"HGMMA": sass.count("HGMMA"), "UTMALDG": sass.count("UTMALDG")}
        if counts[name]["HGMMA"] == 0 or counts[name]["UTMALDG"] == 0:
            fail(f"the SASS of {name}'s library shows no HGMMA or no UTMALDG: {counts[name]}")
    log(f"tensor cores in the K1, K3-K7 libraries (cuobjdump -sass): {counts}")
    return counts


def device_events(prof):
    """The profile's device operations (kernels, memsets, copies) by key,
    without the GPU user annotations (``Optimizer.step#Adam.step``), whose
    spans cover kernels that are counted on their own rows. Kernel names
    may hold ``#`` (``{lambda()#3}``), so the annotations go by their flag
    and by the optimizer's and the profiler's own prefixes."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith(("Optimizer.", "ProfilerStep#"))]


def cuda_launches(torch, fn):
    """(device operations (kernels, memsets, copies), device µs by operation)
    of one call of ``fn``, from a profile. The kernels' own launch counts
    come from ``graph_launches``: a profile may miss a launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_events(prof)
    return sum(ev.count for ev in rows), {ev.key[:80]: ev.device_time_total for ev in rows}


def graph_launches(torch, fn):
    """CUDA launches (kernels, memsets, copies) of one call of ``fn``: the
    nodes of a CUDA graph that captures it, as `cuGraphGetNodes` counts them."""
    import ctypes

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        fail(f"cuGraphGetNodes returned {rc}")
    return n.value


# the kernels whose launches a served graph holds, by a part of their name
GRAPH_KERNEL_NAMES = {"window_attention": "window_attention_kernel",
                      "global_attention": "global_attention_kernel",
                      "segment_sum": "segment_sum_kernel",
                      "upsample2x": "upsample2x_bf16",
                      "unproject_slots": "unproject_slots_kernel"}
CU_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_census(graph):
    """The nodes of a captured CUDA graph (kept with ``keep_graph=True``),
    read through libcuda: ``{"nodes": n, "by_type": {...}, "kernels":
    {name: nodes}}``, each kernel node named by ``cuFuncGetName`` (or
    ``cuKernelGetName``) and counted under the served kernel it is."""
    import ctypes
    from collections import Counter

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            fail(f"{what} returned libcuda error {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or cu.cuGraphKernelNodeGetParams
    types, kernels = Counter(), Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        types[CU_GRAPH_NODE_TYPES.get(kind.value, str(kind.value))] += 1
        if kind.value != 0:
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: CUfunction func at 0, ..., CUkernel kern at 56
        params = (ctypes.c_byte * 128)()
        ok(get_params(ctypes.c_void_p(node), params), "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        else:
            ok(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)), "cuKernelGetName")
        full = (name.value or b"?").decode()
        for label, part in GRAPH_KERNEL_NAMES.items():
            if part in full:
                kernels[label] += 1
    return {"nodes": n.value, "by_type": dict(types),
            "kernels": {label: kernels.get(label, 0) for label in GRAPH_KERNEL_NAMES}}


# CUDA runtime and libcuda calls that put work on a stream, as the profiler
# records them on the host
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync", "cudaMemcpy2DAsync")


def host_launches(prof):
    """Calls the host made to put work on the card, from a profile."""
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.key.split("_v")[0] in HOST_LAUNCH_CALLS}


def pool_bytes(torch, graph):
    """(reserved, allocated) bytes of the memory pool a captured graph holds."""
    pool = tuple(graph.pool())
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool]
    return sum(seg["total_size"] for seg in segs), sum(seg["allocated_size"] for seg in segs)


def graphed_launches(torch, graphed, names):
    """What the served graphs of ``graphed`` (serving fns) launched: ``(nodes
    by kernel summed over the graphs, launches by kernel over all replays,
    census by graph)``. A wrapper's count ticks at capture, where nothing
    runs, and at the eager warm-up before it."""
    nodes = {name: 0 for name in names}
    replayed = {name: 0 for name in names}
    census = {}
    for label, fn in graphed.items():
        for (shape, _), cap in fn.graphs.items():
            c = graph_census(cap.graph)
            reserved, allocated = pool_bytes(torch, cap.graph)
            census[f"{label} {list(shape)}"] = {**c, "replays": cap.replays,
                                                "warmup_s": cap.warmup_seconds,
                                                "capture_s": cap.capture_seconds,
                                                "pool_reserved_bytes": reserved,
                                                "pool_allocated_bytes": allocated}
            for name in names:
                nodes[name] += c["kernels"].get(name, 0)
                replayed[name] += c["kernels"].get(name, 0) * cap.replays
    return nodes, replayed, census


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
    served = None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        model, rcus, tail_in, head_in = live_decoder(torch, dtype)
        cases = live_cases(torch, F, model, rcus, tail_in, head_in)
        for fn, _ in kernels.values():
            fn.launches = 0
        with torch.no_grad():
            outs = [kernels[name][0](*args) for name, _, args, _, _ in cases]
        torch.cuda.synchronize()
        live[dname] = {name: fn.launches for name, (fn, _) in kernels.items()}
        for (name, what, args, want, _), got in zip(cases, outs):
            record(name, got, want, args[0].shape, f"live {what}, against the module's chain",
                   dname)
        with torch.no_grad():
            per_call[dname], by_op[dname] = {}, {}
            for name, _, args, _, _ in cases:
                if name not in per_call[dname]:
                    _, by_op[dname][name] = cuda_launches(torch, lambda: kernels[name][0](*args))
                    per_call[dname][name] = graph_launches(torch, lambda: kernels[name][0](*args))
        log(f"CUDA launches of one call, live decoder, {dname}: {per_call[dname]}; device µs by "
            f"operation (the first call of each): {by_op[dname]}")
        if dtype == torch.float32:
            grad = k5_gradient(torch, kernels["fused_head_tail"], cases[-1][2])
        else:
            flagship_calls = [(n, a, lib, 1) for n, _, a, _, lib in cases]
            timed = time_calls(torch, kernels, flagship_calls, "live flagship decoder")
            beit = time_calls(torch, kernels, beit_calls(torch, cases),
                              "dpt_beit_large_512's decoder shapes")
            served = {"flagship": served_chain_ms(torch, flagship_calls),
                      "beit_large_batch1": served_chain_ms(torch, beit_calls(torch, cases))}
            log(f"K4's and K5's modules as served, the port's upsample in the chain: {served} ms")
            planner = plan_check(torch, cases[0][2][1:])
        del model, rcus, tail_in, head_in, cases, outs
        torch.cuda.empty_cache()
    if per_call["bfloat16"]["fused_head_tail"] > 3:
        fail(f"a bf16 K5 call made {per_call['bfloat16']['fused_head_tail']} CUDA launches, "
             f"more than prepare, upsample and conv: {by_op['bfloat16']['fused_head_tail']}")
    log(f"decoder kernels' launches on the live decoder: {live}")
    for name in kernels:
        if not all(counts[name] >= 1 for counts in live.values()):
            fail(f"{name} was launched no time on the live decoder")
    RECORD["decoder"] = {"checks": checks, "live_launches": live, "k5_gradient": grad,
                         "timed_flagship_bf16": timed, "timed_beit_large_bf16": beit,
                         "served_chain_ms": served,
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
            "library": "the modules' own chain, bf16 NHWC (cuDNN convs, F.interpolate)",
            "beit_large_batch1": {k: beit[name][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            **({"served_chain_ms": served["flagship"][name],
                "served_chain_ms_beit_large_batch1": served["beit_large_batch1"][name],
                "served_chain": "the module's chain with the port's upsample, as the served "
                                "bf16 decoder runs it"} if name in served["flagship"] else {}),
            "launches": sum(counts[name] for counts in live.values()),
            "launches_by_path": {f"decoder_live_{d}": counts[name] for d, counts in live.items()},
            "cuda_launches_per_call": {d: counts[name] for d, counts in per_call.items()},
        })
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
    # the two served configurations of the benchmark: their decoder's and
    # heads' six bilinear resizes are all 2x and take the upsample kernel
    "swin": {"model_type": "dpt_swin2_tiny_256", "version": 3, "parity_batch": 2,
             "latency_reps": 10,
             "per_request": {"window_attention": 12, "global_attention": 0, "upsample2x": 6,
                             "unproject_slots": 1}},
    "beit": {"model_type": "dpt_beit_large_512", "version": 3, "parity_batch": 1,
             "latency_reps": 10,
             "per_request": {"window_attention": 0, "global_attention": 24, "upsample2x": 6,
                             "unproject_slots": 1}},
    # SOccDPT V1: two whole DPTs, each with its own Swin-V2 trunk
    "swin_v1": {"model_type": "dpt_swin2_tiny_256", "version": 1, "parity_batch": 2,
                "latency_reps": 10,
                "per_request": {"window_attention": 24, "global_attention": 0,
                                "unproject_slots": 1}},
    # SOccDPT V2: one trunk, two heads
    "swin_v2": {"model_type": "dpt_swin2_tiny_256", "version": 2, "parity_batch": 2,
                "latency_reps": 10,
                "per_request": {"window_attention": 12, "global_attention": 0,
                                "unproject_slots": 1}},
    # the ViT-hybrid: a ResNet50 stem and stages, then 12 ViT-B blocks
    "hybrid": {"model_type": "dpt_hybrid_384", "version": 3, "parity_batch": 2,
               "latency_reps": 10,
               "per_request": {"window_attention": 0, "global_attention": 12,
                               "unproject_slots": 1}},
    # the last three families run no attention kernel (their attention is
    # plain PyTorch, as it is plain einsum and softmax in the JAX package):
    # Swin-V1 large at 256 px (padded windows of 12), LeViT-384 at 224 px
    # (BatchNorm trunk, stem transpose before the heads), Next-ViT large at
    # 384 px (40 conv and attention blocks)
    "swin1": {"model_type": "dpt_swin_large_384", "version": 3, "parity_batch": 1,
              "latency_reps": 10,
              "per_request": {"window_attention": 0, "global_attention": 0, "unproject_slots": 1}},
    "levit": {"model_type": "dpt_levit_224", "version": 3, "parity_batch": 2,
              "latency_reps": 10,
              "per_request": {"window_attention": 0, "global_attention": 0, "unproject_slots": 1}},
    "next_vit": {"model_type": "dpt_next_vit_large_384", "version": 3, "parity_batch": 1,
                 "latency_reps": 10, "calibrate_batchnorm": True,
                 "per_request": {"window_attention": 0, "global_attention": 0,
                                 "unproject_slots": 1}},
}
PARITY_ATOL = {"inv_depth": 1e-4, "seg": 1e-4, "points": 5e-3}
GRID_MISMATCH_LIMIT = 0.01
# the refined grid: a point that lands one cell apart moves the head's
# input, so the probabilities are held on average and cell by cell
HEAD_MEAN_ABS_LIMIT, HEAD_CELL_ATOL, HEAD_CELL_SHARE_LIMIT = 1e-3, 1e-2, 0.01
BF16_CACHE_MEAN_ABS_LIMIT = 1e-2


def calibrate_batchnorm(torch, model, cfg, frames):
    """Set every BatchNorm's running statistics to the ones ``frames`` give
    it (a training-mode forward at momentum 1, no gradients), as a trained
    model's would be: a BatchNorm trunk drawn from a seed keeps running
    variances near 1 whatever its activations are, and Next-ViT's 40
    blocks then grow them out of range in eval mode. LeViT's seeded trunk
    serves in range as drawn; calibrated, it would feed its stem transpose,
    whose statistics never train (as in the JAX package), maps that its
    drawn ones do not fit, so it is left as drawn."""
    from soccdpt_torch.data.transforms import device_preprocess

    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(device_preprocess(frames, cfg.net_size), return_raw=True)
    for m in norms:
        m.momentum = 0.1
    model.eval()


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


def compare_served(torch, got, want, where):
    """Two served requests' outputs on the same frames (a graph's against
    the eager path's, a streamed one's against ``serve()``'s, a reloaded
    graph's against a fresh one's): bit for bit expected, §2's ladder the
    bound (K2's atomics add in an order the card chooses, so the grid is
    held by its mass)."""
    out = {}
    for name, g, w in zip(PARITY_ATOL, got, want):
        err = float((g.float() - w.float()).abs().max())
        out[name] = {"bit_equal": bool(torch.equal(g, w)), "max_abs_err": err,
                     "atol": PARITY_ATOL[name]}
        if not err <= PARITY_ATOL[name]:
            fail(f"{where}: {name} differs by {err}")
    if (got[3] is None) != (want[3] is None):
        fail(f"{where}: one path returned a grid and the other none")
    if want[3] is not None:
        mass = float(want[3].sum())
        mism = float((got[3] - want[3]).abs().sum()) / max(mass, 1e-30)
        out["grid"] = {"bit_equal": bool(torch.equal(got[3], want[3])),
                       "max_abs_err": float((got[3] - want[3]).abs().max()),
                       "mismatched_mass_share": mism, "limit": GRID_MISMATCH_LIMIT}
        if not (mass > 0 and mism < GRID_MISMATCH_LIMIT):
            fail(f"{where}: the grids differ ({mism} of the mass)")
    return out


def time_requests(torch, fn, frames, reps):
    """Host ms per request ending in a synchronize, after 3 warm-ups."""
    for i in range(3):
        fn(frames[i % len(frames)])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(frames[i % len(frames)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"mean_ms": float(np.mean(times)), "median_ms": float(np.median(times)),
            "min_ms": float(np.min(times))}


def profile_requests(torch, fn, frame, n=5):
    """Device operations of ``n`` requests by key, per request: ([(key, µs,
    count)] sorted by time, host calls that put work on the card)."""
    from torch.profiler import ProfilerActivity, profile

    fn(frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(frame)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.device_time_total / n, ev.count / n) for ev in device_events(prof)]
    rows.sort(key=lambda r: -r[1])
    return rows, {k: c / n for k, c in host_launches(prof).items()}


def weight_reload_check(torch, cfg16, same_weights, label):
    """After a first graph request, other weights come in through
    ``load_state_dict``: the next request of the same serving fn must
    recapture and equal a freshly bound serving fn's output."""
    from soccdpt_torch.models.soccdpt import SOccDPT_versions, build_model
    from soccdpt_torch.serving import make_serving_fn

    model = same_weights(cfg16)
    served = make_serving_fn(cfg16, model, compute_occ=True)
    frame = frames_u8(torch, 1, 3000)
    first = served(frame)
    other = build_model(cfg16, device="cuda", seed=1)
    with torch.no_grad():
        head = other.depth_net.head if cfg16.version != 2 else other.depth_head
        head.conv3.weight.mul_(0.01)
        head.conv3.bias.fill_(0.3)
    new_weights = other.state_dict()
    del other
    t0 = time.perf_counter()
    model.load_state_dict(new_weights)
    second = served(frame)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fresh = SOccDPT_versions[cfg16.version](cfg16)
    fresh.load_state_dict(new_weights)
    want = make_serving_fn(cfg16, fresh, compute_occ=True)(frame)
    out = {"recaptures": served.recaptures,
           "against_fresh": compare_served(torch, second, want, f"{label} weight reload"),
           "inv_depth_moved_by": float((first[0] - second[0]).abs().max()),
           "load_and_request_s": seconds}
    log(f"{label} weight reload through load_state_dict: {out}")
    if served.recaptures != 1:
        fail(f"{label}: the weight load made {served.recaptures} recaptures, expected 1")
    if not out["inv_depth_moved_by"] > 0:
        fail(f"{label}: the request after the weight load served the old weights")
    return out


def train_mode_check(torch, cfg16, same_weights, label):
    """A graph request, ``model.train()``, the same request again: bit for
    bit what was served before (the grid by its mass: K2's atomics add in
    an order the card chooses), no recapture, the BatchNorm statistics as
    they were, and the model left in training mode."""
    from soccdpt_torch.serving import make_serving_fn

    model = same_weights(cfg16)
    served = make_serving_fn(cfg16, model, compute_occ=True)
    frame = frames_u8(torch, 1, 3100)
    first = served(frame)
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    model.train()
    second = served(frame)
    torch.cuda.synchronize()
    moved = [n for n, b in model.named_buffers() if n in stats and not torch.equal(b, stats[n])]
    out = {"against_eval_mode": compare_served(torch, second, first, f"{label} after train()"),
           "recaptures": served.recaptures, "batch_norm_buffers": len(stats),
           "batch_norm_buffers_moved": moved,
           "left_in_training_mode": all(m.training for m in model.modules())}
    log(f"{label} a graph request after model.train(): {out}")
    if not all(v["bit_equal"] for k, v in out["against_eval_mode"].items() if k != "grid"):
        fail(f"{label}: a request after model.train() served other outputs")
    if served.recaptures or moved or not stats or not out["left_in_training_mode"]:
        fail(f"{label}: model.train() between two requests: {out}")
    return out


def phase_serving(torch, card, label):
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.kernels.unproject_slots import unproject_slots
    from soccdpt_torch.kernels.upsample import upsample2x
    from soccdpt_torch.models.soccdpt import SOccDPT_versions, build_model
    from soccdpt_torch.ops.geometry import occupancy_slots, rotate_points
    from soccdpt_torch.serving import GraphedFunction, make_serving_fn
    from soccdpt_torch.weights import init_random_

    spec = SERVED[label]
    record = RECORD.setdefault(label, {"model_type": spec["model_type"]})
    counters = {"window_attention": wa.window_attention,
                "global_attention": ga.global_attention, "segment_sum": ss.segment_sum,
                "upsample2x": upsample2x, "unproject_slots": unproject_slots}
    cfg = ModelConfig(model_type=spec["model_type"], version=spec["version"])
    t0 = time.perf_counter()
    base = build_model(cfg, device="cuda", seed=0)
    if spec.get("calibrate_batchnorm"):
        calibrate_batchnorm(torch, base, cfg, frames_u8(torch, 2, 99))
    with torch.no_grad():
        # keep inv_depth in a band where depth = 1/inv stays well conditioned
        head = base.depth_net.head if cfg.version != 2 else base.depth_head
        head.conv3.weight.mul_(0.01)
        head.conv3.bias.fill_(0.3)
    probe = make_serving_fn(cfg, base, graph=False)(frames_u8(torch, 1, 100))
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

    # --- the main path: bf16 serving through CUDA graphs, counts from 0 -----
    serve = {occ: make_serving_fn(cfg16, model16, compute_occ=occ) for occ in (False, True)}
    if not all(isinstance(fn, GraphedFunction) for fn in serve.values()):
        fail(f"{label}: make_serving_fn did not serve through CUDA graphs on the card")
    runs = [(1, False), (1, True), (2, False), (2, True)]
    requests = 2
    for fn in counters.values():
        fn.launches = 0
    upsample2x.fallbacks = unproject_slots.fallbacks = 0
    outs = {}
    t0 = time.perf_counter()
    for B, occ in runs:
        for r in range(requests):
            outs[(B, occ)] = serve[occ](frames_u8(torch, B, 10 * B + r))
    torch.cuda.synchronize()
    main_path_s = time.perf_counter() - t0
    ticks = {name: fn.launches for name, fn in counters.items()}
    # bilinear align_corners=True resizes the graphs' warm-ups and captures
    # left to F.interpolate (a replay runs no Python)
    fallbacks = upsample2x.fallbacks
    # geometry tails the warm-ups and captures left to the plain path
    geometry_fallbacks = unproject_slots.fallbacks
    nodes, replayed, census = graphed_launches(
        torch, {f"occ={occ}": fn for occ, fn in serve.items()}, counters)
    # a wrapper ticks at a graph's eager warm-up, which launches, and at its
    # capture, which launches nothing; the replays launch the graph's nodes
    launches = {name: ticks[name] - nodes[name] + replayed[name] for name in counters}
    forwards = requests * len(runs)
    per_graph = dict(spec["per_request"])
    per_graph["segment_sum"] = 1
    graphs_with = {name: len(runs) for name in per_graph}
    graphs_with["segment_sum"] = sum(occ for _, occ in runs)
    record["main_path"] = {"requests": forwards, "seconds": main_path_s, "wrapper_counts": ticks,
                           "graph_kernel_nodes": nodes, "replayed": replayed,
                           "launched": launches, "graphs": census,
                           "upsample_fallbacks_at_capture": fallbacks,
                           "geometry_fallbacks_at_capture": geometry_fallbacks}
    log(f"{label} main path: {forwards} graph requests in {main_path_s:.1f} s (captures "
        f"included); kernel nodes {nodes}, replayed {replayed}, launched {launches} "
        f"(wrapper counts {ticks}); bilinear resizes left to F.interpolate at warm-up and "
        f"capture {fallbacks}")
    if "upsample2x" in per_graph and fallbacks:
        fail(f"{label}: {fallbacks} bilinear align_corners=True resizes left the upsample kernel")
    if geometry_fallbacks:
        fail(f"{label}: {geometry_fallbacks} geometry tails left the geometry kernel")
    for name, n in per_graph.items():
        want_nodes = n * graphs_with[name]
        want_replayed = n * requests * graphs_with[name]
        if nodes[name] != want_nodes or replayed[name] != want_replayed:
            fail(f"{label}: the graphs hold {nodes[name]} {name} nodes replayed into "
                 f"{replayed[name]} launches, expected {want_nodes} and {want_replayed}")
        if ticks[name] != 2 * nodes[name]:
            fail(f"{label}: {name}'s count {ticks[name]} is not its warm-ups and captures "
                 f"({2 * nodes[name]})")
    if sorted(len(fn.graphs) for fn in serve.values()) != [2, 2] or any(
            cap.replays != requests for fn in serve.values() for cap in fn.graphs.values()):
        fail(f"{label}: expected one graph a batch size, replayed once a request: {census}")
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

    # --- the graphs' outputs against the eager path's, on the same frames ----
    eager = {occ: make_serving_fn(cfg16, model16, compute_occ=occ, graph=False)
             for occ in (False, True)}
    # binding a second serving fn to the model must leave the graphs' bias
    # caches in place, or every graph request after it recaptures
    if not all(fn.weights.current() for fn in serve.values()):
        fail(f"{label}: binding an eager serving fn changed what the graphs read")
    versus = {}
    for (B, occ), got in outs.items():
        want = eager[occ](frames_u8(torch, B, 10 * B + requests - 1))
        versus[f"b{B}_occ{int(occ)}"] = compare_served(torch, got, want,
                                                       f"{label} batch {B} occ={occ}")
    torch.cuda.synchronize()
    record["graph_vs_eager_bf16"] = versus
    log(f"{label} graph against eager, bf16: " + "; ".join(
        f"{k}: " + ", ".join(f"{n} {'equal' if v['bit_equal'] else 'max|err| %.3g' % v['max_abs_err']}"
                             for n, v in cmp.items()) for k, cmp in versus.items()))
    del outs, want

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
        head_fn = make_serving_fn(cfg_head, head_model, compute_occ=True)
        got = head_fn(frames)
        nodes, replayed, _ = graphed_launches(torch, {"head": head_fn}, ["global_attention"])
        if replayed["global_attention"] != 24 or (
                ga.global_attention.launches - before != 2 * nodes["global_attention"]):
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
        del cpu_model, head_model, head_fn, want, got
    del model32
    set_tf32(torch, True)

    # --- graph against eager, bf16: latency (host clock ending in a
    # synchronize), device time, launches, capture, pools --------------------
    latency, latency_eager = {}, {}
    for B, occ in runs:
        frames = [frames_u8(torch, B, 1000 + i) for i in range(4)]
        key = f"b{B}_occ{int(occ)}"
        latency[key] = time_requests(torch, serve[occ], frames, spec["latency_reps"])
        latency_eager[key] = time_requests(torch, eager[occ], frames, spec["latency_reps"])
        log(f"{label} served bf16 batch {B} occ={occ}: graph {latency[key]['median_ms']:.3f} ms/"
            f"request median, eager {latency_eager[key]['median_ms']:.3f} ({card})")
    record["latency_bf16"] = latency
    record["latency_bf16_eager"] = latency_eager
    if any(fn.recaptures for fn in serve.values()):
        fail(f"{label}: graph requests after the eager binding recaptured: "
             f"{[fn.recaptures for fn in serve.values()]}")
    del frames

    fn = serve[True]
    frame = frames_u8(torch, 1, 2000)
    rows, host_calls = profile_requests(torch, fn, frame)
    rows_e, host_calls_e = profile_requests(torch, eager[True], frame)
    # device-side events only (kernels, memcpy, memset), so nothing is
    # counted twice through the operator that launched it
    device_ms = sum(us for _, us, _ in rows) / 1e3
    record["served_kernel_device_ms_b1_occ"] = {
        name: sum(us for k, us, _ in rows if GRAPH_KERNEL_NAMES[name] in k) / 1e3
        for name in counters}
    log(f"{label}, in the served request: {record['served_kernel_device_ms_b1_occ']} ms of "
        f"device time")
    record["profile_b1_occ_us_per_request"] = [
        {"name": k[:120], "device_us": us, "calls": c} for k, us, c in rows[:40]]
    wall = latency["b1_occ1"]["median_ms"]
    record["device_ms_per_request_b1_occ"] = device_ms
    record["launches_per_request_b1_occ"] = sum(c for _, _, c in rows)
    record["host_calls_per_request_b1_occ"] = host_calls
    (cap,) = [c for (shape, _), c in fn.graphs.items() if shape[0] == 1]
    nodes_b1 = graph_census(cap.graph)
    reserved, allocated = pool_bytes(torch, cap.graph)
    device_ms_e = sum(us for _, us, _ in rows_e) / 1e3
    wall_e = latency_eager["b1_occ1"]["median_ms"]
    # what the graph path adds to a request: the copies out of the pool and
    # the weight check on the host
    outputs = [o for o in cap.outputs if o is not None]
    copy_out_ms = cuda_ms(torch, lambda: [o.clone() for o in outputs])
    t0 = time.perf_counter()
    for _ in range(200):
        current = fn.weights.current()
    check_us = (time.perf_counter() - t0) / 200 * 1e6
    if not current:
        fail(f"{label}: the served weights read as changed")
    record["graph_against_eager_b1_occ"] = {
        "graph": {"wall_median_ms": wall, "device_ms": device_ms,
                  "device_ops": record["launches_per_request_b1_occ"],
                  "host_calls": sum(host_calls.values()), "host_calls_by_name": host_calls,
                  "graph_nodes": nodes_b1["nodes"], "graph_nodes_by_type": nodes_b1["by_type"],
                  "warmup_s": cap.warmup_seconds, "capture_s": cap.capture_seconds,
                  "pool_reserved_bytes": reserved, "pool_allocated_bytes": allocated,
                  "copy_out_device_ms": copy_out_ms,
                  "copy_out_bytes": sum(o.numel() * o.element_size() for o in outputs),
                  "weight_check_host_us": check_us, "busy_share": device_ms / wall},
        "eager": {"wall_median_ms": wall_e, "device_ms": device_ms_e,
                  "device_ops": sum(c for _, _, c in rows_e),
                  "host_calls": sum(host_calls_e.values()), "host_calls_by_name": host_calls_e,
                  "busy_share": device_ms_e / wall_e}}
    g, e = record["graph_against_eager_b1_occ"]["graph"], record["graph_against_eager_b1_occ"]["eager"]
    log(f"{label} bf16 batch 1 occ, graph against eager ({card}): wall {wall:.3f} / "
        f"{wall_e:.3f} ms; device {device_ms:.3f} / {device_ms_e:.3f} ms; host calls a request "
        f"{g['host_calls']:.0f} / {e['host_calls']:.0f}; device ops {g['device_ops']:.0f} / "
        f"{e['device_ops']:.0f}; graph nodes {g['graph_nodes']} {g['graph_nodes_by_type']}; "
        f"warm-up {cap.warmup_seconds:.2f} s, capture {cap.capture_seconds:.2f} s; pool "
        f"{reserved / 2**20:.0f} MiB reserved ({allocated / 2**20:.0f} allocated); copy-out "
        f"{copy_out_ms:.4f} ms of device time; weight check {check_us:.1f} us on the host; "
        f"busy share {g['busy_share']:.3f} / {e['busy_share']:.3f}; top device time per request:")
    for k, us, c in rows[:12]:
        log(f"  {us:9.1f} us  x{c:5.1f}  {k[:90]}")

    if label == "swin":
        record["weight_reload"] = weight_reload_check(torch, cfg16, same_weights, label)
    if label in ("swin", "swin_v1"):
        record["train_mode"] = train_mode_check(torch, cfg16, same_weights, label)

    # the served frames' own segment-sum problems for K2: a batch-2 request
    # and its first frame alone, the values the served (B, N, C) views
    with torch.inference_mode():
        inv, seg, pts, _ = fn(torch.cat([frame, frames_u8(torch, 1, 2001)]))
        occ_cfg = cfg32.occupancy
        p = pts.reshape(2, -1, 3)
        p = p * torch.tensor(occ_cfg.pc_scale, device="cuda") + torch.tensor(
            occ_cfg.pc_shift, device="cuda")
        p = rotate_points(p, occ_cfg.correction_angle)
        sem = seg.reshape(2, 3, -1).transpose(1, 2)
        problem = {2: occupancy_slots(p, sem, occ_cfg, 3),
                   1: occupancy_slots(p[:1], sem[:1], occ_cfg, 3),
                   "geometry": (occ_cfg, p[:1].cpu())}

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
# serve_stream on the flagship
# ---------------------------------------------------------------------------

STREAM_FRAMES = 50
STREAM_DEPTHS = (1, 2, 3)
STREAM_COPY_REPS = 10
# PERF.md §2: the reference's 47 Hz as a rate, and as a p99 at depth 1
STREAM_RATE_LIMIT, STREAM_P99_LIMIT_MS = 47.0, 1e3 / 47.0


def stream_copy_times(torch, frames):
    """Host and device ms of moving one pageable 1080p frame: the pinned
    put (a host memcpy into pinned memory and the start of the copy), the
    pinned copy's device time on a side stream, and a blocking pageable
    ``.to()``, medians of ``STREAM_COPY_REPS``."""
    from soccdpt_torch.data.loader import pinned_put

    put, side = pinned_put("cuda"), torch.cuda.Stream()
    host, device, pageable = [], [], []
    for f in frames[:STREAM_COPY_REPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = put(f)
        host.append((time.perf_counter() - t0) * 1e3)
        staged.result()
        torch.cuda.synchronize()
        pinned = torch.from_numpy(f).pin_memory()
        out = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            out.copy_(pinned, non_blocking=True)
            end.record(side)
        end.synchronize()
        device.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        torch.from_numpy(f).to("cuda")
        pageable.append((time.perf_counter() - t0) * 1e3)
    nbytes = frames[0].nbytes
    out = {"frame_bytes": nbytes, "pinned_put_host_ms": float(np.median(host)),
           "pinned_copy_device_ms": float(np.median(device)),
           "pinned_copy_gb_per_s": nbytes / float(np.median(device)) / 1e6,
           "pageable_to_ms": float(np.median(pageable)),
           "pageable_gb_per_s": nbytes / float(np.median(pageable)) / 1e6}
    log(f"stream: a {nbytes / 1e6:.1f} MB frame: pinned put {out['pinned_put_host_ms']:.3f} ms on "
        f"the host, its copy {out['pinned_copy_device_ms']:.3f} ms on the card "
        f"({out['pinned_copy_gb_per_s']:.1f} GB/s); pageable .to() {out['pageable_to_ms']:.3f} ms "
        f"({out['pageable_gb_per_s']:.1f} GB/s)")
    return out


def phase_stream(torch, card):
    """``serving.serve_stream`` on the flagship V3, bf16, batch 1, with and
    without the grid: ``STREAM_FRAMES`` pageable uint8 1080p frames from a
    seed at each depth, with the host thread and fed serially, each output
    held to ``serve()`` of its frame; frames/s, latency from a frame's
    hand-over to its output's readiness, the share of the run the serving
    stream was busy (CUDA events around each request)."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.models.soccdpt import SOccDPT_versions, build_model
    from soccdpt_torch.serving import make_serving_fn, serve_stream

    record = RECORD.setdefault("stream_swin", {"model_type": "dpt_swin2_tiny_256", "batch": 1})
    cfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3)
    base = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():  # as phase_serving: inverse depth in a well-conditioned band
        base.depth_net.head.conv3.weight.mul_(0.01)
        base.depth_net.head.conv3.bias.fill_(0.3)
    probe = make_serving_fn(cfg, base, graph=False)(frames_u8(torch, 1, 100))
    cfg16 = dataclasses.replace(calibrated(cfg, probe[2]), compute_dtype="bfloat16")
    model = SOccDPT_versions[3](cfg16)
    model.load_state_dict(base.state_dict())
    del base, probe
    rng = np.random.default_rng(50)
    frames = [rng.integers(0, 256, (1, 1080, 1920, 3), dtype=np.uint8)
              for _ in range(STREAM_FRAMES)]
    record["copy"] = stream_copy_times(torch, frames)

    class Timed:
        """The serving fn with CUDA events around each request on its stream."""

        def __init__(self, fn):
            self.fn, self.device, self.events = fn, fn.device, []

        def __call__(self, x):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.fn(x)
            end.record()
            self.events.append((start, end))
            return out

        def busy_s(self):
            return sum(s.elapsed_time(e) for s, e in self.events) / 1e3

    counters = {"window_attention": wa.window_attention, "segment_sum": ss.segment_sum}
    for fn in counters.values():
        fn.launches = 0
    serve = {occ: make_serving_fn(cfg16, model, compute_occ=occ) for occ in (False, True)}
    runs, requests, misses = {}, 0, []
    for occ in (False, True):
        want = [serve[occ](f) for f in frames]
        requests += len(frames)
        # an untimed run first: the allocator reserves the memory a run's
        # outputs hold once, before any timed run
        warm = list(serve_stream(serve[occ], iter(frames), depth=max(STREAM_DEPTHS)))
        requests += len(frames)
        del warm
        # host thread and serial in turns, twice each (thread, serial,
        # serial, thread), the runs of a key recorded in order
        for depth in STREAM_DEPTHS:
            for thread in (True, False, False, True):
                timed, handed, ready = Timed(serve[occ]), [], []

                def source():
                    for f in frames:
                        handed.append(time.perf_counter())
                        yield f

                outs = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for out in serve_stream(timed, source(), depth=depth,
                                        host_prefetch=2 if thread else None):
                    ready.append(time.perf_counter())
                    outs.append(out)
                wall = time.perf_counter() - t0
                requests += len(frames)
                if len(outs) != len(frames):
                    fail(f"stream: {len(outs)} outputs for {len(frames)} frames")
                cmps = [compare_served(torch, g, w, f"stream frame {i} depth {depth}")
                        for i, (g, w) in enumerate(zip(outs, want))]
                lat = (np.array(ready) - np.array(handed)) * 1e3
                key = f"occ{int(occ)}_depth{depth}_{'thread' if thread else 'serial'}"
                r = {"frames_per_s": len(frames) / wall, "wall_s": wall,
                     "latency_p50_ms": float(np.percentile(lat, 50)),
                     "latency_p99_ms": float(np.percentile(lat, 99)),
                     "busy_share": timed.busy_s() / wall,
                     "bit_equal_frames": sum(all(c[n]["bit_equal"] for n in PARITY_ATOL)
                                             for c in cmps),
                     "grid_max_mismatch": max((c["grid"]["mismatched_mass_share"]
                                               for c in cmps if "grid" in c), default=0.0)}
                runs.setdefault(key, []).append(r)
                if r["frames_per_s"] < STREAM_RATE_LIMIT or (
                        depth == 1 and r["latency_p99_ms"] >= STREAM_P99_LIMIT_MS):
                    misses.append(f"{key} run {len(runs[key])}")
                log(f"stream occ={occ} depth {depth} {'host thread' if thread else 'serial'}: "
                    f"{r['frames_per_s']:.1f} frames/s, latency p50 {r['latency_p50_ms']:.3f} "
                    f"p99 {r['latency_p99_ms']:.3f} ms, busy share {r['busy_share']:.3f}, "
                    f"{r['bit_equal_frames']}/{len(frames)} frames bit for bit ({card})")
                del outs
        del want
    torch.cuda.synchronize()
    ticks = {name: fn.launches for name, fn in counters.items()}
    nodes, replayed, census = graphed_launches(
        torch, {f"occ={occ}": fn for occ, fn in serve.items()}, counters)
    launches = {name: ticks[name] - nodes[name] + replayed[name] for name in counters}
    record.update({"frames": STREAM_FRAMES, "runs": runs, "requests": requests,
                   "launched": launches, "graphs": census,
                   "limits": {"frames_per_s": STREAM_RATE_LIMIT,
                              "p99_ms_at_depth_1": STREAM_P99_LIMIT_MS},
                   "limit_misses": misses})
    log(f"stream: runs that miss PERF.md §2's limits ({STREAM_RATE_LIMIT} frames/s; p99 under "
        f"{STREAM_P99_LIMIT_MS:.1f} ms at depth 1): {misses or 'none'}")
    log(f"stream: {requests} graph requests, kernel nodes {nodes}, launched {launches}")
    want_n = {"window_attention": 12 * requests, "segment_sum": requests // 2}
    for name, n in want_n.items():
        if replayed[name] != n:
            fail(f"stream: {name} replayed {replayed[name]} times in {requests} requests, "
                 f"expected {n}")
    return launches


# ---------------------------------------------------------------------------
# the timing CLIs on the card
# ---------------------------------------------------------------------------

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch", "hz_std", "ms_per_forward",
              "ms_std", "raw_net_hz", "raw_net_ms", "device")
TIMED_SERVED = ((["dpt_swin2_tiny_256", "dpt_beit_large_512", "dpt_hybrid_384",
                  "dpt_swin_large_384", "dpt_levit_224", "dpt_next_vit_large_384"], 3),
                (["dpt_swin2_tiny_256"], 1), (["dpt_swin2_tiny_256"], 2))
PATCHWISE_ARGS = ["-t", "dpt_swin2_tiny_256", "-v", "3", "--batch_sizes", "1", "2", "4",
                  "--patchwise", "1.0", "0.5", "0.25", "--encoder_pct", "0.5"]


def json_lines(fn, *args):
    """Run a CLI's ``main`` and return the JSON objects it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def phase_clis(torch, card):
    """``python -m soccdpt_torch.cli.bench`` (through its ``main``),
    ``eval_timing --contract full`` and ``--contract occ`` for the eight
    served configurations, and ``eval_patchwise`` on the flagship."""
    from soccdpt_torch.cli import bench, eval_patchwise, eval_timing

    record = RECORD.setdefault("clis", {})
    kind = torch.cuda.get_device_name(0)
    rows = json_lines(bench.main)
    if len(rows) != 1 or any(k not in rows[0] for k in BENCH_KEYS):
        fail(f"bench printed {rows}, expected one line with {BENCH_KEYS}")
    row = rows[0]
    log(f"bench: {json.dumps(row)} ({card})")
    if not (row["value"] > 0 and row["raw_net_hz"] > 0 and row["device"] == kind):
        fail(f"bench: {row}")
    record["bench"] = row

    timing = []
    for contract in ("full", "occ"):
        for types, version in TIMED_SERVED:
            got = json_lines(eval_timing.main, ["-t", *types, "-v", str(version),
                                                "--contract", contract, "--json"])
            if [r["model_type"] for r in got] != types or not all(
                    r["hz"] > 0 and r["device"] == kind for r in got):
                fail(f"eval_timing -v {version} --contract {contract}: {got}")
            for r in got:
                r["version"] = version
                log(f"eval_timing: {json.dumps(r)}")
            timing += got
    record["eval_timing"] = timing

    rows = json_lines(eval_patchwise.main, PATCHWISE_ARGS)
    for r in rows:
        log(f"eval_patchwise: {json.dumps(r)}")
    patches = {1.0: 1, 0.5: 2, 0.25: 4}
    if len(rows) != 9 or any("error" in r or r["n_patches"] != patches[r["patchwise_pct"]]
                             or not r["step_peak_bytes"] > r["allocated_before_step_bytes"] > 0
                             for r in rows):
        fail(f"eval_patchwise: {rows}")
    record["eval_patchwise"] = rows


# ---------------------------------------------------------------------------
# ViT3D, the standalone volumetric refiner
# ---------------------------------------------------------------------------

VIT3D_ATOL = 2e-5  # refined probabilities, card against CPU, f32, TF32 off


def phase_vit3d(torch, card):
    """ViT3D on a full 256 x 256 x 32 grid of 3 classes ((16, 16, 8)
    patches: 1,024 tokens and a class token, width 256, four blocks),
    weights from a numpy seed: one ``refine`` forward in f32 on the card
    against the CPU's, TF32 off; then its time in f32 and bf16 by graph
    replay. No model calls it, as in the JAX package."""
    from soccdpt_torch.models.backbones import make_backbone
    from soccdpt_torch.weights import init_random_

    record = RECORD.setdefault("vit3d", {})
    factory, _ = make_backbone("vit_3d")
    model = init_random_(factory(), seed=0).eval()
    grid = torch.rand((1, 256, 256, 32, 3), generator=torch.Generator().manual_seed(0))
    set_tf32(torch, False)
    with torch.no_grad():
        t0 = time.perf_counter()
        want = model(grid)
        cpu_s = time.perf_counter() - t0
        model = model.cuda()
        grid_card = grid.cuda()
        got = model(grid_card)
        err = float((got.cpu() - want).abs().max())
        spread = float(want.max() - want.min())
        record.update({"grid": list(grid.shape), "max_abs_err": err, "atol": VIT3D_ATOL,
                       "spread": spread, "cpu_seconds": cpu_s,
                       "weights": sum(p.numel() for p in model.parameters())})
        log(f"vit3d refine, card vs CPU (f32, TF32 off): max |err| {err:.3g} (atol "
            f"{VIT3D_ATOL}), probabilities spread over {spread:.3f}; the CPU took "
            f"{cpu_s:.1f} s")
        if tuple(got.shape) != (1, 256, 256, 32, 3) or not bool(torch.isfinite(got).all()):
            fail(f"vit3d: bad refined grid {tuple(got.shape)}")
        if not (err <= VIT3D_ATOL and spread > 0.05):
            fail("vit3d: the card's refined grid left the CPU's")
        set_tf32(torch, True)
        times = {dtype: cuda_ms(torch, lambda: model(grid_card, getattr(torch, dtype)))
                 for dtype in ("float32", "bfloat16")}
    record["ms"] = times
    log(f"vit3d refine, batch 1: {times['float32']:.3f} ms in f32 (TF32 on), "
        f"{times['bfloat16']:.3f} ms in bf16 by graph replay ({card})")


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
    # the last three families, V3 at batch 2; LeViT's and Next-ViT's
    # BatchNorms train on the batch's statistics
    "swin1": {"model_type": "dpt_swin_large_384", "version": 3, "batch": 2,
              "encoder_percentage": 0.5,
              "per_step": {"window_attention": 0, "global_attention": 0,
                           "global_attention_backward": 0}},
    "levit": {"model_type": "dpt_levit_224", "version": 3, "batch": 2,
              "encoder_percentage": 0.5, "nudged_spread": True,
              "per_step": {"window_attention": 0, "global_attention": 0,
                           "global_attention_backward": 0}},
    "next_vit": {"model_type": "dpt_next_vit_large_384", "version": 3, "batch": 2,
                 "encoder_percentage": 0.5, "nudged_spread": True,
                 "per_step": {"window_attention": 0, "global_attention": 0,
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
# every BatchNorm's running statistics after the f32 loss's forward, card
# against CPU, each leaf's |s_card - s_cpu| / |s_cpu| (2-norms): the batch's
# statistics through a trunk of training-mode BatchNorms (the CPU tests of
# LeViT and Next-ViT hold them to 3e-5 against JAX at 64-128 px)
TRAIN_STATS_REL_LIMIT = 1e-3
# A trunk of training-mode BatchNorms (LeViT, Next-ViT) is ill-conditioned
# at batch 2: a relative nudge of 1e-7 of the image (one f32 rounding) moves
# the CPU's own f32 gradients by about as much as the card's differ from
# them (PERF.md), and a float64 CPU run lies as far from the card's f32
# gradients as from the CPU's. There each leaf's bound adds this many times
# the CPU's own spread under that nudge, for gradients and statistics alike.
TRAIN_SPREAD_FACTOR = 4.0


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


def f32_parity(torch, label, mcfg, base, batch, record, nudged_spread=False):
    """One f32 loss of ``batch`` and its gradients on the card against the
    CPU's through the plain versions, TF32 off (the trainer's first patch
    mask trainable): the loss to ``TRAIN_LOSS_RTOL``, every leaf's gradient
    to ``TRAIN_GRAD_REL_LIMIT`` of its norm, every BatchNorm statistic after
    the forward to ``TRAIN_STATS_REL_LIMIT``; with ``nudged_spread`` each
    bound adds ``TRAIN_SPREAD_FACTOR`` times the CPU's own spread under one
    rounding of the image."""
    from soccdpt_torch.core.config import TrainConfig
    from soccdpt_torch.train.trainer import Trainer
    from soccdpt_torch.weights import named_flax_params

    set_tf32(torch, False)
    t0 = time.perf_counter()
    trainer = Trainer(mcfg, TrainConfig(**base))
    trainer.init_state(seed=0)
    log(f"train {label}: SOccDPT V{mcfg.version} {mcfg.model_type} built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M weights, "
        f"{sum(trainer.masks[0].values())} of {len(trainer.masks[0])} leaves trainable")
    cpu = Trainer(mcfg, TrainConfig(**base), device="cpu")
    # copied before the card's forward moves the running statistics
    cpu.masks, cpu.model = trainer.masks, copy.deepcopy(trainer.model).cpu()
    nudged = None
    if nudged_spread:
        nudged = Trainer(mcfg, TrainConfig(**base), device="cpu")
        nudged.masks, nudged.model = trainer.masks, copy.deepcopy(cpu.model)
    loss_card = loss_and_grads(trainer, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_cpu = loss_and_grads(cpu, batch)
    cpu_seconds = time.perf_counter() - t0
    if nudged is not None:
        # the CPU again, on the image times 1 + 1e-7 N(0, 1): one f32 rounding
        rng = np.random.default_rng(1)
        image = batch["image"] * (1 + 1e-7 * rng.standard_normal(batch["image"].shape))
        loss_and_grads(nudged, dict(batch, image=image.astype(np.float32)))
    backbone = next(m for n, m in trainer.model.named_modules() if n.endswith("backbone"))
    depth = getattr(backbone.cfg, "depth", None)
    log(f"train {label}: CPU loss and gradients in {cpu_seconds:.1f} s at full width and "
        f"depth{f' ({depth} blocks)' if depth else ''}")
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    models = [trainer.model, cpu.model] + ([nudged.model] if nudged else [])
    leaves = []  # (path, |g_card - g_cpu|, |g_cpu|, |g_nudged - g_cpu|)
    for (path, p), (_, pc), *pn in zip(*(named_flax_params(m) for m in models)):
        if (p.grad is None) != (pc.grad is None):
            fail(f"train {label}: {path} has a gradient on one device only")
        if p.grad is None:
            continue
        ref = float(pc.grad.norm())
        if not ref > 0:
            fail(f"train {label}: the CPU gradient of {path} is zero")
        spread = float((pn[0][1].grad - pc.grad).norm()) if pn else 0.0
        leaves.append((path, float((p.grad.cpu() - pc.grad).norm()), ref, spread))
    floor = TRAIN_GRAD_ATOL_OF_MAX * max(ref for _, _, ref, _ in leaves)
    # each leaf's error as a share of its bound; a NaN takes the lead and fails below
    worst = ("", 0.0, 0.0)
    for path, err, ref, spread in leaves:
        share = err / (TRAIN_GRAD_REL_LIMIT * ref + floor + TRAIN_SPREAD_FACTOR * spread)
        if not share <= worst[1]:
            worst = (path, share, err / ref)
    compared, median_rel = len(leaves), float(np.median([e / r for _, e, r, _ in leaves]))
    median_spread = float(np.median([s_ / r for _, _, r, s_ in leaves]))
    record["parity_f32"] = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
                            "loss_rtol": TRAIN_LOSS_RTOL, "leaves_compared": compared,
                            "worst_leaf": worst[0], "worst_leaf_share_of_bound": worst[1],
                            "worst_leaf_rel_err": worst[2], "median_leaf_rel_err": median_rel,
                            "median_leaf_nudged_spread": median_spread if nudged else None,
                            "grad_rel_limit": TRAIN_GRAD_REL_LIMIT, "grad_floor": floor,
                            "cpu_seconds": cpu_seconds}
    log(f"train {label} f32, card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f} (rel "
        f"{loss_rel:.3g}, limit {TRAIN_LOSS_RTOL}); {compared} leaves' gradients, worst "
        f"{worst[0]} at {worst[1]:.3g} of its bound ({worst[2]:.3g} of its norm; bound "
        f"{TRAIN_GRAD_REL_LIMIT} of the norm + {floor:.3g}"
        + (f" + {TRAIN_SPREAD_FACTOR} x the CPU's own spread" if nudged else "")
        + f"), median {median_rel:.3g} of the norm"
        + (f"; the CPU's spread under one rounding of the image, median {median_spread:.3g} "
           "of the norm" if nudged else ""))
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst[1] <= 1.0 and compared > 0):
        fail(f"train {label}: the card's f32 loss or gradients left the CPU's")
    stats = [(f"{name}.{stat}", *(getattr(m, stat) for _, m in entries))
             for entries in zip(*(m.named_modules() for m in models))
             for name, mod in entries[:1]
             if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)
             for stat in ("running_mean", "running_var")]
    if stats:
        shares = []  # (path, share of the bound, relative error)
        for path, st, sc, *sn in stats:
            err, ref = float((st.cpu() - sc).norm()), float(sc.norm())
            spread = float((sn[0] - sc).norm()) if sn else 0.0
            shares.append((path, err / (TRAIN_STATS_REL_LIMIT * ref + TRAIN_SPREAD_FACTOR * spread),
                           err / ref))
        # a NaN takes the lead and fails below
        worst_s = max(shares, key=lambda r: r[1] if r[1] == r[1] else float("inf"))
        record["parity_f32"].update({"stat_leaves": len(shares), "worst_stat": worst_s[0],
                                     "worst_stat_share_of_bound": worst_s[1],
                                     "worst_stat_rel_err": worst_s[2],
                                     "stat_rel_limit": TRAIN_STATS_REL_LIMIT})
        log(f"train {label} f32, BatchNorm statistics after the forward, card vs CPU: "
            f"{len(shares)} leaves, worst {worst_s[0]} at {worst_s[1]:.3g} of its bound "
            f"({worst_s[2]:.3g} of its norm; limit {TRAIN_STATS_REL_LIMIT}"
            + (f" + {TRAIN_SPREAD_FACTOR} x the CPU's spread" if nudged else "") + ")")
        if not worst_s[1] <= 1.0:
            fail(f"train {label}: the card's BatchNorm statistics left the CPU's")
    del trainer, cpu, nudged, models
    torch.cuda.empty_cache()
    set_tf32(torch, True)


def phase_training(torch, card, label):
    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.data.synthetic import make_batch
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.train.trainer import Trainer

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
    f32_parity(torch, label, mcfg, base, batch, record, spec.get("nudged_spread", False))

    # --- (b) the main path: five bf16 steps on that batch, counts from 0 ------
    torch.cuda.synchronize()
    before_trainer = torch.cuda.memory_allocated()
    trainer = Trainer(mcfg, TrainConfig(amp=True, **base))
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # what is allocated when the peak is reset (the model and its optimizer
    # state, and whatever earlier phases still hold): the steps' own peak is
    # the part above it
    torch.cuda.synchronize()
    at_reset = torch.cuda.memory_allocated()
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
                            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "allocated_before_the_trainer_gb": before_trainer / 1e9,
                            "allocated_at_reset_gb": at_reset / 1e9,
                            "peak_above_reset_gb":
                                (torch.cuda.max_memory_allocated() - at_reset) / 1e9}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, device_batch, gen)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.device_time_total, ev.count) for ev in device_events(prof)]
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
        f"{record['steps_bf16']['peak_memory_gb']:.2f} GB, of which "
        f"{record['steps_bf16']['allocated_at_reset_gb']:.2f} GB were allocated when it was reset "
        f"({record['steps_bf16']['allocated_before_the_trainer_gb']:.2f} GB before the trainer "
        f"was built) and {record['steps_bf16']['peak_above_reset_gb']:.2f} GB are the steps' own "
        f"({card}); "
        f"one profiled step: "
        f"{device_ms:.3f} ms of device time in {record['launches_per_step']} launches, busy "
        f"share {device_ms / resident:.3f} of the step with the batch on the card; by kernel "
        + ", ".join(f"{n} {ms:.3f} ms ({ms / device_ms:.1%})" for n, ms in by_kernel.items())
        + "; top device time:")
    for k, us, c in rows[:12]:
        log(f"  {us:9.1f} us  x{c:5d}  {k[:90]}")
    return launches


# ---------------------------------------------------------------------------
# Occupancy training: the data layer and soccdpt_torch.cli.train_occupancy
# ---------------------------------------------------------------------------

OCC_FIXTURE = dict(frames_per_seq=4, width=1920, height=1080, seed=0)
OCC_ARGS = ["-t", "dpt_swin2_tiny_256", "-v", "3", "--max_steps", "6", "--epochs", "1",
            "--val_percent", "0.25", "--pos_weight", "auto"]
OCC_STEPS = 6
# the table's kernels in one step: the trunk's 12 window attentions and the
# model's voxelizer, forward only (only the 3-D head trains), nothing else
OCC_PER_STEP = {"window_attention": 12, "segment_sum": 1, "segment_sum_backward": 0,
                "global_attention": 0, "global_attention_backward": 0,
                "fused_rcu": 0, "fused_rcu_tail": 0, "fused_head_tail": 0}
OCC_PROFILED_STEP = 3  # the step of the run (0-based) whose device time is profiled
OCC_HOST_SAMPLES = 4  # samples timed part by part on the host
OCC_COPY_BATCHES = 3  # batches the copy and the pool comparison cycle through
OCC_POOL_ROUNDS = 4  # alternating rounds of the pool comparison


def occ_counters():
    from soccdpt_torch.kernels import fused_fusion, fused_head, fused_rcu
    from soccdpt_torch.kernels import global_attention as ga
    from soccdpt_torch.kernels import segment_sum as ss
    from soccdpt_torch.kernels import window_attention as wa

    return {"window_attention": wa.window_attention, "segment_sum": ss.segment_sum,
            "segment_sum_backward": ss.segment_sum_backward,
            "global_attention": ga.global_attention,
            "global_attention_backward": ga.global_attention_backward,
            "fused_rcu": fused_rcu.fused_rcu, "fused_rcu_tail": fused_fusion.fused_rcu_tail,
            "fused_head_tail": fused_head.fused_head_tail}


def occ_base_checkpoint(torch, camera, path):
    """The base model the run loads (``-l``): the flagship's weights from
    numpy seed 0 with the depth head's last conv scaled, as the served
    phases scale it, so that inverse depth sits in a band where depth =
    1/inv is well conditioned. From the seed alone the random head's
    inverse depth lies near zero: depths of 1e7 m, points the card and the
    CPU place apart by 1e6 m, a grid of 61 cells of which a fifth of the
    mass differs between them (PERF.md, the occupancy phase)."""
    from soccdpt_torch.core.checkpoint import save_checkpoint
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model

    base = build_model(ModelConfig(model_type="dpt_swin2_tiny_256", version=3, compute_occ=True,
                                   occupancy_head=True, camera=camera), device="cuda", seed=0)
    with torch.no_grad():
        base.depth_net.head.conv3.weight.mul_(0.01)
        base.depth_net.head.conv3.bias.fill_(0.3)
    save_checkpoint(path, {"params": base.state_dict()})
    return base.state_dict()


def occ_model(torch, tocc, camera, weights, image, dtype):
    """The run's model outside the CLI: the base weights, the grid
    calibrated on ``image`` as ``--calibrate_grid auto`` does it, only
    ``occupancy_conv`` trainable."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.train.patchwise import select_trainable

    mcfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3, compute_occ=True,
                       occupancy_head=True, compute_dtype=dtype, camera=camera)
    model = build_model(mcfg, device="cuda", seed=0)
    model.load_state_dict(weights)
    occ, info = tocc.calibrate_grid(tocc.probe_cloud(model, [image]), mcfg.occupancy)
    model.cfg = dataclasses.replace(mcfg, occupancy=occ)
    select_trainable(model, tocc.occupancy_mask(model))
    return model, info


def occ_host_checks(native, bdd, io, dataset, record):
    """The host library against its plain versions on one 1080p frame, and
    one sample's GT."""
    if not native.AVAILABLE:
        fail(f"the host library did not build: {native.build_error()}")
    seq, proc = dataset.datasets[0].seq, dataset.datasets[0].proc
    frame = seq[0]
    sem = bdd.rgb_seg_to_class(np.ascontiguousarray(frame["seg_frame"][..., ::-1])).reshape(-1)
    points = proc.process_frame(frame)["points"].astype(np.float32)
    args = (points, sem, tuple(proc.occ.occupancy_shape), tuple(proc.occ.grid_size),
            bdd.NUM_CLASSES)
    t0 = time.perf_counter()
    grid_lib = native.voxelize_points(*args)
    t1 = time.perf_counter()
    grid_plain = native.voxelize_points_plain(*args)
    t2 = time.perf_counter()
    if not np.array_equal(grid_lib, grid_plain):
        fail(f"occ: the C++ voxelizer differs from its plain version in "
             f"{int((grid_lib != grid_plain).sum())} cells")
    h, w = frame["rgb_frame"].shape[:2]
    png = io.encode_png(frame["rgb_frame"][..., ::-1], filter_type=[r % 5 for r in range(h)])
    (_, _, _, ch), raw = io.inflate_png(png)
    t3 = time.perf_counter()
    rows_lib = native.png_unfilter(raw, h, w * ch, ch)
    t4 = time.perf_counter()
    rows_plain = native.png_unfilter_plain(raw, h, w * ch, ch)
    t5 = time.perf_counter()
    if not np.array_equal(rows_lib, rows_plain):
        fail("occ: the C++ PNG unfilter differs from its plain version")
    sample = dataset[0]
    occupied = int((sample["occupancy_grid"] > 0.5).sum())
    record["host_library"] = {
        "path": native.load()._name, "points": len(points),
        "voxelize_ms": (t1 - t0) * 1e3, "voxelize_plain_ms": (t2 - t1) * 1e3,
        "unfilter_ms": (t4 - t3) * 1e3, "unfilter_plain_ms": (t5 - t4) * 1e3,
        "gt_occupied_cells_sample0": occupied}
    log(f"occ: host library {native.load()._name}; on frame 0 the C++ voxelizer equals its "
        f"plain version ({len(points)} points, {(t1 - t0) * 1e3:.1f} ms against "
        f"{(t2 - t1) * 1e3:.1f}), the C++ PNG unfilter equals its plain version on the frame "
        f"re-encoded with all five filters ({(t4 - t3) * 1e3:.1f} ms against "
        f"{(t5 - t4) * 1e3:.0f}); sample 0's GT grid holds {occupied} occupied cells of "
        f"{sample['occupancy_grid'].size}")
    if occupied == 0:
        fail("occ: the GT grid of sample 0 is empty")


def occ_host_times(io, dataset, transform, record):
    """Host milliseconds per sample: the three PNG decodes of a frame, the GT
    (unprojection and voxelization), the transform to the net input."""
    seq, proc = dataset.datasets[0].seq, dataset.datasets[0].proc
    size = dataset.datasets[0].target_size
    parts = {"png_decode_ms": [], "gt_voxelization_ms": [], "transform_ms": []}
    for i in range(OCC_HOST_SAMPLES):
        t0 = time.perf_counter()
        frame = seq[i]
        t1 = time.perf_counter()
        out = proc.process_frame(frame)
        t2 = time.perf_counter()
        rgb = io.resize(out["rgb_frame"], size)
        transform({"image": rgb.astype(np.float32)})
        t3 = time.perf_counter()
        for key, ms in zip(parts, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3)):
            parts[key].append(ms)
    t0 = time.perf_counter()
    for i in range(OCC_HOST_SAMPLES):
        dataset[i]
    whole = (time.perf_counter() - t0) * 1e3 / OCC_HOST_SAMPLES
    record["host_ms_per_sample"] = {k: float(np.median(v)) for k, v in parts.items()}
    record["host_ms_per_sample"]["whole_sample_ms"] = whole
    record["host_ms_per_sample_all"] = parts
    log("occ: host time per 1080p sample (median of "
        f"{OCC_HOST_SAMPLES}): " + ", ".join(f"{k[:-3]} {v:.1f} ms"
                                             for k, v in record["host_ms_per_sample"].items()))


def occ_step_parity(torch, tocc, loader, train_set, camera, weights, record):
    """One f32 step on one batch, card against CPU, TF32, dropout and
    stochastic depth off: the loss and every occupancy_conv gradient."""
    from soccdpt_torch.weights import named_flax_params

    set_tf32(torch, False)
    batch = loader.collate([train_set[0]])
    pos_weight, _ = tocc.auto_pos_weight(batch["occupancy_grid"][0])
    model, calib = occ_model(torch, tocc, camera, weights, batch["image"][0], "float32")
    for mod in model.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
        if hasattr(mod, "drop_path_rates"):
            mod.drop_path_rates = [0.0] * len(mod.drop_path_rates)
    cpu_model = copy.deepcopy(model).cpu()
    losses = {}
    for label, dev, m in (("card", "cuda", model), ("cpu", "cpu", cpu_model)):
        opt = torch.optim.Adam(m.occupancy_conv.parameters(), lr=1e-4)
        t = {k: torch.from_numpy(batch[k]).to(dev) for k in ("image", "occupancy_grid", "mask_occ")}
        t0 = time.perf_counter()
        losses[label] = float(tocc.occupancy_step(m, opt, t["image"], t["occupancy_grid"],
                                                  t["mask_occ"], pos_weight))
        losses[label + "_seconds"] = time.perf_counter() - t0
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    leaves = []
    for (path, p), (_, pc) in zip(named_flax_params(model), named_flax_params(cpu_model)):
        if (p.grad is None) != (pc.grad is None):
            fail(f"occ: {path} has a gradient on one device only")
        if p.grad is not None:
            ref = float(pc.grad.norm())
            leaves.append((path, float((p.grad.cpu() - pc.grad).norm()) / ref, ref))
    worst = max(leaves, key=lambda x: (not x[1] <= TRAIN_GRAD_REL_LIMIT, x[1]))
    record["parity_f32"] = {"loss_card": losses["card"], "loss_cpu": losses["cpu"],
                            "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
                            "leaves": {p: e for p, e, _ in leaves}, "worst_leaf": worst[0],
                            "worst_leaf_rel_err": worst[1], "grad_rel_limit": TRAIN_GRAD_REL_LIMIT,
                            "pos_weight": pos_weight, "cpu_seconds": losses["cpu_seconds"],
                            "calibration": calib}
    log(f"occ f32 step, card vs CPU: loss {losses['card']:.6f} vs {losses['cpu']:.6f} (rel "
        f"{loss_rel:.3g}, limit {TRAIN_LOSS_RTOL}); {len(leaves)} occupancy_conv gradients, worst "
        f"{worst[0]} at {worst[1]:.3g} of its norm (limit {TRAIN_GRAD_REL_LIMIT}); CPU step "
        f"{losses['cpu_seconds']:.1f} s; the grid calibrated to {calib.get('in_bounds_after', 0):.3f}"
        " of the probe's points in bounds")
    if not (len(leaves) == 8 and all(ref > 0 for _, _, ref in leaves)):
        fail(f"occ: expected 8 nonzero occupancy_conv gradients, got {leaves}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst[1] <= TRAIN_GRAD_REL_LIMIT):
        fail("occ: the card's f32 step left the CPU's")
    set_tf32(torch, True)


def occ_copy_and_pool_times(torch, tocc, loader, train_set, camera, weights, record):
    """A batch's copy to the card by the CLI's plain ``.to()``; then the
    bf16 step on batches already on the card with the 3-D head's pools as
    pairwise maxima (the JAX package's tie split) and as ``max_pool3d``:
    equal forward values, the step's wall time in alternating rounds, and
    one profiled step of each (device time, CUDA launches)."""
    from torch.profiler import ProfilerActivity, profile

    from soccdpt_torch.models import heads

    keys = ("image", "occupancy_grid", "mask_occ")
    batches = [loader.collate([train_set[i]]) for i in range(OCC_COPY_BATCHES)]
    nbytes = sum(batches[0][k].nbytes for k in keys)
    copy_ms = []
    for b in batches * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = {k: torch.from_numpy(b[k]).to("cuda") for k in keys}
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    record["copy"] = {"batch_bytes": nbytes, "to_ms": copy_ms,
                      "median_to_ms": float(np.median(copy_ms))}
    log(f"occ: copy of a {nbytes / 1e6:.1f} MB batch (image, grid, mask) by .to(): "
        f"{np.median(copy_ms):.2f} ms median, blocking ({[round(x, 2) for x in copy_ms]})")
    del on_card

    orig_pool = heads._max_pool_222  # both pools forced, whatever the head would pick
    pools = {"pairwise": lambda x, split_ties: orig_pool(x, True),
             "max_pool3d": lambda x, split_ties: orig_pool(x, False)}
    g = torch.rand((1, 256, 256, 32, 3), device="cuda") * (torch.rand((1, 256, 256, 32, 1),
                                                                      device="cuda") < 0.01)
    model, _ = occ_model(torch, tocc, camera, weights, batches[0]["image"][0], "bfloat16")
    out = {}
    for name, forced in pools.items():
        heads._max_pool_222 = forced
        with torch.no_grad():
            out[name] = model.occupancy_conv(g, torch.bfloat16)
    heads._max_pool_222 = orig_pool
    if not torch.equal(out["pairwise"], out["max_pool3d"]):
        fail("occ: the pairwise pools' forward differs from max_pool3d's")
    del out, g
    opt = torch.optim.Adam(model.occupancy_conv.parameters(), lr=1e-4)
    pos_weight, _ = tocc.auto_pos_weight(batches[0]["occupancy_grid"][0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    on_card = [{k: torch.from_numpy(b[k]).to("cuda") for k in keys} for b in batches]

    def step(b):
        return tocc.occupancy_step(model, opt, b["image"], b["occupancy_grid"], b["mask_occ"],
                                   pos_weight, gen)

    wall = {name: [] for name in pools}
    prof_rows = {}
    try:
        for name, forced in pools.items():  # warm-up and one profiled step each
            heads._max_pool_222 = forced
            float(step(on_card[0]))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                float(step(on_card[1]))
                torch.cuda.synchronize()
            prof_rows[name] = [(ev.key, ev.device_time_total, ev.count)
                               for ev in device_events(prof)]
        for r in range(OCC_POOL_ROUNDS):
            for name in (list(pools) if r % 2 == 0 else list(pools)[::-1]):
                heads._max_pool_222 = pools[name]
                for b in on_card:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    float(step(b))
                    torch.cuda.synchronize()
                    wall[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        heads._max_pool_222 = orig_pool
    summary = {}
    for name in pools:
        rows = prof_rows[name]
        summary[name] = {"median_step_ms": float(np.median(wall[name])), "step_ms": wall[name],
                         "device_ms": sum(us for _, us, _ in rows) / 1e3,
                         "cuda_launches": sum(c for _, _, c in rows),
                         "pool_rows": [(k[:100], us, c) for k, us, c in rows
                                       if "maximum" in k.lower() or "pool" in k.lower()]}
    record["pool_ab"] = summary
    log("occ bf16 step, batch on the card, the head's pools A/B ("
        f"{OCC_POOL_ROUNDS} alternating rounds of {len(on_card)} steps): " + "; ".join(
            f"{n}: median {v['median_step_ms']:.2f} ms, device {v['device_ms']:.3f} ms in "
            f"{v['cuda_launches']} launches" for n, v in summary.items()))
    for name, v in summary.items():
        for k, us, c in v["pool_rows"][:8]:
            log(f"  {name}: {us:9.1f} us  x{c:4d}  {k[:80]}")
    del model, opt, on_card
    torch.cuda.empty_cache()


def phase_occupancy(torch, card):
    """The data layer and ``soccdpt_torch.cli.train_occupancy`` on the
    flagship at full width: the fixture tree at 1920x1080, the host
    library, GT and copy times, the f32 step against the CPU's, then the
    CLI's main path (six bf16 steps, the checkpoint and the val IoU) with
    the launch counts set to 0 just before it and read just after."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from soccdpt_torch import native
    from soccdpt_torch.cli import train_occupancy as tocc
    from soccdpt_torch.data import bdd, loader, synthetic
    from soccdpt_torch.data import image_io as io
    from soccdpt_torch.data.transforms import load_transforms

    record = RECORD.setdefault("train_occ_swin", {"model_type": "dpt_swin2_tiny_256",
                                                  "version": 3, "batch": 1,
                                                  "grid": [256, 256, 32, 3],
                                                  "frames": [1080, 1920], "args": OCC_ARGS})
    counters = occ_counters()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="occ_") as tmp:
        tree = os.path.join(tmp, "bdd")
        t0 = time.perf_counter()
        synthetic.make_bdd_fixture(tree, **OCC_FIXTURE)
        record["fixture_seconds"] = time.perf_counter() - t0
        log(f"occ: fixture tree, 2 sequences x {OCC_FIXTURE['frames_per_seq']} frames at "
            f"1920x1080, written in {record['fixture_seconds']:.1f} s")
        transform, _, _ = load_transforms("dpt_swin2_tiny_256")
        dataset = bdd.get_bdd_dataset(bdd.BDDOccupancy, transform, tree)
        camera = dataset.datasets[0].seq.camera
        for d in dataset.datasets:
            d.target_size = (camera.width, camera.height)
        occ_host_checks(native, bdd, io, dataset, record)
        occ_host_times(io, dataset, transform, record)
        base = os.path.join(tmp, "base.pt")
        weights = occ_base_checkpoint(torch, camera, base)
        train_set, val_set = loader.split_train_val(dataset, 0.25, seed=0)
        occ_step_parity(torch, tocc, loader, train_set, camera, weights, record)
        torch.cuda.empty_cache()
        occ_copy_and_pool_times(torch, tocc, loader, train_set, camera, weights, record)
        del weights

        # --- the main path: the CLI, counts from 0 -------------------------------
        steps = []
        orig = tocc.occupancy_step

        def counted(*args, **kwargs):
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            profiled = len(steps) == OCC_PROFILED_STEP
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    loss = orig(*args, **kwargs)
                    torch.cuda.synchronize()
                record["profile_rows"] = [
                    (ev.key, ev.device_time_total, ev.count) for ev in device_events(prof)]
            else:
                loss = orig(*args, **kwargs)
                torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "profiled": profiled,
                          "launches": {n: fn.launches - before[n] for n, fn in counters.items()}})
            return loss

        ckpts = os.path.join(tmp, "checkpoints")
        for fn in counters.values():
            fn.launches = 0
        tocc.occupancy_step = counted
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            iou = tocc.main(OCC_ARGS + ["-b", tree, "-c", ckpts, "-l", base])
            run_seconds = time.perf_counter() - t0
        finally:
            tocc.occupancy_step = orig
            os.chdir(cwd)
        launches = {name: fn.launches for name, fn in counters.items()}
        with open(os.path.join(tmp, "logs", "metrics_occupancy.jsonl")) as fh:
            logged = [json.loads(line) for line in fh]
        ckpt = os.path.join(ckpts, "SOccDPT_Occupancy", "run", "checkpoint_epoch_1.pt")
        ckpt_ok = os.path.isfile(ckpt) and os.path.getsize(ckpt) > 0
        baseline = float(np.mean([(val_set[i]["occupancy_grid"] > 0.5).mean()
                                  for i in range(len(val_set))]))

    losses = [r["loss"] for r in logged]
    for i, s in enumerate(steps):
        if s["launches"] != OCC_PER_STEP:
            fail(f"occ: step {i} launched {s['launches']}, expected {OCC_PER_STEP}")
    if len(steps) != OCC_STEPS or len(losses) != OCC_STEPS:
        fail(f"occ: the run took {len(steps)} steps and logged {len(losses)} losses, "
             f"expected {OCC_STEPS}")
    if not all(np.isfinite(losses)):
        fail(f"occ: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"occ: the sixth loss is not below the first: {losses}")
    if not ckpt_ok:
        fail("occ: the run wrote no checkpoint")
    if not np.isfinite(iou):
        fail(f"occ: the val IoU is not finite: {iou}")
    for name in OCC_PER_STEP:
        if OCC_PER_STEP[name] == 0 and launches[name]:
            fail(f"occ: {name} ran {launches[name]} times on the occupancy path")

    rows = sorted(record.pop("profile_rows"), key=lambda r: -r[1])
    device_ms = sum(us for _, us, _ in rows) / 1e3
    step_ms = [s["ms"] for s in steps]
    plain = [s["ms"] for s in steps[1:] if not s["profiled"]]
    median = float(np.median(plain))
    periods = [(b["time"] - a["time"]) * 1e3 for a, b in zip(logged, logged[1:])]
    in_profile = {name: sum(c for k, _, c in rows if f"{name}_kernel" in k)
                  for name in ("window_attention", "segment_sum")}
    record.update({
        "losses": losses, "step_ms": step_ms, "median_step_ms_from_step_2": median,
        "loop_period_ms": periods, "median_loop_period_ms": float(np.median(periods[1:])),
        "device_ms_per_step": device_ms, "cuda_launches_per_step": sum(c for _, _, c in rows),
        "busy_share_of_step": device_ms / median,
        "busy_share_of_loop_period": device_ms / float(np.median(periods[1:])),
        "kernel_launches_in_profile": in_profile,
        "launches_per_step": steps[0]["launches"], "launches_run": launches,
        "val_iou": iou, "predict_all_iou": baseline, "run_seconds": run_seconds,
        "profile_us_per_step": [{"name": k[:120], "device_us": us, "calls": c}
                                for k, us, c in rows[:40]]})
    log(f"occ run (python -m soccdpt_torch.cli.train_occupancy {' '.join(OCC_ARGS)} -l "
        f"<base>), "
        f"{run_seconds:.1f} s: losses {[round(x, 4) for x in losses]}; val IoU {iou:.6f} "
        f"against {baseline:.6f} for predicting every cell occupied; checkpoint {ckpt_ok}; "
        f"launches in the run {launches}")
    log(f"occ bf16 step, batch 1, 1080p, 256x256x32x3 grid ({card}): median "
        f"{median:.2f} ms from step 2 on (steps {[round(t, 1) for t in step_ms]}, step "
        f"{OCC_PROFILED_STEP + 1} profiled), the loop's period median "
        f"{record['median_loop_period_ms']:.1f} ms ({[round(t, 1) for t in periods]}); one "
        f"profiled step: {device_ms:.3f} ms of device time in "
        f"{record['cuda_launches_per_step']} launches, busy share {device_ms / median:.3f} of "
        f"the step and {record['busy_share_of_loop_period']:.3f} of the loop's period; "
        f"K1 {in_profile['window_attention']} and K2 {in_profile['segment_sum']} kernels in "
        f"the profile; top device time:")
    for k, us, c in rows[:12]:
        log(f"  {us:9.1f} us  x{c:5d}  {k[:90]}")
    return launches


# ---------------------------------------------------------------------------
# The training and eval CLIs: soccdpt_torch.cli.train and soccdpt_torch.cli.eval
# ---------------------------------------------------------------------------

CLI_FIXTURE = dict(frames_per_seq=10, width=1920, height=1080, seed=0)
CLI_SWIN_SWEEP = "config/SOccDPT_V3_dpt_swin2_tiny_256.json"
CLI_HYBRID_SWEEP = "config/SOccDPT_V3_dpt_hybrid_384.json"
CLI_SWIN_STEPS, CLI_HYBRID_STEPS = 6, 4
# the step of a run (0-based) whose device time is profiled; an eval round
# follows it, so it lies in no interval the loop's period is read from
CLI_PROFILED_STEP = 2
CLI_EVAL_SAMPLES = 4


def cli_args(tree, sweep, model_type, steps, run_dir, *extra):
    return ["-v", "3", "-dt", "bdd", "-t", model_type, "-b", tree, "--sweep_json", sweep,
            "--count", "1", "--max_steps", str(steps), "-c", str(run_dir / "checkpoints"),
            "--log_dir", str(run_dir / "logs"), *extra]


def run_train_cli(torch, tcli, args, counters):
    """``tcli.main(args)`` with every ``Trainer.train_step`` of the run timed
    (ending in a synchronize) and its launch counts read around it, one step
    profiled; returns (results, steps, profile rows, seconds, the trainer's
    patch masks)."""
    from torch.profiler import ProfilerActivity, profile

    from soccdpt_torch.train.trainer import Trainer

    steps, rows, masks = [], [], []
    orig = Trainer.train_step

    def counted(self, *a, **kw):
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        profiled = len(steps) == CLI_PROFILED_STEP
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = orig(self, *a, **kw)
                torch.cuda.synchronize()
            rows.extend((ev.key, ev.device_time_total, ev.count) for ev in device_events(prof))
        else:
            out = orig(self, *a, **kw)
            torch.cuda.synchronize()
        masks[:] = self.masks
        steps.append({"start": t0, "ms": (time.perf_counter() - t0) * 1e3, "profiled": profiled,
                      "patch_steps": len(self.masks),
                      "launches": {n: fn.launches - before[n] for n, fn in counters.items()}})
        return out

    Trainer.train_step = counted
    try:
        t0 = time.perf_counter()
        results = tcli.main(args)
        seconds = time.perf_counter() - t0
    finally:
        Trainer.train_step = orig
    return results, steps, sorted(rows, key=lambda r: -r[1]), seconds, masks


def loop_periods(steps, division_step):
    """ms between the starts of consecutive steps, all of them and those
    with no eval round between them (one follows every ``division_step``-th
    step, from step 0)."""
    starts = [s["start"] for s in steps]
    gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    return gaps, [g for i, g in enumerate(gaps) if i % division_step]


def jsonl_log(run_dir):
    (path,) = (run_dir / "logs").glob("metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def check_cli_run(label, steps, logged, want_steps, per_step):
    """Every step launched each kernel ``per_step[name]`` times, the losses
    are finite, one logged a step."""
    losses = [r["loss"] for r in logged if "loss" in r]
    if len(steps) != want_steps or len(losses) != want_steps:
        fail(f"{label}: {len(steps)} steps and {len(losses)} logged losses, expected {want_steps}")
    if not all(np.isfinite(losses)):
        fail(f"{label}: a loss is not finite: {losses}")
    for i, s in enumerate(steps):
        if any(s["launches"][name] != n for name, n in per_step.items()):
            fail(f"{label}: step {i} launched {s['launches']}, expected {per_step}")
    return losses


def hybrid_attention_backwards(mask, depth):
    """The ViT blocks whose attention a patch step's backward runs through
    (K7 once each): block i's, when a trainable leaf feeds its q, k and v:
    the ResNet, the patch embedding, the cls token, the position embedding,
    an earlier block, or its own ``norm1`` and ``qkv``."""
    trainable = [path.split(".")[2:4] for path, flag in mask.items()
                 if flag and path.startswith("depth_net.backbone.")]
    below = any(name.startswith(("stem_", "stage", "patch_embed_proj", "cls_token", "pos_embed"))
                for name, *_ in trainable)
    reached = 0
    for i in range(depth):
        block = [rest for name, *rest in trainable if name == f"block{i}"]
        reached += below or any(rest[:1] in (["norm1"], ["qkv"]) for rest in block)
        below = below or bool(block)
    return reached


def summarize_cli_run(label, record, steps, rows, seconds, card):
    median = float(np.median([s["ms"] for s in steps[1:] if not s["profiled"]]))
    device_ms = sum(us for _, us, _ in rows) / 1e3
    record.update({
        "run_seconds": seconds, "step_ms": [s["ms"] for s in steps],
        "median_step_ms_from_step_2": median, "launches_per_step": steps[0]["launches"],
        "patch_steps_per_step": steps[0]["patch_steps"], "device_ms_per_step": device_ms,
        "cuda_launches_per_step": sum(c for _, _, c in rows), "busy_share_of_step": device_ms / median,
        "profile_us_per_step": [{"name": k[:120], "device_us": us, "calls": c}
                                for k, us, c in rows[:40]]})
    log(f"{label} ({card}): {seconds:.1f} s; steps {[round(s['ms'], 1) for s in steps]} ms, "
        f"median {median:.2f} from step 2 on; one profiled step {device_ms:.3f} ms of device "
        f"time in {record['cuda_launches_per_step']} launches (busy {device_ms / median:.3f}); "
        f"launches a step {steps[0]['launches']}; top device time:")
    for k, us, c in rows[:10]:
        log(f"  {us:9.1f} us  x{c:5d}  {k[:90]}")


def cli_swin(torch, card, tcli, ti, tree, tmp, counters, record):
    """The flagship from a reference-layout ``.pth`` through the sweep's
    ``load``; the run with the host thread (the CLI's default) is the main
    path, then the same run with batches read on the loop's thread."""
    from soccdpt_torch.core.checkpoint import restore_checkpoint
    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.weights import to_jax_variables

    source = build_model(ModelConfig(model_type="dpt_swin2_tiny_256", version=3),
                         device="cuda", seed=7)
    variables = to_jax_variables(source)
    del source
    sd = reference_state_dict(variables, 3, "swin")
    pth = tmp / "reference.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "optimizer": {"state": {}, "param_groups": []}}, pth)
    with open(HERE / CLI_SWIN_SWEEP) as fh:
        sweep = json.load(fh)
    sweep["parameters"]["load"] = {"values": [str(pth)]}
    sweep["parameters"]["epochs"] = {"values": [1]}
    sweep_path = tmp / "sweep_swin.json"
    sweep_path.write_text(json.dumps(sweep))

    loads = []
    orig_load = ti.load_imported

    def spy(model, params, stats, verbose=True):
        reports = orig_load(model, params, stats, verbose)
        got = {coll: ti.flat_paths(tree) for coll, tree in to_jax_variables(model).items()}
        diff = [f"{coll}:{'/'.join(path)}" for coll in ("params", "batch_stats")
                for path, w in ti.flat_paths(variables[coll]).items()
                if not np.array_equal(got[coll][path], w)]
        loads.append({coll: {"loaded": r["loaded"], "total": r["total"],
                             "unused": len(r["unused"]), "mismatched": len(r["mismatched"])}
                      for coll, r in reports.items()} | {"leaves_unequal": diff})
        return reports

    runs = {}
    ti.load_imported = spy
    try:
        for name, extra in (("host_thread", []), ("serial", ["--host_prefetch", "0"])):
            run_dir = tmp / f"swin_{name}"
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            runs[name] = run_train_cli(torch, tcli, cli_args(
                str(tree), str(sweep_path), "dpt_swin2_tiny_256", CLI_SWIN_STEPS, run_dir, *extra),
                counters)[:4]
            runs[name] += ({n: fn.launches for n, fn in counters.items()}, jsonl_log(run_dir))
    finally:
        ti.load_imported = orig_load
    (results, steps, rows, seconds, launches, logged) = runs["host_thread"]
    if len(loads) != 2 or any(
            r[c]["loaded"] != r[c]["total"] or r[c]["unused"] or r[c]["mismatched"]
            for r in loads for c in ("params", "batch_stats")) or any(r["leaves_unequal"] for r in loads):
        fail(f"train_cli_swin: the .pth did not land every leaf: {loads}")
    losses = check_cli_run("train_cli_swin", steps, logged, CLI_SWIN_STEPS,
                           {"window_attention": 12 * steps[0]["patch_steps"],
                            "global_attention": 0, "global_attention_backward": 0,
                            "segment_sum": 0})
    evals = [r for r in logged if any(k.startswith("val/") for k in r)]
    if not evals or not all(np.isfinite(v) for v in results[0].values()):
        fail(f"train_cli_swin: the eval rounds gave {results}")
    ckpt_path = (tmp / "swin_host_thread" / "checkpoints" / "SOccDPT_V3_dpt_swin2_tiny_256_bdd"
                 / "trial000" / "checkpoint_epoch_1")
    ckpt = restore_checkpoint(str(ckpt_path))
    if ckpt["step"] != CLI_SWIN_STEPS or set(ckpt) != {"params", "batch_stats", "opt_state", "step"}:
        fail(f"train_cli_swin: the checkpoint holds {sorted(ckpt)}, step {ckpt.get('step')}")
    # the CLI's eval rounds: every len(train) // (3 * batch) steps, from step 0
    n = 2 * CLI_FIXTURE["frames_per_seq"]
    batch = sweep["parameters"]["batch_size"]["values"][0]
    division = max((n - max(1, int(n * sweep["parameters"]["val_percent"]["values"][0])))
                   // (3 * batch), 1)
    periods = {}
    for name, (_, st, _, _, _, _) in runs.items():
        gaps, clean = loop_periods(st, division)
        # both runs hold the same eval rounds: the mean over the run compares them
        periods[name] = {"ms": gaps, "no_eval_round_ms": clean, "mean_ms": float(np.mean(gaps)),
                         "step_ms": [s["ms"] for s in st],
                         "median_step_ms_from_step_2": float(np.median(
                             [s["ms"] for s in st[1:] if not s["profiled"]]))}
    # what the loop's thread reads a step: one batch of 1080p samples
    dataset, _, _ = tcli.build_datasets(TrainConfig(dataset="bdd", base_path=str(tree)),
                                        "dpt_swin2_tiny_256")
    t0 = time.perf_counter()
    for i in range(batch):
        dataset[i]
    read_ms = (time.perf_counter() - t0) * 1e3
    record.update({"load": loads, "losses": losses, "eval_rounds": evals,
                   "last_eval": results[0], "loop_periods": periods,
                   "host_read_ms_a_batch": read_ms,
                   "launches_run": launches, "checkpoint": str(ckpt_path.name)})
    summarize_cli_run("train_cli_swin", record, steps, rows, seconds, card)
    log(f"train_cli_swin: .pth loads {loads}; losses {[round(x, 4) for x in losses]}; last eval "
        f"{results[0]}; the loop's period, host thread / serial: mean over the run "
        f"{periods['host_thread']['mean_ms']:.1f} / {periods['serial']['mean_ms']:.1f} ms, without "
        f"an eval round between two steps {periods['host_thread']['no_eval_round_ms']} / "
        f"{periods['serial']['no_eval_round_ms']} ms; the step alone (median) "
        f"{periods['host_thread']['median_step_ms_from_step_2']:.1f} / "
        f"{periods['serial']['median_step_ms_from_step_2']:.1f} ms; reading a batch of {batch} "
        f"on the host {read_ms:.1f} ms ({card})")
    return launches, ckpt_path


def cli_hybrid(torch, card, tcli, tree, tmp, counters, record):
    """``dpt_hybrid_384`` from its published sweep file: first one f32 loss
    and its gradients, card against CPU; then the CLI's steps."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.data.synthetic import make_batch

    with open(HERE / CLI_HYBRID_SWEEP) as fh:
        params = {k: v["values"][0] for k, v in json.load(fh)["parameters"].items()}
    base = dict(batch_size=params["batch_size"], encoder_percentage=params["encoder_percentage"],
                patchwise_percentage=params["patchwise_percentage"],
                learning_rate=params["learning_rate"])
    mcfg = ModelConfig(model_type="dpt_hybrid_384", version=3)
    # the CLI's input: a 1080p frame at 384 high, aspect kept, multiple of 32
    batch = make_batch(0, base["batch_size"], (1080, 1920), (384, 672), mcfg.num_classes)
    f32_parity(torch, "train_cli_hybrid", mcfg, base, batch, record)

    run_dir = tmp / "hybrid"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results, steps, rows, seconds, masks = run_train_cli(torch, tcli, cli_args(
        str(tree), str(HERE / CLI_HYBRID_SWEEP), "dpt_hybrid_384", CLI_HYBRID_STEPS, run_dir),
        counters)
    launches = {n: fn.launches for n, fn in counters.items()}
    logged = jsonl_log(run_dir)
    depth = 12
    per_step = {"window_attention": 0, "segment_sum": 0,
                "global_attention": depth * len(masks),
                "global_attention_backward": sum(hybrid_attention_backwards(m, depth)
                                                 for m in masks)}
    losses = check_cli_run("train_cli_hybrid", steps, logged, CLI_HYBRID_STEPS, per_step)
    if not all(np.isfinite(v) for v in results[0].values()):
        fail(f"train_cli_hybrid: the eval rounds gave {results}")
    record.update({"sweep": CLI_HYBRID_SWEEP, "trial": params, "losses": losses,
                   "per_step_expected": per_step,
                   "last_eval": results[0], "launches_run": launches,
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    summarize_cli_run("train_cli_hybrid", record, steps, rows, seconds, card)
    log(f"train_cli_hybrid: losses {[round(x, 4) for x in losses]}; last eval {results[0]}; "
        f"peak memory {record['peak_memory_gb']:.2f} GB")
    return launches


def cli_eval(torch, card, tree, tmp, ckpt, counters, record):
    """``soccdpt_torch.cli.eval`` on the flagship checkpoint the training
    CLI wrote."""
    import contextlib
    import io

    from soccdpt_torch.cli import eval as ecli

    media = tmp / "media"
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = ecli.main(["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_tiny_256", "-b", str(tree),
                             "-l", str(ckpt), "--num_samples", str(CLI_EVAL_SAMPLES),
                             "--media_dir", str(media)])
    seconds = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    out = buf.getvalue()
    panels = sorted((media / "dpt_swin2_tiny_256_bdd_v3").glob("sample_*.png"))
    fps = [line for line in out.splitlines() if line.startswith("FPS")]
    record.update({"metrics": metrics, "panels": len(panels), "fps_line": fps,
                   "seconds": seconds, "launches_run": launches})
    log(f"eval_cli_swin ({card}): {seconds:.1f} s; {len(panels)} panels; {fps}; {metrics}")
    if len(panels) != CLI_EVAL_SAMPLES or len(fps) != 1 or not all(
            np.isfinite(v) for v in metrics.values()):
        fail(f"eval_cli_swin: {len(panels)} panels, FPS line {fps}, metrics {metrics}")
    if launches["window_attention"] < 1:
        fail("eval_cli_swin: K1 was launched no time")
    return launches


def write_cli_tree(tmp):
    """The BDD fixture tree of 2 x 10 frames at 1920x1080 that phases 8 and
    9 read, under ``tmp``."""
    from soccdpt_torch.data import synthetic

    tree = tmp / "bdd"
    t0 = time.perf_counter()
    synthetic.make_bdd_fixture(str(tree), **CLI_FIXTURE)
    log(f"clis: fixture tree, 2 sequences x {CLI_FIXTURE['frames_per_seq']} frames at "
        f"1920x1080, written in {time.perf_counter() - t0:.1f} s")
    return tree


def phase_train_eval_clis(torch, card, tmp, tree):
    """``soccdpt_torch.cli.train`` and ``soccdpt_torch.cli.eval`` at full
    width on the BDD fixture tree ``tree`` (``write_cli_tree``), working in
    ``tmp``: the flagship from a reference-layout ``.pth``,
    ``dpt_hybrid_384`` from its published sweep file, the eval CLI on the
    flagship's checkpoint. Each run's launch counts are set to 0 just
    before it and read just after; returns them by path."""
    import os

    from soccdpt_torch.cli import train as tcli
    from soccdpt_torch.core import torch_import as ti

    counters = occ_counters()
    cwd = os.getcwd()
    launches = {}
    os.chdir(tmp)
    try:
        with phase("training CLI dpt_swin2_tiny_256"):
            record = RECORD.setdefault("train_cli_swin", {"sweep": CLI_SWIN_SWEEP})
            launches["train_cli_swin"], ckpt = cli_swin(
                torch, card, tcli, ti, tree, tmp, counters, record)
        torch.cuda.empty_cache()
        with phase("eval CLI dpt_swin2_tiny_256"):
            launches["eval_cli_swin"] = cli_eval(
                torch, card, tree, tmp, ckpt, counters, RECORD.setdefault("eval_cli_swin", {}))
        torch.cuda.empty_cache()
        with phase("training CLI dpt_hybrid_384"):
            launches["train_cli_hybrid"] = cli_hybrid(
                torch, card, tcli, tree, tmp, counters,
                RECORD.setdefault("train_cli_hybrid", {}))
    finally:
        os.chdir(cwd)
    return launches


# ---------------------------------------------------------------------------
# Phase 9: deployment (export, run_exported), eval_others, MiDaS v2.1,
# datasets_analysis, K2's determinism, the custom ops' dispatch
# ---------------------------------------------------------------------------

DEPLOY_FLAGSHIP, DEPLOY_HYBRID = "dpt_swin2_tiny_256", "dpt_hybrid_384"
# kernel launches of one forward of each exported program
DEPLOY_PER_FORWARD = {DEPLOY_FLAGSHIP: {"window_attention": 12, "global_attention": 0,
                                       "upsample2x": 6, "unproject_slots": 0},
                      DEPLOY_HYBRID: {"window_attention": 0, "global_attention": 12,
                                      "upsample2x": 6, "unproject_slots": 0}}
DEPLOY_RUN_ITERS = 50  # forwards behind run_exported's frames/s line
DEPLOY_REPS = 20  # forwards whose wall is timed, median
# the program against the eager model, should they not be equal bit for bit:
# the ladder of tests/test_composition_oracle.py (inv_depth, seg, points)
DEPLOY_LADDER = (1e-4, 1e-4, 5e-3)
EVAL_OTHERS_SAMPLES = 4
# the builtin adapter's metrics against the pt2 adapter's: one bf16 step
# (2^-8) of each metric. The program equals the eager model bit for bit, so
# the metrics are expected equal; the step covers a program whose ATen
# calls round otherwise
EVAL_OTHERS_RTOL = 2.0**-8
MIDAS_ATOL = 1e-4  # card f32 vs CPU, TF32 off: the ladder's inv_depth rung
MIDAS_NUDGE = 1e-7  # relative nudge of the image for the card's own f32 spread
MIDAS_REPS = 10
ANALYSIS_SAMPLES = 6
K2_REPEATS = 5  # identical grid requests whose grids are compared bit for bit


def deploy_counters():
    from soccdpt_torch.kernels import ops

    return ops.COUNTERS


def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def op_nodes(program):
    """The ``soccdpt::`` nodes of an exported program's graph, by op."""
    out = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("soccdpt."):
            out[target] = out.get(target, 0) + 1
    return out


def run_exported_process(path, batch, size):
    """``python -m soccdpt_torch.cli.run_exported`` on ``path`` in a fresh
    process: its seconds and its lines, parsed."""
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "soccdpt_torch.cli.run_exported", "-m", str(path),
         "--batch", str(batch), "--size", str(size), "--iters", str(DEPLOY_RUN_ITERS)],
        capture_output=True, text=True, cwd=HERE, timeout=600)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        fail(f"run_exported {path.name} batch {batch}: exit {done.returncode}: "
             f"{done.stderr[-3000:]}")
    lines = done.stdout.splitlines()
    shapes = next(line for line in lines if line.startswith("outputs:"))
    launched = next(line for line in lines if line.startswith("kernel launches in one forward:"))
    launched = {name: int(n) for name, n in (
        item.rsplit(" ", 1) for item in launched.split(": ", 1)[1].split(", "))}
    rate = lines[-1]
    return {"seconds": seconds, "outputs": shapes, "launches_per_forward": launched,
            "hz": float(rate.split(" Hz")[0]),
            "ms_per_forward": float(rate.split("(")[1].split(" ms")[0]), "line": rate}


def check_program(torch, card, key, path, model_type, eager, size, with_points, counters, record):
    """The exported program at ``path``, loaded in this process, against the
    eager model on seeded inputs at batch 1 and 2: its nodes, the kernels it
    launches a forward (counts set to 0 just before, read just after), its
    outputs; then its wall, as a CUDA graph and its device time at batch 1,
    beside the eager model's. Returns the launches of the checked forwards."""
    from soccdpt_torch.cli.run_exported import load_program

    program = torch.export.load(str(path))
    nodes = op_nodes(program)
    del program
    # a program with points runs the geometry tail: one kernel a forward
    want_per = dict(DEPLOY_PER_FORWARD[model_type], unproject_slots=int(with_points))
    want_nodes = {f"soccdpt.{name}.default": n for name, n in want_per.items() if n}
    t0 = time.perf_counter()
    module = load_program(str(path), torch.device("cuda"))
    load_s = time.perf_counter() - t0
    launched = {name: 0 for name in counters}
    checks = {}

    def eager_out(x):
        return eager(x, compute_occ=False)[:3] if with_points else eager(x, return_raw=True)

    for B in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(100 + B)
        x = torch.randn(B, 3, size, size, device="cuda", generator=g)
        reset_counts(counters)
        with torch.no_grad():
            got = module(x)
        torch.cuda.synchronize()
        per = {name: fn.launches for name, fn in counters.items()}
        for name in launched:
            launched[name] += per[name]
        with torch.no_grad():
            want = eager_out(x)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        checks[f"b{B}"] = {"launches_per_forward": per, "bit_for_bit": equal, "max_abs_gap": gaps,
                           "shapes": [list(o.shape) for o in got],
                           "finite": all(bool(torch.isfinite(o).all()) for o in got)}
        if [o.shape for o in got] != [o.shape for o in want] or not checks[f"b{B}"]["finite"]:
            fail(f"{key}: batch {B}: outputs {checks[f'b{B}']['shapes']} (finite "
                 f"{checks[f'b{B}']['finite']}) against eager {[list(o.shape) for o in want]}")
        if per != want_per:
            fail(f"{key}: batch {B}: a forward launched {per}, expected {want_per}")
        if not equal and any(gap > tol for gap, tol in zip(gaps, DEPLOY_LADDER)):
            fail(f"{key}: batch {B}: the program left the eager model by {gaps}")
    if nodes != want_nodes:
        fail(f"{key}: the program's soccdpt nodes are {nodes}, expected {want_nodes}")
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(1, 3, size, size, device="cuda", generator=g)
    with torch.no_grad():
        program_ms = time_requests(torch, module, [x1], DEPLOY_REPS)["median_ms"]
        eager_ms = time_requests(torch, eager_out, [x1], DEPLOY_REPS)["median_ms"]
        graph_ms = cuda_ms(torch, lambda: module(x1), iters=5)
        ops, device_us = cuda_launches(torch, lambda: module(x1))
    record[key] = {"model_type": model_type, "with_points": with_points, "nodes": nodes,
                   "load_seconds": load_s, "checks": checks, "program_ms_b1": program_ms,
                   "eager_ms_b1": eager_ms, "program_graph_ms_b1": graph_ms,
                   "program_device_ms_b1": sum(device_us.values()) / 1e3,
                   "program_device_ops_b1": ops}
    log(f"{key}: {nodes}; loaded in {load_s:.1f} s; batch 1 / 2 launches "
        f"{checks['b1']['launches_per_forward']} / {checks['b2']['launches_per_forward']}, "
        f"bit for bit {checks['b1']['bit_for_bit']} / {checks['b2']['bit_for_bit']} (max gaps "
        f"{checks['b1']['max_abs_gap']}); batch 1: program {program_ms:.3f} ms, eager "
        f"{eager_ms:.3f} ms, the program as a CUDA graph {graph_ms:.3f} ms, device "
        f"{record[key]['program_device_ms_b1']:.3f} ms in {ops} operations ({card})")
    del module
    return launched


def deploy_exports(torch, card, tmp, counters, record):
    """Export the flagship from a reference-layout ``.pth`` (raw, and with
    points at camera resolution) and the hybrid from its seed; run the raw
    flagship's program through ``run_exported`` in fresh processes and
    every program in this one. Returns (launches by path, the ``.pth``, the
    raw flagship's program)."""
    from soccdpt_torch.cli.export import export_model
    from soccdpt_torch.cli.train import load_weights
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.bias_cache import build_inference_cache
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.weights import to_jax_variables

    source = build_model(ModelConfig(model_type=DEPLOY_FLAGSHIP), device="cuda", seed=0)
    with torch.no_grad():  # inverse depth in a well-conditioned band, as phase 4
        source.depth_net.head.conv3.weight.mul_(0.01)
        source.depth_net.head.conv3.bias.fill_(0.3)
    pth = tmp / "flagship_reference.pth"
    sd = reference_state_dict(to_jax_variables(source), 3, "swin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    del source
    launches = {}
    for key, model_type, load, with_points in (
            ("deploy_flagship", DEPLOY_FLAGSHIP, pth, False),
            ("deploy_flagship_points", DEPLOY_FLAGSHIP, pth, True),
            ("deploy_hybrid", DEPLOY_HYBRID, None, False)):
        path = tmp / f"{key}.pt2"
        t0 = time.perf_counter()
        export_model(model_type, 3, str(path), load=None if load is None else str(load),
                     with_points=with_points)
        export_s = time.perf_counter() - t0
        size = ModelConfig(model_type=model_type).net_size[1]
        record.setdefault("exports", {})[key] = {"seconds": export_s,
                                                 "bytes": path.stat().st_size}
        log(f"{key}: exported in {export_s:.1f} s, {path.stat().st_size} bytes")
        if key == "deploy_flagship":
            runs = {f"b{B}": run_exported_process(path, B, size) for B in (1, 2)}
            record["run_exported"] = runs
            for B, run in runs.items():
                log(f"run_exported {B} (a fresh process, {run['seconds']:.1f} s): "
                    f"{run['outputs']}; launches a forward {run['launches_per_forward']}; "
                    f"{run['line']} ({card})")
                if run["launches_per_forward"] != DEPLOY_PER_FORWARD[model_type]:
                    fail(f"run_exported {B}: launches a forward {run['launches_per_forward']}")
            want = {"b1": "outputs: (1, 256, 256) (1, 3, 256, 256)",
                    "b2": "outputs: (2, 256, 256) (2, 3, 256, 256)"}
            if {B: run["outputs"] for B, run in runs.items()} != want:
                fail(f"run_exported: {[run['outputs'] for run in runs.values()]}")
        eager = build_model(ModelConfig(model_type=model_type, compute_dtype="bfloat16"),
                            device="cuda")
        if load is not None:
            load_weights(eager, str(load), 3)
        build_inference_cache(eager.eval())
        launches[key] = check_program(torch, card, key, path, model_type, eager, size,
                                      with_points, counters, record)
        del eager
        if key != "deploy_flagship":
            path.unlink()
        torch.cuda.empty_cache()
    return launches, pth, tmp / "deploy_flagship.pt2"


def deploy_eval_others(torch, card, tree, pth, program, counters, record):
    """``cli/eval_others.py`` on the fixture tree: the builtin adapter on the
    flagship (the ``.pth`` loaded) and the ``pt2:`` adapter on its exported
    program, ``--list``, and an external name's clean hub error. The hub is
    a stub that raises as an unreachable one does: no outside host is
    contacted. Returns the adapters' launches."""
    import contextlib
    import io

    from soccdpt_torch.cli import eval_others as eo
    from soccdpt_torch.cli.train import build_datasets
    from soccdpt_torch.core.config import TrainConfig

    dataset = build_datasets(TrainConfig(dataset="bdd", base_path=str(tree)), DEPLOY_FLAGSHIP)[0]
    launches, metrics, seconds = {}, {}, {}
    for key, make in (("eval_others_builtin",
                       lambda: eo.builtin_adapter(DEPLOY_FLAGSHIP, load=str(pth))),
                      ("eval_others_pt2", lambda: eo.load_adapter(f"pt2:{program}"))):
        adapter = make()
        reset_counts(counters)
        t0 = time.perf_counter()
        metrics[key] = eo.evaluate_adapter(adapter, dataset, EVAL_OTHERS_SAMPLES)
        seconds[key] = time.perf_counter() - t0
        launches[key] = {name: fn.launches for name, fn in counters.items()}
        del adapter
        if launches[key]["window_attention"] != 12 * EVAL_OTHERS_SAMPLES:
            fail(f"{key}: launches {launches[key]}, expected K1 12 times a sample")
    builtin, pt2 = metrics["eval_others_builtin"], metrics["eval_others_pt2"]
    gaps = {k: abs(builtin[k] - pt2[k]) / max(abs(builtin[k]), 1e-12) for k in builtin}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eo.main(["--list"])
    listed = json.loads(buf.getvalue())
    hub_error = None
    orig = torch.hub.load

    def unreachable(*args, **kwargs):
        raise OSError("the hub is unreachable: no network")

    torch.hub.load = unreachable
    try:
        eo.external_adapter("DPT_Hybrid")(np.asarray(dataset[0]["image_raw"]))
    except RuntimeError as e:
        hub_error = str(e)
    finally:
        torch.hub.load = orig
    record["eval_others"] = {"samples": EVAL_OTHERS_SAMPLES, "metrics": metrics,
                             "relative_gaps": gaps, "rtol": EVAL_OTHERS_RTOL,
                             "seconds": seconds, "launches": launches, "list": listed,
                             "hub_error": hub_error}
    log(f"eval_others over {EVAL_OTHERS_SAMPLES} fixture samples: builtin {builtin} in "
        f"{seconds['eval_others_builtin']:.1f} s; pt2 {pt2} in "
        f"{seconds['eval_others_pt2']:.1f} s; largest relative gap {max(gaps.values()):.3g}; "
        f"--list schemes {listed['file_schemes']}; hub error: {hub_error}")
    if not (np.isfinite(list(builtin.values())).all() and np.isfinite(list(pt2.values())).all()):
        fail(f"eval_others: metrics not finite: {builtin} {pt2}")
    if builtin.keys() != pt2.keys() or max(gaps.values()) > EVAL_OTHERS_RTOL:
        fail(f"eval_others: the pt2 adapter's metrics left the builtin's: {gaps}")
    if listed["file_schemes"] != ["pt2:<path>", "onnx:<path>"] or len(listed["external"]) != 7:
        fail(f"eval_others --list: {listed}")
    if hub_error is None or "DPT_Hybrid" not in hub_error or "torch.hub" not in hub_error:
        fail(f"eval_others: an external name without a hub gave {hub_error!r}")
    return launches


def deploy_analysis(tree, record):
    import contextlib
    import io

    from soccdpt_torch.cli import datasets_analysis

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = datasets_analysis.main(["-dt", "bdd", "-b", str(tree), "--max_samples",
                                      str(ANALYSIS_SAMPLES)])
    seconds = time.perf_counter() - t0
    record["datasets_analysis"] = {"result": out, "seconds": seconds}
    log(f"datasets_analysis on the fixture tree in {seconds:.1f} s: {out}")
    fractions = out["class_pixel_fraction"]
    if (json.loads(buf.getvalue()) != out or out["analyzed"] != ANALYSIS_SAMPLES
            or len(fractions) != 3 or not 0.0 < sum(fractions) <= 3.0
            or not np.isfinite(list(out["disparity"].values())).all()):
        fail(f"datasets_analysis: {out}")


def deploy_midas(torch, card, record):
    """MiDaS v2.1 at full width (ResNeXt-101 32x8d), 256x256, weights from
    numpy seed 0 with their drawn BatchNorm statistics: the card's f32
    output against the CPU's (TF32 off) at batch 1 and 2; the card's own
    f32 spread under a nudge of the image, with the drawn statistics and
    with statistics set from two frames (``calibrate``); bf16 walls and
    device time at batch 1 and 2."""
    from soccdpt_torch.models.midas import MidasNetV21
    from soccdpt_torch.weights import init_random_

    t0 = time.perf_counter()
    cpu = init_random_(MidasNetV21(), seed=0).eval()
    weights = sum(p.numel() for p in cpu.parameters())
    x = torch.randn(2, 3, 256, 256, generator=torch.Generator().manual_seed(7))
    set_tf32(torch, False)
    with torch.no_grad():
        want = cpu(x)
        model = copy.deepcopy(cpu).cuda()
        xc = x.cuda()
        errs = {f"b{B}": float((model(xc[:B]).cpu() - want[:B]).abs().max()) for B in (1, 2)}
        got = model(xc)
        nudged = float((model(xc * (1 + MIDAS_NUDGE)) - got).abs().max())
        calibrated_model = copy.deepcopy(model)
        norms = [m for m in calibrated_model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        for m in norms:
            m.momentum = 1.0
        calibrated_model.train()
        calibrated_model(torch.randn(2, 3, 256, 256, device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(8)))
        calibrated_model.eval()
        cal = calibrated_model(xc)
        nudged_cal = float((calibrated_model(xc * (1 + MIDAS_NUDGE)) - cal).abs().max())
    del calibrated_model, cpu
    stats = {"max": float(got.abs().max()), "positive_share": float((got > 0).float().mean()),
             "median": float(got.median())}
    record["midas"] = {"weights": weights, "card_vs_cpu_max_abs_err": errs, "atol": MIDAS_ATOL,
                       "output": stats, "nudged_spread_drawn": nudged,
                       "nudged_spread_calibrated": nudged_cal,
                       "calibrated_output_max": float(cal.abs().max()),
                       "build_and_check_seconds": time.perf_counter() - t0}
    log(f"midas v2.1 ({weights} weights), card vs CPU f32 (TF32 off): max |err| {errs} (atol "
        f"{MIDAS_ATOL}); output {stats}; the card's own spread under a {MIDAS_NUDGE} nudge: "
        f"{nudged:.3g} with the drawn statistics, {nudged_cal:.3g} with statistics set from two "
        f"frames")
    if not bool(torch.isfinite(got).all()) or tuple(got.shape) != (2, 256, 256):
        fail(f"midas: bad output {tuple(got.shape)}")
    if max(errs.values()) > MIDAS_ATOL or stats["positive_share"] < 0.1:
        fail(f"midas: the card's f32 output left the CPU's: {errs}, {stats}")
    set_tf32(torch, True)
    model16 = MidasNetV21(dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.cuda().eval()
    del model
    times = {}
    with torch.no_grad():
        for B in (1, 2):
            xb = xc[:B]
            wall = time_requests(torch, model16, [xb], MIDAS_REPS)["median_ms"]
            ops, device_us = cuda_launches(torch, lambda: model16(xb))
            top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
            times[f"b{B}"] = {"eager_wall_ms": wall, "device_ms": sum(device_us.values()) / 1e3,
                              "device_ops": ops, "top_device_us": top}
            log(f"midas bf16 batch {B}: eager wall {wall:.3f} ms, device "
                f"{times[f'b{B}']['device_ms']:.3f} ms in {ops} operations ({card}); top: "
                f"{[(k[:50], round(us, 1)) for k, us in top[:4]]}")
        out16 = model16(xc)
    if not bool(torch.isfinite(out16).all()):
        fail("midas: the bf16 output is not finite")
    record["midas"]["bf16"] = times
    record["midas"]["bf16_vs_f32_max_abs"] = float((out16.float() - got).abs().max())
    del model16


def deploy_k2_determinism(torch, card, record):
    """Two (``K2_REPEATS``) identical grid requests of the flagship, through
    its CUDA graph and eagerly, at batch 1 and 2: are the grids equal bit
    for bit? K2 adds each run of equal slots to the grid with a float
    atomic, in the order the warps reach it."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.serving import make_serving_fn

    cfg = ModelConfig(model_type=DEPLOY_FLAGSHIP, compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        model.depth_net.head.conv3.weight.mul_(0.01)
        model.depth_net.head.conv3.bias.fill_(0.3)
    probe = make_serving_fn(cfg, model, graph=False)(frames_u8(torch, 1, 100))
    cfg = calibrated(cfg, probe[2])
    model.cfg = cfg
    result = {}
    for graph in (True, False):
        serve = make_serving_fn(cfg, model, compute_occ=True, graph=graph)
        for B in (1, 2):
            frame = frames_u8(torch, B, 300 + B)
            grids = [serve(frame)[3].clone() for _ in range(K2_REPEATS)]
            same = [torch.equal(grids[0], g) for g in grids[1:]]
            result[f"{'graph' if graph else 'eager'}_b{B}"] = {
                "equal_bit_for_bit": all(same), "equal_pairs": sum(same),
                "max_abs_diff": max(float((grids[0] - g).abs().max()) for g in grids[1:]),
                "occupied_cells": int((grids[0].sum(-1) > 0).sum()),
                "mass": float(grids[0].sum())}
        del serve
    record["k2_determinism"] = {"repeats": K2_REPEATS, **result}
    log(f"K2 determinism, {K2_REPEATS} identical flagship grid requests: "
        + "; ".join(f"{k} equal {v['equal_bit_for_bit']} (max diff {v['max_abs_diff']:.3g}, "
                    f"{v['occupied_cells']} cells)" for k, v in result.items()))
    if any(v["occupied_cells"] < 100 for v in result.values()):
        fail(f"K2 determinism: the grids are near empty: {result}")


def deploy_dispatch(torch, card, record):
    """A bare call's host microseconds: the public function (the custom op)
    against the module's ``_launch`` (the kernel's launch, which the
    function called before the op), K1 at the flagship's stage-2 shape and
    K6 at the hybrid's ViT-B shape, bf16 (``scripts/torch_dispatch_ab.py``,
    which also compares two checkouts)."""
    from scripts.torch_dispatch_ab import CALLS, ROUNDS, dispatch_us

    us = dispatch_us(torch)
    record["dispatch"] = {"calls": CALLS, "rounds": ROUNDS, **us}
    log(f"dispatch, host µs a bare call (op / launch alone): K1 {us['k1_call_us']:.2f} / "
        f"{us['k1_launch_us']:.2f}, K6 {us['k6_call_us']:.2f} / {us['k6_launch_us']:.2f} ({card})")


def phase_deploy(torch, card, tmp, tree):
    """Phase 9 on the card; returns the launches of its paths (each path's
    counts set to 0 just before it and read just after)."""
    counters = deploy_counters()
    record = RECORD.setdefault("deploy", {})
    with phase("export and run_exported"):
        launches, pth, program = deploy_exports(torch, card, tmp, counters, record)
    with phase("eval_others"):
        launches.update(deploy_eval_others(torch, card, tree, pth, program, counters, record))
    torch.cuda.empty_cache()
    with phase("datasets_analysis"):
        deploy_analysis(tree, record)
    with phase("midas v2.1"):
        deploy_midas(torch, card, record)
    torch.cuda.empty_cache()
    with phase("K2 determinism and the ops' dispatch"):
        deploy_k2_determinism(torch, card, record)
        deploy_dispatch(torch, card, record)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Data and tensor parallelism: the mesh trainer on the card
# ---------------------------------------------------------------------------

PAR_MODEL = "dpt_swin2_tiny_256"
PAR_BATCH_NCCL = 3  # (a): the training phase's batch, bf16 (``amp``)
PAR_BATCH_GLOO = 2  # (b): the global batch of the two ranks, f32, TF32 off
PAR_GT_HW = (1080, 1920)
PAR_LOSS_RTOL_NCCL = 1e-5  # (a): one process either way, the same kernels
# (b): the bound of the JAX package's flagship steps on its 8 x 1 and 4 x 2
# meshes against one device (tests/test_multichip_flagship.py)
PAR_LOSS_RTOL_GLOO = 2e-4
PAR_TIMED_STEPS = 3


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_base(batch):
    return dict(batch_size=batch, encoder_percentage=TRAINED["swin"]["encoder_percentage"],
                patchwise_percentage=1.0, learning_rate=TRAIN_LR)


def no_dropout(model):
    for mod in model.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
        if hasattr(mod, "drop_path_rates"):
            mod.drop_path_rates = [0.0] * len(mod.drop_path_rates)


def moment_bytes(state):
    return sum(m.numel() * m.element_size() for m in (*state.mu.values(), *state.nu.values()))


def train_snapshot(torch, trainer, state):
    """Every leaf by flax path, both Adam moments (full: ``state`` is
    gathered) and every BatchNorm statistic, detached."""
    stats = {f"{n}.{stat}": getattr(m, stat).detach() for n, m in trainer.model.named_modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
             for stat in ("running_mean", "running_var")}
    return {"leaf": {k: p.detach() for k, p in trainer.params},
            "mu": dict(state.mu), "nu": dict(state.nu), "stats": stats}


def shares_of_bound(torch, got, want, twins):
    """For each kind of :func:`train_snapshot`, the worst leaf's
    ``|got - want| / bound`` with its name: the training phase's bounds
    (``TRAIN_GRAD_REL_LIMIT`` of the leaf's norm plus
    ``TRAIN_GRAD_ATOL_OF_MAX`` of the largest, ``TRAIN_STATS_REL_LIMIT``
    for the statistics) plus ``TRAIN_SPREAD_FACTOR`` times the card's own
    spread, the largest ``|twin - want|`` over ``twins``, further runs of
    the same step (atomic adds in the backward's kernels sum in any order).
    Also the median of that spread relative to the leaves' norms. (Adam's first update is about the
    learning rate times the gradient's sign, so a gradient that rounding
    moves across 0 flips it: the moments carry the gradients'
    comparison.)"""
    shares, spreads = {}, {}
    for kind in ("leaf", "mu", "nu", "stats"):
        limit = TRAIN_STATS_REL_LIMIT if kind == "stats" else TRAIN_GRAD_REL_LIMIT
        floor = 0.0 if kind == "stats" else TRAIN_GRAD_ATOL_OF_MAX * max(
            float(w.norm()) for w in want[kind].values())
        if set(got[kind]) != set(want[kind]):
            fail(f"{kind}: the leaves differ: {sorted(set(got[kind]) ^ set(want[kind]))[:5]}")
        rows = []
        for k, w in want[kind].items():
            spread = max(float((twin[kind][k] - w).norm()) for twin in twins)
            bound = limit * float(w.norm()) + floor + TRAIN_SPREAD_FACTOR * spread
            share = float((got[kind][k] - w).norm()) / bound if bound > 0 else (
                0.0 if torch.equal(got[kind][k], w) else float("inf"))
            rows.append((share, k, spread / max(float(w.norm()), 1e-30)))
        # a NaN takes the lead and fails
        shares[kind] = max(rows, key=lambda r: r[0] if r[0] == r[0] else float("inf"))[:2]
        spreads[kind] = float(np.median([r[2] for r in rows]))
    return shares, spreads


def _parallel_rank(rank, world, store, out):
    """One of the two ranks of part (b): gloo on a FileStore, the card
    shared, one step of the flagship on a (2, 1) and then a (1, 2) mesh."""
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist

    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.data.synthetic import make_batch
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.parallel import mesh as mesh_lib
    from soccdpt_torch.train.trainer import Trainer

    set_tf32(torch, False)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        dev = mesh_lib.init_distributed("cuda:0").device
        mcfg = ModelConfig(model_type=PAR_MODEL, version=3)
        batch = make_batch(0, PAR_BATCH_GLOO, PAR_GT_HW, mcfg.net_size[::-1], mcfg.num_classes)
        result, reference = {}, None
        for shape in ((2, 1), (1, 2)):
            mesh = mesh_lib.make_mesh(shape, (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS))
            trainer = Trainer(mcfg, TrainConfig(**parallel_base(PAR_BATCH_GLOO)), device=dev,
                              mesh=mesh)
            state = trainer.init_state(seed=0)
            no_dropout(trainer.model)
            wa.window_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            launches = wa.window_attention.launches
            # after the gradients' all-reduce, the sharded update and its
            # gather: every leaf, the gathered moments, every statistic
            got = train_snapshot(torch, trainer, trainer.gather_state(state))
            if reference is None:
                reference = torch.load(f"{out}/single.pt", map_location=dev)
            shares, _ = shares_of_bound(torch, got, reference["want"], [reference["twin"]])
            result[f"{shape[0]}x{shape[1]}"] = {
                "loss": float(metrics["loss"]), "step_ms": step_ms,
                "moment_bytes": moment_bytes(state), "sharded_leaves": len(trainer.shards),
                "window_attention_launches": launches,
                "rows": len(trainer.to_device_batch(batch)["image"]),
                "worst_share_of_bound": shares}
            del trainer, state, got
            torch.cuda.empty_cache()
        torch.save(result, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_parallel(torch, card):
    """(a) The mesh trainer at world size 1 over NCCL against the trainer
    with no process group, flagship V3, batch 3, bf16; (b) two ranks that
    share the card over gloo, f32, global batch 2, on a (2, 1) and a (1, 2)
    mesh, against one process's step on that batch."""
    import os

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from soccdpt_torch.core.config import ModelConfig, TrainConfig
    from soccdpt_torch.data.synthetic import make_batch
    from soccdpt_torch.kernels import window_attention as wa
    from soccdpt_torch.parallel import mesh as mesh_lib
    from soccdpt_torch.train.trainer import Trainer
    from soccdpt_torch.weights import named_flax_params

    record = RECORD.setdefault("parallel", {"model_type": PAR_MODEL})
    mcfg = ModelConfig(model_type=PAR_MODEL, version=3)
    net_hw = mcfg.net_size[::-1]

    # --- (a) world 1 over NCCL -------------------------------------------------
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    launches = 0
    try:
        info = mesh_lib.init_distributed()
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and info.device == torch.device("cuda", 0)):
            fail(f"parallel: init_distributed gave {info}, backend "
                 f"{dist.get_backend() if dist.is_initialized() else None}")
        batch = make_batch(0, PAR_BATCH_NCCL, PAR_GT_HW, net_hw, mcfg.num_classes)
        tcfg = TrainConfig(amp=True, **parallel_base(PAR_BATCH_NCCL))
        plain = Trainer(mcfg, tcfg, mesh=mesh_lib.Mesh({"data": 1}))
        # two more plain trainers: the card's own spread between runs of one
        # step (atomic adds in the backward's kernels sum in any order). A
        # leaf of three elements (a block's logit_scale) read 0.91 of its
        # bound with the spread of one pair, so the bound takes the larger
        # of two.
        again = Trainer(mcfg, tcfg, mesh=mesh_lib.Mesh({"data": 1}))
        again2 = Trainer(mcfg, tcfg, mesh=mesh_lib.Mesh({"data": 1}))
        meshed = Trainer(mcfg, tcfg)
        if not (meshed.mesh.distributed and dict(meshed.mesh.shape) == {"data": 1}):
            fail(f"parallel: the default mesh at world 1 is {meshed.mesh}")
        runs = {"plain": plain, "again": again, "again2": again2, "mesh": meshed}
        states = {name: t.init_state(seed=0) for name, t in runs.items()}
        out, walls = {}, {"plain": [], "mesh": []}
        for name, trainer in runs.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            wa.window_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[name], metrics = trainer.train_step(states[name], batch, gen)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            out[name] = {"loss": float(metrics["loss"]),
                         "launches": wa.window_attention.launches}
        launches = out["mesh"]["launches"]
        if any(o["launches"] != 12 for o in out.values()):
            fail(f"parallel: K1 ran {[o['launches'] for o in out.values()]} times in a step "
                 "(plain, again, again2, mesh), expected 12")
        loss_rel = abs(out["mesh"]["loss"] - out["plain"]["loss"]) / abs(out["plain"]["loss"])
        # every leaf after the step, both moments, every BatchNorm statistic,
        # to the training phase's bounds and the card's own spread
        got, want, *twins = (train_snapshot(torch, runs[n], states[n])
                             for n in ("mesh", "plain", "again", "again2"))
        shares, spreads = shares_of_bound(torch, got, want, twins)
        worst_stat = shares.pop("stats")
        log(f"parallel (a) world 1 over NCCL, flagship V3 batch {PAR_BATCH_NCCL} bf16: loss mesh "
            f"{out['mesh']['loss']:.6f} vs plain {out['plain']['loss']:.6f} (rel {loss_rel:.3g}, "
            f"limit {PAR_LOSS_RTOL_NCCL}; two more plain runs {out['again']['loss']:.6f}, "
            f"{out['again2']['loss']:.6f}); worst "
            "share of the bound: "
            + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in shares.items())
            + f", BatchNorm statistics {worst_stat[0]:.3g} ({worst_stat[1]}); the card's own "
            "spread over the plain runs, median of the leaves' norms: "
            + ", ".join(f"{k} {v:.3g}" for k, v in spreads.items())
            + f"; K1 {launches} launches a step")
        if not (loss_rel <= PAR_LOSS_RTOL_NCCL and all(v[0] <= 1.0 for v in shares.values())
                and worst_stat[0] <= 1.0):
            fail("parallel (a): the mesh trainer's step left the plain trainer's")
        for _ in range(PAR_TIMED_STEPS):
            for name in ("plain", "mesh"):
                trainer = runs[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[name], _ = trainer.train_step(states[name], batch)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            meshed.train_step(states["mesh"], batch)
            torch.cuda.synchronize()
        rows = device_events(prof)
        nccl = [(ev.key, ev.device_time_total, ev.count) for ev in rows
                if "nccl" in ev.key.lower()]
        device_ms = sum(ev.device_time_total for ev in rows) / 1e3
        nccl_ms = sum(us for _, us, _ in nccl) / 1e3
        record["world1_nccl"] = {
            "batch": PAR_BATCH_NCCL, "loss_mesh": out["mesh"]["loss"],
            "loss_plain": out["plain"]["loss"], "loss_rel_err": loss_rel,
            "loss_plain_again": [out["again"]["loss"], out["again2"]["loss"]],
            "worst_share_of_bound": {k: v[0] for k, v in shares.items()},
            "worst_stat_share_of_bound": worst_stat[0], "median_plain_spread": spreads,
            "step_ms_plain": walls["plain"], "step_ms_mesh": walls["mesh"],
            "median_step_ms_plain": float(np.median(walls["plain"][1:])),
            "median_step_ms_mesh": float(np.median(walls["mesh"][1:])),
            "device_ms_mesh_step": device_ms, "nccl_device_ms": nccl_ms,
            "nccl_kernels": [{"name": k[:100], "device_us": us, "calls": c} for k, us, c in nccl],
            "window_attention_launches_per_step": launches}
        log(f"parallel (a) step wall, median of {PAR_TIMED_STEPS} after the first: plain "
            f"{record['world1_nccl']['median_step_ms_plain']:.2f} ms, mesh "
            f"{record['world1_nccl']['median_step_ms_mesh']:.2f} ms (first steps "
            f"{walls['plain'][0]:.1f} / {walls['mesh'][0]:.1f}); one mesh step's device time "
            f"{device_ms:.3f} ms, of which NCCL kernels {nccl_ms:.4f} ms in "
            f"{sum(c for *_, c in nccl)} launches {[k[:60] for k, _, _ in nccl]} ({card})")
        del plain, again, again2, meshed, runs, states, got, want, twins
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # --- (b) two ranks on the one card over gloo, f32 ----------------------------
    set_tf32(torch, False)
    batch = make_batch(0, PAR_BATCH_GLOO, PAR_GT_HW, net_hw, mcfg.num_classes)
    with tempfile.TemporaryDirectory(prefix="parallel_") as tmp:
        # the single process's step, twice: the second run is the card's own
        # spread, which the bounds add as in (a)
        reference = {}
        for run in ("want", "twin"):
            single = Trainer(mcfg, TrainConfig(**parallel_base(PAR_BATCH_GLOO)))
            state = single.init_state(seed=0)
            no_dropout(single.model)
            state, metrics = single.train_step(state, batch)
            reference[run] = {kind: {k: v.cpu() for k, v in leaves.items()} for kind, leaves
                              in train_snapshot(torch, single, state).items()}
            if run == "want":
                loss_single, bytes_single = float(metrics["loss"]), moment_bytes(state)
            del single, state
        torch.save(reference, f"{tmp}/single.pt")
        del reference
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(_parallel_rank, args=(2, f"{tmp}/store", tmp), nprocs=2,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    record["two_ranks_gloo"] = {"batch": PAR_BATCH_GLOO, "loss_single": loss_single,
                                "moment_bytes_single": bytes_single, "ranks": ranks,
                                "seconds": spawn_s}
    for shape in ("2x1", "1x2"):
        for r, rank in enumerate(ranks):
            got = rank[shape]
            rel = abs(got["loss"] - loss_single) / abs(loss_single)
            log(f"parallel (b) {shape} rank {r}: loss {got['loss']:.6f} vs one process "
                f"{loss_single:.6f} (rel {rel:.3g}, limit {PAR_LOSS_RTOL_GLOO}); {got['rows']} "
                f"rows; moments {got['moment_bytes'] / 1e6:.2f} MB (one process "
                f"{bytes_single / 1e6:.2f} MB); {got['sharded_leaves']} leaves sharded; step "
                f"{got['step_ms']:.1f} ms; K1 {got['window_attention_launches']} launches")
            log(f"parallel (b) {shape} rank {r}: after the step, worst share of the bound "
                "against one process: " + ", ".join(
                    f"{k} {v[0]:.3g} ({v[1]})" for k, v in got["worst_share_of_bound"].items()))
            if not rel <= PAR_LOSS_RTOL_GLOO:
                fail(f"parallel (b) {shape}: rank {r}'s loss left the single process's")
            if not all(v[0] <= 1.0 for v in got["worst_share_of_bound"].values()):
                fail(f"parallel (b) {shape}: rank {r}'s weights, moments or statistics after "
                     "the step left the single process's")
            if got["window_attention_launches"] != 12:
                fail(f"parallel (b) {shape}: K1 ran {got['window_attention_launches']} times")
    if not (ranks[0]["1x2"]["sharded_leaves"] >= 20 and ranks[0]["2x1"]["sharded_leaves"] == 0
            and ranks[0]["1x2"]["moment_bytes"] < ranks[0]["2x1"]["moment_bytes"]):
        fail("parallel (b): tp 2 did not shard the moments")
    log(f"parallel (b) {spawn_s:.1f} s for both ranks' two meshes, start-up included ({card})")
    return {"window_attention": launches}


# ---------------------------------------------------------------------------
# Reference-layout torch checkpoints: the inverse of core/torch_import.py
# ---------------------------------------------------------------------------

_SWIN_BLOCK_KEYS = {
    ("attn", "qkv", "kernel"): ("attn.qkv.weight", "dense"),
    ("attn", "qkv", "bias"): ("attn.qkv.bias", None),
    ("attn", "rel_pos_table"): ("attn.relative_position_bias_table", None),
    ("attn", "q_bias"): ("attn.q_bias", None),
    ("attn", "v_bias"): ("attn.v_bias", None),
    ("attn", "logit_scale"): ("attn.logit_scale", None),
    ("attn", "proj", "kernel"): ("attn.proj.weight", "dense"),
    ("attn", "proj", "bias"): ("attn.proj.bias", None),
    ("attn", "cpb_mlp_0", "kernel"): ("attn.cpb_mlp.0.weight", "dense"),
    ("attn", "cpb_mlp_0", "bias"): ("attn.cpb_mlp.0.bias", None),
    ("attn", "cpb_mlp_1", "kernel"): ("attn.cpb_mlp.2.weight", "dense"),
}
_VIT_BLOCK_KEYS = {
    ("qkv", "kernel"): ("attn.qkv.weight", "dense"),
    ("qkv", "bias"): ("attn.qkv.bias", None),
    ("q_bias",): ("attn.q_bias", None),
    ("v_bias",): ("attn.v_bias", None),
    ("rel_pos_table",): ("attn.relative_position_bias_table", None),
    ("proj", "kernel"): ("attn.proj.weight", "dense"),
    ("proj", "bias"): ("attn.proj.bias", None),
    ("gamma_1",): ("gamma_1", None),
    ("gamma_2",): ("gamma_2", None),
}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}
_HEAD_CONVS = {"conv1": 0, "conv2": 2, "conv3": 4}  # depth head: output_conv.{0,2,4}
_SEG_HEAD_MODS = {"conv1": 0, "bn": 1, "conv2": 4}  # seg head: conv3x3, BN, conv1x1


def _torch_layout(arr, layout):
    """A flax leaf in torch's layout (the inverse of torch_import's)."""
    if layout == "by_rank":  # Next-ViT's kernels: 4-D conv, 2-D dense
        layout = "conv" if arr.ndim == 4 else "dense"
    if layout == "dense":
        return arr.T
    if layout == "conv":
        return arr.transpose(3, 2, 0, 1)
    if layout == "conv_t":  # torch_import._conv_t flips; flip back
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _norm_or_mlp(rest):
    """(torch name, layout) of a block's norm and MLP leaves, else None."""
    if rest[0] in ("norm1", "norm2"):
        return f"{rest[0]}.{_LEAF[rest[1]]}", None
    if rest[0] in ("mlp_fc1", "mlp_fc2"):
        return f"mlp.fc{rest[0][-1]}.{_LEAF[rest[1]]}", "dense" if rest[1] == "kernel" else None
    return None


# LeViT: flax module -> timm's flat ``blocks`` index, as the reader numbers
# them (its default stage depths (4, 4, 4); a shallower model's names are a
# subset)
_LEVIT_BLOCKS = {}
for _s in range(3):
    for _d in range(4):
        _LEVIT_BLOCKS[f"s{_s}_attn{_d}"] = ("attn", 10 * _s + 2 * _d)
        _LEVIT_BLOCKS[f"s{_s}_mlp{_d}"] = ("mlp", 10 * _s + 2 * _d + 1)
    if _s < 2:
        _LEVIT_BLOCKS[f"downsample{_s}_attn"] = ("sub", 10 * _s + 8)
        _LEVIT_BLOCKS[f"downsample{_s}_mlp"] = ("mlp", 10 * _s + 9)
_LEVIT_ATTN_MODS = {"qkv": "qkv", "kv": "kv", "q": "q.1", "proj": "proj.1"}


def _levit_key(name, rest, leaf):
    if name.startswith("stem"):
        mod = "c" if rest[0] == "conv" else "bn"
        return f"patch_embed.{2 * int(name[4:])}.{mod}.{leaf}", "conv" if mod == "c" else None
    kind, n = _LEVIT_BLOCKS[name]
    pre = f"blocks.{n}." + ("m." if kind == "attn" else "")
    if rest == ("attn_bias",):
        return pre + "attention_biases", None
    if kind == "mlp":
        pre += "m.0." if rest[0] == "fc1" else "m.2."
    else:
        pre += _LEVIT_ATTN_MODS[rest[0]] + "."
    if rest[1] == "linear":
        return pre + "c.weight", "dense"
    return pre + f"bn.{leaf}", None


def _backbone_key(path, family):
    """(torch key under ``pretrained.``, layout) of a backbone leaf."""
    m = "model."
    name, rest = path[0], path[1:]
    leaf = _LEAF.get(path[-1], path[-1])
    if family == "levit":
        key, layout = _levit_key(name, rest, leaf)
        return m + key, layout
    if family == "next_vit":
        # the official module names, verbatim; the reader tells a conv from
        # a linear by rank
        root = "stem" if name.startswith("stem") else "features"
        mods = ".".join(rest[:-1])
        return f"{m}{root}.{name[len(root):]}.{mods}.{leaf}", (
            "by_rank" if path[-1] == "kernel" else None)
    if family == "swin":
        if name == "patch_embed":
            return f"{m}patch_embed.proj.{leaf}", "conv" if leaf == "weight" else None
        if name == "patch_norm":
            return f"{m}patch_embed.norm.{leaf}", None
        if name.startswith("stage"):
            i, j = name[5:].split("_block")
            key = _SWIN_BLOCK_KEYS.get(rest) or _norm_or_mlp(rest)
            return f"{m}layers.{i}.blocks.{j}.{key[0]}", key[1]
        if name.startswith("downsample"):
            i = name[len("downsample"):]
            if rest[0] == "reduction":
                return f"{m}layers.{i}.downsample.reduction.weight", "dense"
            return f"{m}layers.{i}.downsample.norm.{leaf}", None
    if name in ("cls_token", "pos_embed"):
        return m + name, None
    if name.startswith("block"):
        key = _VIT_BLOCK_KEYS.get(rest) or _norm_or_mlp(rest)
        return f"{m}blocks.{name[5:]}.{key[0]}", key[1]
    if name.startswith("readout"):
        return f"act_postprocess{name[-1]}.0.project.0.{leaf}", "dense" if leaf == "weight" else None
    if name.startswith("proj"):
        return f"act_postprocess{name[-1]}.3.{leaf}", "conv" if leaf == "weight" else None
    ups = {"up4x": (1, "conv_t"), "up2x": (2, "conv_t"), "down2x": (4, "conv")}
    if name in ups:
        lvl, layout = ups[name]
        return f"act_postprocess{lvl}.4.{leaf}", layout if leaf == "weight" else None
    if family == "vit" and name == "patch_embed":
        return f"{m}patch_embed.proj.{leaf}", "conv" if leaf == "weight" else None
    if family == "hybrid":
        pe = f"{m}patch_embed."
        if name == "patch_embed_proj":
            return f"{pe}proj.{leaf}", "conv" if leaf == "weight" else None
        if name == "stem_conv":
            return f"{pe}backbone.stem.conv.weight", "conv"
        if name == "stem_gn":
            return f"{pe}backbone.stem.norm.{leaf}", None
        if name.startswith("stage"):
            s, b = name[5:].split("_block")
            blk = f"{pe}backbone.stages.{s}.blocks.{b}."
            mod = {"downsample_conv": "downsample.conv", "downsample_gn": "downsample.norm",
                   "gn1": "norm1", "gn2": "norm2", "gn3": "norm3"}.get(rest[0], rest[0])
            return blk + f"{mod}.{leaf}", "conv" if rest[0].startswith(("conv", "downsample_conv")) else None
    raise KeyError(f"no reference key for backbone leaf {'/'.join(path)} ({family})")


def _dpt_key(path, family, seg_head=False):
    """(torch key relative to a DPT, layout) of a DPT leaf."""
    name, leaf = path[0], _LEAF.get(path[-1], path[-1])
    conv = "conv" if path[-1] == "kernel" else None
    if name == "backbone":
        key, layout = _backbone_key(path[1:], family)
        return "pretrained." + key, layout
    if name.startswith("layer") and name.endswith("_rn"):
        return f"scratch.{name}.weight", "conv"
    if name.startswith("refinenet"):
        if path[1] == "out_conv":
            return f"scratch.{name}.out_conv.{leaf}", conv
        unit = path[1].replace("res_conv_unit", "resConfUnit")
        return f"scratch.{name}.{unit}.{path[2]}.{leaf}", conv
    if name == "head":
        idx = (_SEG_HEAD_MODS if seg_head else _HEAD_CONVS)[path[1]]
        return f"scratch.output_conv.{idx}.{leaf}", conv
    if name == "stem_transpose":  # LeViT's: up1, bn1 at .0; up2, bn2 at .2
        idx = 2 * (int(path[1][-1]) - 1)
        if path[1].startswith("up"):
            return f"scratch.stem_transpose.{idx}.c.weight", "conv_t"
        return f"scratch.stem_transpose.{idx}.bn.{leaf}", None
    raise KeyError(f"no reference key for DPT leaf {'/'.join(path)}")


def reference_state_dict(variables, version, family):
    """A reference-layout state dict (numpy) of a SOccDPT model from its
    JAX variables tree (``weights.to_jax_variables`` of a port model, or
    the JAX package's own): the keys and layouts that
    ``core/torch_import.py::import_soccdpt`` reads, every leaf of the tree
    written once. The 3-D occupancy head has no reference keys."""
    sd = {}
    for coll in ("params", "batch_stats"):
        stack = [((), variables.get(coll, {}))]
        while stack:
            path, node = stack.pop()
            if isinstance(node, dict):
                stack += [(path + (k,), v) for k, v in node.items()]
                continue
            top, rest = path[0], path[1:]
            if top == "occupancy_conv":
                continue
            if top in ("depth_net", "seg_net", "pretrained"):
                key, layout = _dpt_key(rest, family, seg_head=(top == "seg_net"))
            elif top == "seg_head":
                key, layout = f"{_SEG_HEAD_MODS[rest[0]]}.{_LEAF[rest[-1]]}", (
                    "conv" if rest[-1] == "kernel" else None)
            elif top == "depth_head":
                key, layout = f"{_HEAD_CONVS[rest[0]]}.{_LEAF[rest[-1]]}", (
                    "conv" if rest[-1] == "kernel" else None)
            else:
                raise KeyError(f"no reference key for {'/'.join(path)}")
            if version == 2 and top == "seg_head":
                top = "seg_ead"  # the reference's own spelling of V2's seg head
            sd[f"{top}.{key}"] = np.ascontiguousarray(_torch_layout(np.asarray(node), layout))
    return sd


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
                     "global_attention_bwd", "fused_rcu", "fused_fusion", "fused_head",
                     "upsample", "unproject_slots"):
            for line in _build.build_log(name).splitlines():
                if "spill" in line and " 0 bytes spill stores" not in line:
                    log(f"  ptxas {name}: {line.strip()}")
    set_tf32(torch, False)
    log("TF32 is off for the parity phases (cudnn.allow_tf32 = matmul.allow_tf32 = False)")

    sass = tensor_core_proof(_build)
    with phase("K1 against its plain version"):
        k1 = phase_k1(torch, F, wa, sass)
    with phase("K6 against its plain version"):
        k6 = phase_k6(torch, F, ga, sass)
    with phase("K7 against its plain version"):
        k7 = phase_k7(torch, F, ga, sass)
    with phase("the decoder's upsample against its plain version"):
        ku = phase_upsample(torch, F, _build)
    with phase("the geometry tail against its plain version"):
        kg = phase_geometry(torch, _build)
    with phase("K3, K4, K5 against their plain versions and the live decoder"):
        k3, k4, k5 = phase_decoder(torch, F, sass)
    torch.cuda.empty_cache()
    # launches of the attention kernels and K2 on each main path
    path_launches = {}
    for label, name in (("swin", "serving dpt_swin2_tiny_256"),
                        ("beit", "serving dpt_beit_large_512"),
                        ("swin_v1", "serving V1 dpt_swin2_tiny_256"),
                        ("swin_v2", "serving V2 dpt_swin2_tiny_256"),
                        ("hybrid", "serving dpt_hybrid_384"),
                        ("swin1", "serving dpt_swin_large_384"),
                        ("levit", "serving dpt_levit_224"),
                        ("next_vit", "serving dpt_next_vit_large_384")):
        set_tf32(torch, False)
        with phase(name):
            path_launches[f"serve_{label}"], served_problem = phase_serving(torch, card, label)
        if label == "swin":
            problem = served_problem
        torch.cuda.empty_cache()
    set_tf32(torch, True)
    with phase("serve_stream dpt_swin2_tiny_256"):
        path_launches["stream_swin"] = phase_stream(torch, card)
    torch.cuda.empty_cache()
    set_tf32(torch, False)
    with phase("K2 against its plain version"):
        k2 = phase_k2(torch, ss, problem, _build)
    torch.cuda.empty_cache()
    for label, name in (("beit", "training dpt_beit_large_512"),
                        ("swin", "training dpt_swin2_tiny_256"),
                        ("swin_v1", "training V1 dpt_swin2_tiny_256"),
                        ("swin_v2", "training V2 dpt_swin2_tiny_256"),
                        ("swin1", "training dpt_swin_large_384"),
                        ("levit", "training dpt_levit_224"),
                        ("next_vit", "training dpt_next_vit_large_384")):
        with phase(name):
            path_launches[f"train_{label}"] = phase_training(torch, card, label)
        torch.cuda.empty_cache()
    with phase("vit3d refine on the full grid"):
        phase_vit3d(torch, card)
    torch.cuda.empty_cache()
    with phase("occupancy training dpt_swin2_tiny_256"):
        path_launches["train_occ_swin"] = phase_occupancy(torch, card)
    torch.cuda.empty_cache()
    with phase("bench, eval_timing, eval_patchwise"):
        phase_clis(torch, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="clis_") as tmp_name:
        tmp = Path(tmp_name)
        tree = write_cli_tree(tmp)
        path_launches.update(phase_train_eval_clis(torch, card, tmp, tree))
        torch.cuda.empty_cache()
        path_launches.update(phase_deploy(torch, card, tmp, tree))
    torch.cuda.empty_cache()
    with phase("data and tensor parallelism dpt_swin2_tiny_256"):
        path_launches["parallel_world1"] = phase_parallel(torch, card)
    torch.cuda.empty_cache()
    for path, name in (("train_cli_swin", "window_attention"),
                       ("train_cli_hybrid", "global_attention"),
                       ("train_cli_hybrid", "global_attention_backward"),
                       ("deploy_flagship", "window_attention"),
                       ("deploy_flagship_points", "window_attention"),
                       ("deploy_flagship_points", "unproject_slots"),
                       ("deploy_hybrid", "global_attention"),
                       ("eval_others_pt2", "window_attention"),
                       ("parallel_world1", "window_attention")):
        if path_launches[path][name] < 1:
            fail(f"{name} was launched no time on {path}")
    del served_problem
    # each kernel's time inside a served request, from the profile of the
    # configuration whose attention it is (K2 and the geometry tail: the
    # flagship's; the upsample: BEiT-large's, the rig's configuration), and
    # inside a training step
    served_in = {"window_attention": "swin", "segment_sum": "swin", "global_attention": "beit",
                 "upsample2x": "beit", "unproject_slots": "swin"}
    trained_in = {"window_attention": "train_swin", "global_attention": "train_beit",
                  "global_attention_backward": "train_beit"}
    for k in (k1, k2, k6, k7, ku, kg):
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
    kernels = [k1, k2, k3, k4, k5, k6, k7, ku, kg]
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
