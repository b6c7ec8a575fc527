"""Rehearse the bf16 routes on the tensor cores without a card.

    python soccdpt_torch/csrc/emulation/rehearse.py [global] [window] [head] [segment] [unproject]

With no argument all five run. Each compiles a route's kernels with g++
against the emulated ``wgmma_common.cuh`` beside this file, into
``build/wgmma_emulation/``, and drives the real wrappers on CPU tensors
through the emulated library:

* ``global``: K6 and K7 (``namespace wgattn`` of
  ``csrc/global_attention.cu`` and ``csrc/global_attention_bwd.cu``, with
  ``csrc/attention_wgmma.cuh``) through ``kernels/global_attention.py``'s
  ``_launch`` and ``_launch_backward``: out, lse, dq, dk, dv and dbias
  against the plain versions at the bf16 bound (2e-2, atol = rtol; lse to
  1e-4), and a second backward to the same bits;
* ``window``: K1 (``namespace wgattn`` of ``csrc/window_attention.cu``)
  through ``kernels/window_attention.py``'s ``_launch``, against
  ``window_attention_plain`` at the bf16 bound (atol 5e-2), and a second
  call to the same bits;
* ``head``: K5 (``namespace wghead`` of ``csrc/fused_head.cu``, with
  ``csrc/conv_wgmma.cuh``, and all of ``csrc/upsample.cu`` with
  ``csrc/upsample.cuh``) through ``kernels/fused_head.py``'s ``_launch``:
  prepare, upsample, head conv,
  against ``fused_head_tail_plain`` at the decoder's bf16 bound (2e-2 of
  the largest value plus 2e-2 relative).

* ``segment``: K2 (all of ``csrc/segment_sum.cu``, against the SIMT
  emulation ``simt_common.cuh`` beside this file) through
  ``kernels/segment_sum.py``'s ``_launch`` and ``_launch_backward``: sums
  against ``segment_sum_plain`` (rtol 1e-5, atol 1e-5; 1e-4 where all
  rows land in one cell) on contiguous rows,
  channel-major and strided views, batch-folded keys with runs of equal
  slots, NaN values on dropped rows, C = 1 ... 5, N = 0; the gradient
  against ``segment_sum_backward_plain`` bit for bit.
* ``unproject``: the geometry tail (all of ``csrc/unproject_slots.cu``,
  against ``simt_common.cuh``) through ``kernels/unproject_slots.py``'s
  ``launch``: points and slots bit for bit against ``card_tail``, a numpy
  model of the plain path's arithmetic on the card (a product by the
  scalar's f32 reciprocal for ``/ fx``, cuBLAS's FMA chain for the
  rotation), on images whose pixel count is below a warp's 128, a
  multiple of it and neither, with slots and without, inverse depths of
  0, inf, NaN and below 0 among them; and, printed only, the share of
  slots equal to the plain CPU version's.

A few small shapes take minutes: every CUDA thread is an OS thread. A pass
here says the ring, the barriers, the descriptors and the fragment layouts
agree with the emulation's reading of the hardware, not that nvcc accepts
the code.
"""
import ctypes
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent
REPO = CSRC.parents[1]
OUT = REPO / "build" / "wgmma_emulation"
sys.path.insert(0, str(REPO))

from soccdpt_torch.core.config import CameraConfig, OccupancyConfig  # noqa: E402
from soccdpt_torch.kernels import _build  # noqa: E402
from soccdpt_torch.kernels import fused_head as fh  # noqa: E402
from soccdpt_torch.kernels import global_attention as ga  # noqa: E402
from soccdpt_torch.kernels import segment_sum as ss  # noqa: E402
from soccdpt_torch.kernels import unproject_slots as us  # noqa: E402
from soccdpt_torch.kernels import window_attention as wa  # noqa: E402
from soccdpt_torch.ops.geometry import rotation_matrix  # noqa: E402

# (B, H, T, d, bias dtype, strided): ragged tiles, d = 16 and 128, a bf16
# bias, three images (two groups in the dq kernel), the strided q, k, v of
# one qkv tensor, a single token
GLOBAL_CASES = [
    (2, 2, 65, 16, torch.float32, False),
    (1, 2, 129, 64, torch.bfloat16, False),
    (3, 2, 70, 128, torch.bfloat16, False),
    (3, 2, 130, 64, torch.float32, False),
    (2, 1, 130, 32, None, True),
    (1, 1, 1, 16, None, False),
]
# (Bw, H, N, d, nW, strided, bias and tau dtype): swin2test_64's N = 16, d =
# 16; the flagship's last stage (N = 64); N = 256 with a mask at Bw = 2 nW;
# the 384-px configs' N = 576 (a ring that wraps); the strided views of one
# qkv tensor with a bf16 tau and bias, as a bf16 model hands them over; an
# odd N (7x7 windows), whose bias and mask rows take scalar loads
WINDOW_CASES = [
    (8, 2, 16, 16, 4, False, torch.float32),
    (4, 2, 49, 32, 2, False, torch.bfloat16),
    (2, 3, 64, 32, None, False, torch.float32),
    (4, 1, 256, 32, 2, False, torch.float32),
    (1, 1, 576, 32, None, False, torch.float32),
    (4, 2, 64, 32, 2, True, torch.bfloat16),
]
# (B, H, W, Ci, Cm): Cm = 8 (one N tile, mostly zero columns), Cm = 36
# (columns padded to 40), a ragged map, and Cm = 136 (two N tiles walked)
HEAD_CASES = [(1, 8, 8, 8, 8), (2, 5, 13, 64, 36), (1, 7, 9, 16, 8), (1, 4, 6, 16, 136)]
# (B, N, C, layout, keys): layout "rows" (contiguous (B, N, C)), "channels"
# (a (B, C, N) tensor seen as (B, N, C), as the served voxelizer hands it
# over) or "strided" (every other row of a larger tensor); keys "random"
# (with negative and out-of-range ones), "runs" (image-ordered, runs of
# equal slots up to 300 rows long, some dropped), "one" (one cell) or
# "dropped" (none kept, NaN values)
SEGMENT_CASES = [
    (1, 1001, 3, "rows", "random"),
    (2, 1024, 3, "channels", "runs"),
    (2, 1000, 3, "channels", "runs"),
    (1, 700, 3, "strided", "runs"),
    (1, 4096, 3, "rows", "one"),
    (1, 520, 2, "rows", "dropped"),
    (2, 640, 1, "channels", "runs"),
    (1, 900, 5, "strided", "runs"),
    (2, 512, 4, "rows", "runs"),
    (1, 0, 3, "rows", "random"),
]
# (B, H, W, slots): images of 35 pixels (one at a time), 512 (whole warps),
# 1961 (H W odd: one at a time), 2640 (whole warps and a ragged end), points alone
UNPROJECT_CASES = [(1, 5, 7, True), (3, 16, 32, True), (2, 37, 53, True), (2, 40, 66, True),
                   (2, 40, 66, False)]
UNPROJECT_CAMERA = (40.0, 41.5, 26.25, 18.0)  # fx, fy, cx, cy
UNPROJECT_OCC = dict(pc_scale=(3.6, 6.4, 2.207), pc_shift=(64.0, 64.0, 11.69),
                     correction_angle=(7.0, 0.0, 0.0), grid_size=(256, 256, 32),
                     scale=(2.0, 2.0, 0.666))


def _split_args(s):
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _emulated(code):
    """CUDA source rewritten for the emulation: shared arrays from the CTA's
    buffers, ``<<<...>>>`` launches as ``emu_launch`` calls."""
    code = re.sub(r"extern __shared__ unsigned char (\w+)\[\];",
                  r"unsigned char* \1 = emu_smem();", code)
    code = re.sub(r"__shared__ (\w+) (\w+)\[[^\]]*\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_static_smem());", code)

    def launch(m):
        grid, threads, smem, _ = _split_args(m.group(2))
        return f"emu_launch({m.group(1)}, dim3({grid}), {threads}, {smem}, {m.group(3)});"

    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\((.*?)\);", launch, code, flags=re.S)


def _slice(name, namespace, entries):
    """A source's namespace and the C entries named, rewritten; with no
    namespace the whole source, whose headers the unit already includes."""
    s = (CSRC / name).read_text()
    if namespace is None:
        return _emulated(re.sub(r'#include "[^"]*"\n', "", s))
    end = f"}}  // namespace {namespace}"
    kern = s[s.index(f"namespace {namespace} {{"):s.index(end) + len(end)]
    funcs = [re.search(rf"(int {e}\(.*?\n}}\n)", s, flags=re.S).group(1) for e in entries]
    return (_emulated(kern) + '\nextern "C" {\nconst char* soccdpt_error_string(int code) '
            "{ return hopper::error_string(code); }\n" + "".join(funcs) + "}\n")


ROUTES = {
    # name: (library name, source, namespace, C entries, headers after wgmma_common.cuh)
    "global": [("global_attention", "global_attention.cu", "wgattn",
                ["soccdpt_global_attention_bf16"], ["attention_wgmma.cuh"]),
               ("global_attention_bwd", "global_attention_bwd.cu", "wgattn",
                ["soccdpt_global_attention_bwd_bf16"], ["attention_wgmma.cuh"])],
    "window": [("window_attention", "window_attention.cu", "wgattn",
                ["soccdpt_window_attention_bf16"], ["attention_wgmma.cuh"])],
    "head": [("fused_head", "fused_head.cu", "wghead",
              ["soccdpt_prepare_head_bf16", "soccdpt_head_conv_bf16"],
              ["upsample.cuh", "conv_wgmma.cuh"]),
             ("upsample", "upsample.cu", None, [], ["upsample.cuh"])],
}


def build(route):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "wgmma_common.cuh").write_text((HERE / "wgmma_common.cuh").read_text())
    for stub in ("cuda.h", "cuda_bf16.h", "cuda_runtime.h"):
        (OUT / stub).write_text("#pragma once\n")
    libs = {}
    for name, src, namespace, entries, headers in ROUTES[route]:
        for header in headers:
            (OUT / header).write_text(_emulated((CSRC / header).read_text()))
        tu = OUT / f"{name}.cpp"
        tu.write_text('#include "wgmma_common.cuh"\n'
                      + "".join(f'#include "{h}"\n' for h in headers)
                      + _slice(src, namespace, entries))
        lib = OUT / f"lib{name}_emulated.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-Wno-unknown-pragmas", "-I", str(OUT), "-o", str(lib), str(tu)],
                       check=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].soccdpt_error_string.restype = ctypes.c_char_p
    return libs


def build_simt(name):
    """A whole source, ``csrc/<name>.cu``, against ``simt_common.cuh``, its
    includes stubbed."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    for stub in ("cuda_runtime.h", "cache_hints.cuh"):
        (out / stub).write_text("#pragma once\n")
    tu = out / f"{name}.cpp"
    tu.write_text((HERE / "simt_common.cuh").read_text() + "\n"
                  + _emulated((CSRC / f"{name}.cu").read_text()))
    lib = out / f"lib{name}_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(out), "-o", str(lib), str(tu)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.soccdpt_error_string.restype = ctypes.c_char_p
    return {name: lib}


def segment_problem(B, N, C, layout, keys, seed=0):
    """(lin (B*N,) int32, vals (B, N, C) in the layout named, num_slots)."""
    rng = np.random.default_rng(seed)
    cells = 997
    S = B * cells
    if keys == "runs":
        lin = np.concatenate([np.repeat(rng.integers(0, cells, 64), rng.integers(1, 300, 64))[:N]
                              + b * cells for b in range(B)])
        lin[rng.random(B * N) < 0.1] = -1
    elif keys == "one":
        lin = np.full(B * N, 7)
    elif keys == "dropped":
        lin = np.where(rng.random(B * N) < 0.5, -3, S + 5)
    else:
        lin = rng.integers(-50, S + 50, B * N)
    vals = rng.uniform(size=(B, N, C)).astype(np.float32)
    vals.reshape(-1, C)[(lin < 0) | (lin >= S)] = np.nan  # a dropped row is never read
    vals = torch.from_numpy(vals)
    if layout == "channels":
        vals = vals.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "strided":
        vals = torch.stack([vals, torch.zeros_like(vals)], 2).reshape(B, 2 * N, C)[:, ::2]
    return torch.from_numpy(lin.astype(np.int32)), vals, S


def run_segment(B, N, C, layout, keys):
    lin, vals, S = segment_problem(B, N, C, layout, keys)
    print(f"K2 B={B} N={N} C={C} {layout} {keys}")
    want = ss.segment_sum_plain(lin, vals, S)
    rtol = 1e-4 if keys == "one" else 1e-5
    ok = _close("sum", ss._launch(lin, vals, S), want, 1e-5, rtol)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal((S, C)).astype(np.float32))
    got = ss._launch_backward(lin, cot)
    same = torch.equal(got, ss.segment_sum_backward_plain(lin, cot))
    print(f"  gradient bit for bit: {same}")
    return ok and same


def card_tail(inv, camera, occ, slots):
    """The plain path's arithmetic on the card, op by op in numpy f32:
    ``(points, slot or None)``."""
    f = np.float32
    fx, fy, cx, cy = (f(c) for c in camera)
    B, H, W = inv.shape
    clamped = np.where(np.isnan(inv), inv, np.maximum(inv, f(1e-8)))
    depth = f(1) / clamped
    x = ((np.arange(W, dtype=f) - cx) * depth) * (f(1) / fx)
    y = ((np.arange(H, dtype=f)[:, None] - cy) * depth) * (f(1) / fy)
    points = np.stack([x, y, depth], -1)
    if not slots:
        return points, None
    p = points.reshape(B, -1, 3) * np.asarray(occ.pc_scale, f) + np.asarray(occ.pc_shift, f)
    r = rotation_matrix(occ.correction_angle).astype(np.float64)
    p64 = p.astype(np.float64)
    # fma(p2, R2j, fma(p1, R1j, p0 R0j)): exact products in f64, one rounding each
    q = (p64[..., :1] * r[0]).astype(f)
    q = (p64[..., 1:2] * r[1] + q).astype(f)
    q = (p64[..., 2:] * r[2] + q).astype(f)
    finite = np.isfinite(q).all(-1)
    q = np.where(finite[..., None], q, f(0))
    cell = (q / np.asarray(occ.occupancy_shape, f)) * np.asarray(occ.grid_size, f)
    ijk = np.clip(cell.astype(np.float64), -2.0**31, 2.0**31 - 1).astype(np.int64)
    grid = np.asarray(occ.grid_size)
    keep = finite & ((ijk > 0) & (ijk < grid)).all(-1)
    gx, gy, gz = occ.grid_size
    lin = (ijk[..., 0] * gy + ijk[..., 1]) * gz + ijk[..., 2] + np.arange(B)[:, None] * gx * gy * gz
    return points, np.where(keep, lin, -1).reshape(-1).astype(np.int32)


def run_unproject(B, H, W, slots):
    rng = np.random.default_rng(3)
    inv = rng.uniform(0.05, 0.7, (B, H, W)).astype(np.float32)
    flat = inv.reshape(-1)
    for i, special in enumerate((0.0, np.inf, np.nan, -0.3, 1e-12, -np.inf)):
        flat[(7 * i + 3) % flat.size] = special
    fx, fy, cx, cy = UNPROJECT_CAMERA
    scale = (H / 54.0, W / 64.0)
    camera = CameraConfig(fx=fx * scale[1], fy=fy * scale[0], cx=cx * scale[1],
                          cy=cy * scale[0], width=W, height=H)
    occ = OccupancyConfig(**UNPROJECT_OCC)
    print(f"geometry tail B={B} H={H} W={W} slots={slots}")
    t = torch.from_numpy(inv)
    points, slot = us.launch(t, [camera.fx, camera.fy, camera.cx, camera.cy], occ.pc_scale,
                             occ.pc_shift, occ.correction_angle, occ.grid_size, occ.scale, slots)
    want_points, want_slot = card_tail(inv, (camera.fx, camera.fy, camera.cx, camera.cy), occ,
                                       slots)
    ok = np.array_equal(points.numpy().view(np.int32), want_points.view(np.int32))
    print(f"  points bit for bit: {ok}")
    if slots:
        same = np.array_equal(slot.numpy(), want_slot)
        kept = float((want_slot >= 0).mean())
        plain = us.unproject_slots_plain(t, [camera.fx, camera.fy, camera.cx, camera.cy],
                                         occ.pc_scale, occ.pc_shift, occ.correction_angle,
                                         occ.grid_size, occ.scale, True)[1]
        print(f"  slots equal: {same} ({kept:.3f} kept); equal to the CPU's plain version: "
              f"{float((plain == slot).float().mean()):.6f}")
        ok &= same and 0.2 < kept < 1.0
    else:
        ok &= slot.numel() == 0
    return bool(ok)


def _close(name, got, want, atol, rtol):
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    print(f"  {name}: max|err| {float(diff.max()):.3g} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def run_global(B, H, T, d, bias_dtype, strided):
    rng = np.random.default_rng(0)
    if strided:
        q, k, v = _randn(rng, B, T, 3, H, d).bfloat16().permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (_randn(rng, B, H, T, d).bfloat16() for _ in range(3))
    bias = None if bias_dtype is None else _randn(rng, H, T, T).to(bias_dtype)
    g, scale = _randn(rng, B, H, T, d).bfloat16(), d**-0.5
    print(f"K6/K7 B={B} H={H} T={T} d={d} bias={bias_dtype} strided={strided}")
    out, lse, read = ga._launch(q, k, v, bias, scale, want_lse=True)
    ok = _close("out", out, ga.global_attention_plain(q, k, v, bias, scale), 2e-2, 2e-2)
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    want_lse = torch.logsumexp(s if bias is None else s + bias.float(), -1)
    ok &= _close("lse", lse, want_lse, 1e-4, 1e-4)
    got = ga._launch_backward(*read[:3], read[3], out, lse, g, scale, bias is not None)
    want = ga.global_attention_backward_plain(q, k, v, bias, scale, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is not None:
            ok &= _close(name, a, w, 2e-2, 2e-2)
    again = ga._launch_backward(*read[:3], read[3], out, lse, g, scale, bias is not None)
    same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    print(f"  the same bits on a second call: {same}")
    return ok and same


def run_window(Bw, H, N, d, nW, strided, dtype):
    rng = np.random.default_rng(1)
    if strided:
        q, k, v = _randn(rng, Bw, N, 3, H, d).bfloat16().permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (_randn(rng, Bw, H, N, d).bfloat16() for _ in range(3))
    # L2-normalised as the block hands them over; v stays a view when strided
    q = (q.float() / q.float().norm(dim=-1, keepdim=True)).bfloat16()
    k = (k.float() / k.float().norm(dim=-1, keepdim=True)).bfloat16()
    scale = torch.exp(_randn(rng, H, 1, 1)).to(dtype)
    bias = (16 * torch.sigmoid(_randn(rng, H, N, N))).to(dtype)
    mask = None
    if nW is not None:
        mask = torch.from_numpy(np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0)
                                .astype(np.float32))
    print(f"K1 Bw={Bw} H={H} N={N} d={d} nW={nW} strided={strided} tau/bias {dtype}")
    got = wa._launch(q, k, v, scale, bias, mask)
    ok = _close("out", got, wa.window_attention_plain(q, k, v, scale, bias, mask), 5e-2, 0.0)
    same = torch.equal(got, wa._launch(q, k, v, scale, bias, mask))
    print(f"  the same bits on a second call: {same}")
    return ok and same


def run_head(B, H, W, Ci, Cm):
    rng = np.random.default_rng(2)
    x = _randn(rng, B, H, W, Ci).bfloat16()
    # w2 as a port module's OIHW weight seen as HWIO; w3 in its (1, 1, Cm, 1) form
    w2 = (_randn(rng, Cm, Ci, 3, 3) * (9 * Ci) ** -0.5).permute(2, 3, 1, 0)
    b2, w3, b3 = _randn(rng, Cm) * 0.1, (_randn(rng, Cm) * Cm ** -0.5).reshape(1, 1, Cm, 1), \
        _randn(rng, 1) * 0.1
    print(f"K5 B={B} H={H} W={W} Ci={Ci} Cm={Cm}")
    got = fh._launch(x, w2, b2, w3, b3)
    want = fh.fused_head_tail_plain(x, w2, b2, w3, b3).float()
    return _close("out", got, want, 2e-2 * float(want.abs().max()), 2e-2)


RUNS = {"global": (run_global, GLOBAL_CASES), "window": (run_window, WINDOW_CASES),
        "head": (run_head, HEAD_CASES), "segment": (run_segment, SEGMENT_CASES),
        "unproject": (run_unproject, UNPROJECT_CASES)}
SIMT = {"segment": "segment_sum", "unproject": "unproject_slots"}  # routes without wgmma


def main():
    routes = sys.argv[1:] or list(RUNS)
    libs = {}
    for route in routes:
        libs.update(build_simt(SIMT[route]) if route in SIMT else build(route))
    _build.load = libs.__getitem__
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
    ok = True
    for route in routes:
        run, cases = RUNS[route]
        ok &= all([run(*case) for case in cases])
    print("all cases agree" if ok else "some cases FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
