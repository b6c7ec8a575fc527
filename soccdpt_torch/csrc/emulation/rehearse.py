"""Rehearse the bf16 route of global attention (K6, K7) without a card.

    python soccdpt_torch/csrc/emulation/rehearse.py

Compiles the route's kernels (``namespace wgattn`` of
``csrc/global_attention.cu`` and ``csrc/global_attention_bwd.cu``, with
``csrc/attention_wgmma.cuh``) with g++ against the emulated
``wgmma_common.cuh`` beside this file, into
``build/wgmma_emulation/``, then drives the real wrappers
(``kernels/global_attention.py``: ``_launch`` and ``_launch_backward``)
on CPU tensors through the emulated libraries and holds out, lse, dq, dk,
dv and dbias to the plain versions at the bf16 bound (2e-2, atol = rtol;
lse to 1e-4), and a second backward to the same bits. A few small shapes
take minutes: every CUDA thread is an OS thread. A pass here says the
ring, the barriers, the descriptors and the fragment layouts agree with
the emulation's reading of the hardware, not that nvcc accepts the code.
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

from soccdpt_torch.kernels import _build  # noqa: E402
from soccdpt_torch.kernels import global_attention as ga  # noqa: E402

# (B, H, T, d, bias dtype, strided): ragged tiles, d = 16 and 128, a bf16
# bias, three images (two groups in the dq kernel), the strided q, k, v of
# one qkv tensor, a single token
CASES = [
    (2, 2, 65, 16, torch.float32, False),
    (1, 2, 129, 64, torch.bfloat16, False),
    (3, 2, 70, 128, torch.bfloat16, False),
    (3, 2, 130, 64, torch.float32, False),
    (2, 1, 130, 32, None, True),
    (1, 1, 1, 16, None, False),
]


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


def _slice(name):
    """The route's namespace and its bf16 C entry, with the shared arrays
    and the <<<...>>> launches rewritten for the emulation."""
    s = (CSRC / name).read_text()
    kern = s[s.index("namespace wgattn {"):s.index("}  // namespace wgattn") + 22]
    kern = re.sub(r"extern __shared__ unsigned char (\w+)\[\];", r"unsigned char* \1 = emu_smem();",
                  kern)

    def launch(m):
        grid, threads, smem, _ = _split_args(m.group(2))
        return f"emu_launch({m.group(1)}, dim3({grid}), {threads}, {smem}, {m.group(3)});"

    kern = re.sub(r"([\w:]+<[^<>;]*>)\s*<<<(.*?)>>>\((.*?)\);", launch, kern, flags=re.S)
    entry = re.search(r"(int soccdpt_global_attention(_bwd)?_bf16\(.*?\n}\n)", s, flags=re.S).group(1)
    return (kern + '\nextern "C" {\nconst char* soccdpt_error_string(int code) '
            "{ return hopper::error_string(code); }\n" + entry + "}\n")


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "wgmma_common.cuh").write_text((HERE / "wgmma_common.cuh").read_text())
    (OUT / "attention_wgmma.cuh").write_text((CSRC / "attention_wgmma.cuh").read_text())
    libs = {}
    for name in ("global_attention", "global_attention_bwd"):
        tu = OUT / f"{name}.cpp"
        tu.write_text('#include "wgmma_common.cuh"\n#include "attention_wgmma.cuh"\n'
                      + _slice(f"{name}.cu"))
        lib = OUT / f"lib{name}_emulated.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-Wno-unknown-pragmas", "-I", str(OUT), "-o", str(lib), str(tu)],
                       check=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].soccdpt_error_string.restype = ctypes.c_char_p
    return libs


def _close(name, got, want, tol):
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= tol + tol * want.float().abs()).all())
    print(f"  {name}: max|err| {float(diff.max()):.3g} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def run(B, H, T, d, bias_dtype, strided):
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if strided:
        q, k, v = randn(B, T, 3, H, d).bfloat16().permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (randn(B, H, T, d).bfloat16() for _ in range(3))
    bias = None if bias_dtype is None else randn(H, T, T).to(bias_dtype)
    g, scale = randn(B, H, T, d).bfloat16(), d**-0.5
    print(f"B={B} H={H} T={T} d={d} bias={bias_dtype} strided={strided}")
    out, lse, read = ga._launch(q, k, v, bias, scale, want_lse=True)
    ok = _close("out", out, ga.global_attention_plain(q, k, v, bias, scale), 2e-2)
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    ok &= _close("lse", lse, torch.logsumexp(s if bias is None else s + bias.float(), -1), 1e-4)
    got = ga._launch_backward(*read[:3], read[3], out, lse, g, scale, bias is not None)
    want = ga.global_attention_backward_plain(q, k, v, bias, scale, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is not None:
            ok &= _close(name, a, w, 2e-2)
    again = ga._launch_backward(*read[:3], read[3], out, lse, g, scale, bias is not None)
    same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    print(f"  the same bits on a second call: {same}")
    return ok and same


def main():
    libs = build()
    _build.load = libs.__getitem__
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
    ok = all([run(*case) for case in CASES])
    print("all cases agree" if ok else "some cases FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
