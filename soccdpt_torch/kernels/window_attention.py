"""K1: Swin-V2 scaled-cosine window attention.

Replaces the TPU kernels of ``soccdpt_tpu/ops/window_attention.py``
(``cosine_window_attention``, ``cosine_window_attention_batched``, as
wrapped by ``pallas_window_attention``); the function to match is that
file's ``xla_reference``. The CUDA source is ``csrc/window_attention.cu``.

Contract: ``out = softmax(tau_h * q k^T + B_h + M[i % nW]) v`` over
``(Bw, H, N, d)``, with q and k already L2-normalised, ``tau`` (H, 1, 1)
already exp'd and clamped, ``B`` (H, N, N) already ``16 * sigmoid``, and
the optional shift mask ``M`` (nW, N, N). Inputs are bf16 or f32; the
sums are f32; the output has the input's dtype.

Bound on the H100: memory. One flagship forward at batch 1 (12 calls,
d = 32, N = 256 or 64) moves about 45 MB (bf16 q/k/v/out, f32 bias and
mask) for about 1.9 GFLOP, so the bytes dominate (about 13 us at
3.35 TB/s against 2 us of bf16 tensor-core time). The kernel keeps the
(N, N) scores on chip (shared memory and registers) and reads each
bias/mask row once per query row; it stages K/V per window-head in
shared memory, which costs one extra L2 read per tile of queries
(32, 16 or 8 rows, the smaller tiles for stages with few window-heads).

``window_attention`` launches the kernel for CUDA tensors and runs
``window_attention_plain`` for CPU tensors; ``window_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SUPPORTED_D = (16, 32, 64)
MAX_SMEM_BYTES = 232448  # per block on sm_90
WARPS = 8  # must match csrc/window_attention.cu
SMS = 132  # streaming multiprocessors of an H100 SXM


def smem_bytes(N: int, d: int) -> int:
    """Shared memory one block of the kernel needs."""
    return (2 * N * (d + 1) + WARPS * N) * 4


def check_kernel_shape(N: int, d: int) -> None:
    """Raise ``ValueError`` on an (N, d) the kernel does not take."""
    if d not in SUPPORTED_D:
        raise ValueError(f"window attention kernel takes head dim {SUPPORTED_D}, got {d}")
    if smem_bytes(N, d) > MAX_SMEM_BYTES:
        raise ValueError(
            f"window attention kernel: N={N}, d={d} needs {smem_bytes(N, d)} B "
            f"of shared memory, more than {MAX_SMEM_BYTES}"
        )


def pick_q_tile(Bw: int, H: int, N: int) -> int:
    """Query rows per block: the largest of 32, 16, 8 that still gives two
    blocks per SM, so stages with few window-heads fill the card."""
    for tile in (32, 16):
        if Bw * H * -(-N // tile) >= 2 * SMS:
            return tile
    return 8


def window_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version: einsum, softmax, einsum (f32 sums)."""
    Bw, H, N, _ = q.shape
    attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    attn = attn * scale.float() + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(Bw // nW, nW, H, N, N) + mask.float()[None, :, None]
        attn = attn.reshape(Bw, H, N, N)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _launch(q, k, v, scale, bias, mask):
    Bw, H, N, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window attention kernel takes f32 or bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share shape and dtype")
    if bias.shape != (H, N, N):
        raise ValueError(f"bias must be {(H, N, N)}, got {tuple(bias.shape)}")
    if scale.numel() != H:
        raise ValueError(f"scale must hold {H} values, got {scale.numel()}")
    check_kernel_shape(N, d)
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        if mask.shape != (nW, N, N) or Bw % nW:
            raise ValueError(f"mask {tuple(mask.shape)} does not fit {Bw} windows of {N}")
        mask = mask.to(q.device, torch.float32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = scale.to(q.device, torch.float32).reshape(H).contiguous()
    bias = bias.to(q.device, torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("window_attention")
    fn = lib.soccdpt_window_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        Bw, H, N, d, nW, int(q.dtype == torch.bfloat16), pick_q_tile(Bw, H, N),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "window attention kernel")
    window_attention.launches += 1
    return out


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused window attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (Bw, H, N, d) in q's dtype."""
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, bias, mask)
    if q.device.type != "cpu":
        raise ValueError(f"window attention runs on cuda or cpu, not {q.device}")
    return window_attention_plain(q, k, v, scale, bias, mask)


window_attention.launches = 0
