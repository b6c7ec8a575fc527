"""K6: global multi-head attention of the ViT / BEiT backbones.

Replaces the TPU kernels of ``soccdpt_tpu/ops/global_attention.py``
(``_flash_kernel`` and ``_flash_kernel_bias``, launched by
``_flash_forward`` and wrapped by ``flash_mha``); the function to match
is that file's ``xla_reference``. The CUDA source is
``csrc/global_attention.cu``.

Contract: ``out = softmax(scale * q k^T + bias[h]) v`` over
``(B, H, T, d)``, with ``bias`` ``(H, T, T)`` or ``None``. q, k and v are
bf16 or f32; the bias is f32 or bf16 and is read in its own type; scores,
softmax and both sums are f32; the probabilities are cast to v's dtype
before ``P v``; the output has v's dtype.

Rounding. The kernel walks the keys in tiles with a running row maximum
(a head's K and V do not fit one block's shared memory), so what it
rounds to v's dtype is the un-normalised weight ``exp(s - m_running)``
of each tile, where the plain version rounds ``exp(s - m_final) / sum``.
Both are values in [0, 1] that differ from the rounded one by a factor
the kernel applies afterwards in f32 (``exp(m_running - m_final)`` and
``1 / sum``), and bf16 rounding is relative (2^-9 of the value), so
either way each weight is off by at most 2^-9 of itself and the output
by at most 2^-9 of ``sum_j p_j |v_j|``: the 2e-2 bound of the bf16
comparison holds for both. In f32 nothing is rounded and the two differ
by the order of the f32 sums only (2e-5).

Bound on the H100: with a bias, device memory. One bf16 batch-1 forward
of ``beitl16_512`` (24 calls, T = 1025, 16 heads of d = 64) moves 24 x
(8.4 MB of q/k/v/out + 67.2 MB of f32 bias); without a bias (plain ViT)
the two products bound it. The design is described in the CUDA source.

``global_attention`` launches the kernel for CUDA tensors and runs
``global_attention_plain`` for CPU tensors; ``global_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SUPPORTED_D = (16, 32, 64, 128)


def global_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """The plain PyTorch version: einsum, softmax, einsum (f32 sums)."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def check_args(q, k, v, bias) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, d), got {tuple(q.shape)}")
    B, H, T, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"global attention kernel takes f32 or bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share shape and dtype")
    if d not in SUPPORTED_D:
        raise ValueError(f"global attention kernel takes head dim {SUPPORTED_D}, got {d}")
    if T < 1:
        raise ValueError("global attention needs at least one token")
    if bias is not None:
        if tuple(bias.shape) != (H, T, T):
            raise ValueError(f"bias must be {(H, T, T)}, got {tuple(bias.shape)}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bias must be f32 or bf16, got {bias.dtype}")
        if bias.device != q.device:
            raise ValueError(f"bias lies on {bias.device}, q on {q.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary: the kernel reads q, k and v
    rows by 16-byte loads. A view into the middle of a buffer is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, bias, scale):
    B, H, T, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias_kind = 0
    if bias is not None:
        bias = bias.contiguous()  # in its own dtype: the kernel widens on chip
        bias_kind = 1 if bias.dtype == torch.float32 else 2
    out = torch.empty_like(q)
    lib = _build.load("global_attention")
    fn = lib.soccdpt_global_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, H, T, d, int(q.dtype == torch.bfloat16), bias_kind, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "global attention kernel")
    global_attention.launches += 1
    return out


def global_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Fused global attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (B, H, T, d) in v's dtype."""
    check_args(q, k, v, bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    return global_attention_plain(q, k, v, bias, scale)


global_attention.launches = 0
