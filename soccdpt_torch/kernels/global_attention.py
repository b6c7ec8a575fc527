"""K6 and K7: global multi-head attention of the ViT / BEiT backbones,
forward and backward.

K6 replaces the TPU kernels of ``soccdpt_tpu/ops/global_attention.py``
that ``_flash_forward`` launches (``_flash_kernel`` and
``_flash_kernel_bias``, wrapped by ``flash_mha``); the function to match
is that file's ``xla_reference``. K7 replaces the ones ``_flash_backward``
launches (``_flash_bwd_kernel``, ``_flash_dbias_kernel``); the function
to match is the VJP of ``xla_reference``. The CUDA sources are
``csrc/global_attention.cu`` and ``csrc/global_attention_bwd.cu``.

Contract: ``out = softmax(scale * q k^T + bias[h]) v`` over
``(B, H, T, d)``, with ``bias`` ``(H, T, T)`` or ``None``. q, k and v are
bf16 or f32; the bias is f32 or bf16 and is read in its own type; scores,
softmax and both sums are f32; the probabilities are cast to v's dtype
before ``P v``; the output has v's dtype. The backward returns dq, dk and
dv in the inputs' dtype and dbias (summed over the batch) in the bias's,
and computes dbias only when the bias needs a gradient.

Rounding, forward. The kernel walks the keys in tiles with a running row
maximum (a head's K and V do not fit one block's shared memory), so what
it rounds to v's dtype is the un-normalised weight ``exp(s - m_running)``
of each tile, where the plain version rounds ``exp(s - m_final) / sum``.
Both are values in [0, 1] that differ from the rounded one by a factor
the kernel applies afterwards in f32 (``exp(m_running - m_final)`` and
``1 / sum``), and bf16 rounding is relative (2^-9 of the value), so
either way each weight is off by at most 2^-9 of itself and the output
by at most 2^-9 of ``sum_j p_j |v_j|``: the 2e-2 bound of the bf16
comparison holds for both. In f32 nothing is rounded and the two differ
by the order of the f32 sums only (2e-5).

Rounding, backward. In bf16 the forward multiplies the probabilities
rounded to bf16 by v, and the exact VJP of that (the JAX package's
``SOCCDPT_FLASH_BWD=xla``) uses the rounded ones in ``dv``. The port
follows the JAX package's Pallas kernel instead: K7 and
``global_attention_backward_plain`` keep P in f32 in all five products
and round once, at the outputs. The two differ by 2^-9 of each weight;
the bf16 tolerance (atol = rtol = 2e-2, the forward's) covers that and
the rounding of dq, dk and dv themselves. K7 takes each row's
log-sum-exp from K6, which writes it only when a gradient will be asked
for, and ``delta = rowsum(g * out)`` from the saved output; in f32 it
differs from the plain version by the order of the sums (3e-5, the bound
tests/test_global_attention.py holds the Pallas backward to). It uses no
atomics, so it gives the same bits on every run.

Bound on the H100: with a bias, device memory. One bf16 batch-1 forward
of ``beitl16_512`` (24 calls, T = 1025, 16 heads of d = 64) moves 24 x
(8.4 MB of q/k/v/out + 67.2 MB of f32 bias); its backward 24 x (14.7 MB
of q/k/v/g/dq/dk/dv + 67.2 MB of bias + 67.2 MB of dbias). Without a
bias (plain ViT) the products bound both. The designs are described in
the CUDA sources.

``global_attention`` launches the kernels for CUDA tensors and runs the
plain versions for CPU tensors; ``global_attention.launches`` counts K6's
launches and ``global_attention_backward.launches`` K7's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

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


def global_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    g: torch.Tensor,
):
    """The plain PyTorch backward: ``(dq, dk, dv, dbias)`` for the
    cotangent ``g`` of the output, by einsums, P in f32 throughout.
    ``dbias`` is ``None`` without a bias."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()[None]
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bhnd,bhmd->bhnm", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = scale * torch.einsum("bhnm,bhmd->bhnd", ds, kf)
    dk = scale * torch.einsum("bhnm,bhnd->bhmd", ds, qf)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, gf)
    dbias = None if bias is None else ds.sum(0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _bias_kind(bias) -> int:
    if bias is None:
        return 0
    return 1 if bias.dtype == torch.float32 else 2


def _launch(q, k, v, bias, scale, want_lse=False):
    """K6 on CUDA tensors: ``(out, lse, (q, k, v, bias) as the kernel read
    them)``; ``lse`` (B, H, T) f32 only when ``want_lse``."""
    B, H, T, d = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if bias is not None:
        bias = bias.contiguous()  # in its own dtype: the kernel widens on chip
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if want_lse else None
    lib = _build.load("global_attention")
    fn = lib.soccdpt_global_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        lse.data_ptr() if want_lse else None,
        B, H, T, d, int(q.dtype == torch.bfloat16), _bias_kind(bias), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "global attention kernel")
    global_attention.launches += 1
    return out, lse, (q, k, v, bias)


def _launch_backward(q, k, v, bias, out, lse, g, scale, want_dbias):
    """K7 on CUDA tensors (q, k, v, bias, out as K6 read and wrote them)."""
    B, H, T, d = q.shape
    g = _aligned(g.to(q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)
    dbias = None
    if want_dbias:
        dbias = torch.empty((H, T, T), dtype=torch.float32, device=q.device)
    lib = _build.load("global_attention_bwd")
    fn = lib.soccdpt_global_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(),
        bias.data_ptr() if bias is not None else None, lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if want_dbias else None,
        B, H, T, d, int(q.dtype == torch.bfloat16), _bias_kind(bias), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "global attention backward kernel")
    global_attention_backward.launches += 1
    if want_dbias:
        dbias = dbias.to(bias.dtype)
    return dq, dk, dv, dbias


class _GlobalAttention(torch.autograd.Function):
    """Forward K6, backward K7 on CUDA tensors; the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        if q.device.type == "cuda":
            out, lse, (q, k, v, bias) = _launch(q, k, v, bias, scale, want_lse=True)
        else:
            out, lse = global_attention_plain(q, k, v, bias, scale), None
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        if q.device.type == "cuda":
            dq, dk, dv, dbias = _launch_backward(
                q, k, v, bias, out, lse, g, ctx.scale, want_dbias
            )
        else:
            dq, dk, dv, dbias = global_attention_backward_plain(q, k, v, bias, ctx.scale, g)
        return dq, dk, dv, dbias if want_dbias else None, None


def global_attention_with_lse(q, k, v, bias=None, scale=1.0):
    """``(out, lse)``: the attention output and each row's log-sum-exp of
    its scores, (B, H, T) f32, which the backward starts from. One K6
    launch on CUDA tensors."""
    check_args(q, k, v, bias)
    if q.device.type == "cuda":
        out, lse, _ = _launch(q, k, v, bias, scale, want_lse=True)
        return out, lse
    if q.device.type != "cpu":
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None]
    return global_attention_plain(q, k, v, bias, scale), torch.logsumexp(s, dim=-1)


def global_attention_backward(
    q, k, v, bias, scale, g, out=None, lse=None, want_dbias=True
):
    """``(dq, dk, dv, dbias)`` of ``global_attention`` for the cotangent
    ``g``: K7 on CUDA tensors, the plain backward on CPU tensors. It is
    what ``loss.backward()`` runs through the ``autograd.Function``,
    callable by itself. ``out`` and ``lse`` are the forward's
    (``global_attention_with_lse``); without them the forward runs first."""
    check_args(q, k, v, bias)
    want_dbias = want_dbias and bias is not None
    if q.device.type == "cuda":
        if out is None or lse is None:
            out, lse, (q, k, v, bias) = _launch(q, k, v, bias, scale, want_lse=True)
        else:
            q, k, v, out = _aligned(q), _aligned(k), _aligned(v), _aligned(out)
            bias = None if bias is None else bias.contiguous()
        return _launch_backward(q, k, v, bias, out, lse.contiguous(), g, scale, want_dbias)
    if q.device.type != "cpu":
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    dq, dk, dv, dbias = global_attention_backward_plain(q, k, v, bias, scale, g)
    return dq, dk, dv, dbias if want_dbias else None


def global_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Fused global attention: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors. Returns (B, H, T, d) in v's dtype. When an
    input needs a gradient the call is recorded for autograd (K7 on the
    card); otherwise it is the bare forward."""
    check_args(q, k, v, bias)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    ):
        return _GlobalAttention.apply(q, k, v, bias, scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, scale)[0]
    return global_attention_plain(q, k, v, bias, scale)


global_attention.launches = 0
global_attention_backward.launches = 0
