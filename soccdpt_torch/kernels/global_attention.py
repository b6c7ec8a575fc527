"""K6 and K7: global multi-head attention of the ViT / BEiT backbones,
forward and backward.

K6 replaces the TPU kernels of ``soccdpt_tpu/ops/global_attention.py``
that ``_flash_forward`` launches (``_flash_kernel`` and
``_flash_kernel_bias``, wrapped by ``flash_mha``); the function to match
is that file's ``xla_reference``. K7 replaces the ones ``_flash_backward``
launches (``_flash_bwd_kernel``, ``_flash_dbias_kernel``); the function
to match is the VJP of ``xla_reference``. The CUDA sources are
``csrc/global_attention.cu`` and ``csrc/global_attention_bwd.cu``.

Two routes, by dtype. bf16 runs on the tensor cores: ``wgmma`` fed by TMA
(``csrc/attention_wgmma.cuh``), q, k, v and g read through 4-D tensor maps
of the caller's strides (``tma_geometry``; the q, k, v views of one qkv
tensor are read in place), the launches planned by ``plan_attention``. f32
runs the CUDA-core kernels, whose f32 products the f32 bounds need. A
shape the bf16 route cannot take raises; nothing falls back.

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
``SOCCDPT_FLASH_BWD=xla``) uses the rounded ones in ``dv``. K7's bf16 route
runs its five products on the tensor cores, whose operands are bf16, so it
rounds P (in ``dv = P^T g``) and dS (in ``dq = dS k`` and ``dk = dS^T q``)
to bf16 as operands, as FlashAttention does; the sums stay f32 and dbias
is written from the f32 dS, unrounded. ``global_attention_backward_plain``
keeps P and dS in f32 in all five products, as the Pallas kernel does, and
the f32 route (CUDA cores) matches it to the order of the sums (3e-5, the
bound tests/test_global_attention.py holds the Pallas backward to). A bf16
operand is off by 2^-9 of itself, so each bf16 output is off by at most
2^-9 of the sum of its terms' sizes, besides its own rounding: the bf16
tolerance (atol = rtol = 2e-2, the forward's) covers both. K7 takes each
row's log-sum-exp from K6, which writes it only when a gradient will be
asked for, and ``delta = rowsum(g * out)`` from the saved output. It uses
no atomics, so it gives the same bits on every run.

Bound on the H100: with a bias, device memory. One bf16 batch-1 forward
of ``beitl16_512`` (24 calls, T = 1025, 16 heads of d = 64) moves 24 x
(8.4 MB of q/k/v/out + 67.2 MB of f32 bias); its backward 24 x (14.7 MB
of q/k/v/g/dq/dk/dv + 67.2 MB of bias + 67.2 MB of dbias). The bias
cannot go through TMA (a row of T elements is no multiple of 16 bytes),
so each thread loads the elements its sums hold, a tile ahead. Without a
bias (plain ViT) the products bound both. The designs are described in
the CUDA sources.

K6's forward is two ops (``_build.op``): ``soccdpt::global_attention``
gives the output and ``soccdpt::global_attention_with_lse`` the output and
each row's log-sum-exp; K7 is ``soccdpt::global_attention_backward``. Their
CUDA implementations launch the kernels and their CPU implementations are
the plain versions, so an exported program launches K6 when it runs on the
card. ``global_attention`` calls the ops; ``kernels.ops.launches()`` counts
each op's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._build import F32, I64, INT, PTR

SUPPORTED_D = (16, 32, 64, 128)

# The bf16 route (csrc/attention_wgmma.cuh and the two .cu files), restated
# for the planner: keys a forward tile and its ring's stages, keys a tile
# of the dq kernel, queries a tile and warpgroups (of 64 keys) of the dk/dv
# kernel, the backward rings' stages, the room of a query tile's
# statistics and a block's shared memory. K6's CTA is one warpgroup of 64
# query rows, two to an SM.
FWD_KT, FWD_STAGES, DQ_KT, DKV_QT, DKV_NWG, BWD_STAGES, STATS_BYTES = 64, 3, 32, 32, 2, 2, 1024
MAX_SMEM_BYTES = 232448


def padded(D: int) -> int:
    """The head width the tiles hold: 64 columns (zeros past D), or 128."""
    return 64 if D < 64 else D


def fwd_smem_bytes(D: int) -> int:
    """K6's bf16 CTA: 1 KB of alignment slack, Q (64 rows), the ring of K
    and V tiles, the barriers."""
    return 1024 + (64 + FWD_STAGES * 2 * FWD_KT) * padded(D) * 2 + (1 + 2 * FWD_STAGES) * 8


def dq_smem_bytes(D: int, img: int) -> int:
    """K7's dq CTA: Q and g of ``img`` images (64 rows), their ring of K and
    V tiles (DQ_KT keys), two dbias tiles (64 rows of DQ_KT + 1 floats),
    the barriers."""
    return (1024 + (img * 2 * 64 + BWD_STAGES * img * 2 * DQ_KT) * padded(D) * 2
            + 2 * 64 * (DQ_KT + 1) * 4 + (2 + 2 * BWD_STAGES) * 8)


def dkv_smem_bytes(D: int) -> int:
    """K7's dk/dv CTA: its K and V (64 rows a warpgroup), the ring of q and
    g tiles (DKV_QT rows) with their statistics, the barriers."""
    return (1024 + 2 * DKV_NWG * 64 * padded(D) * 2
            + BWD_STAGES * (2 * DKV_QT * padded(D) * 2 + STATS_BYTES) + (1 + 2 * BWD_STAGES) * 8)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """The launches of one bf16 call: the images the dq kernel holds at
    once (``img``), and each kernel's grid and shared memory."""

    img: int
    fwd_grid: Tuple[int, int, int]
    dq_grid: Tuple[int, int]
    dkv_grid: Tuple[int, int, int]
    fwd_smem: int
    dq_smem: int
    dkv_smem: int


def plan_attention(B: int, H: int, T: int, D: int, img: Optional[int] = None) -> AttentionPlan:
    """The bf16 route's launches for (B, H, T, D). The dq kernel holds two
    images' dq at once (``img`` = 2) where B >= 2 and D <= 64, so that each
    bias tile is read and each dbias tile written once a pair of images;
    ``img`` may be asked for, as chip_smoke.py does to time the other."""
    if img is None:
        img = 2 if B >= 2 and D <= 64 else 1
    if img not in (1, 2) or (img == 2 and D > 64):
        raise ValueError(f"img must be 1, or 2 at D <= 64; got {img} at D = {D}")
    tiles = -(-T // 64)
    plan = AttentionPlan(
        img=img, fwd_grid=(B, tiles, H), dq_grid=(tiles, H),
        dkv_grid=(B, -(-T // (64 * DKV_NWG)), H),
        fwd_smem=fwd_smem_bytes(D), dq_smem=dq_smem_bytes(D, img), dkv_smem=dkv_smem_bytes(D),
    )
    if max(plan.fwd_smem, plan.dq_smem, plan.dkv_smem) > MAX_SMEM_BYTES:
        raise ValueError(f"the bf16 route's tiles do not fit a block at D = {D}")
    if H > 65535 or tiles > 65535:
        raise ValueError(f"grid too large: H = {H}, {tiles} tiles of 64 rows")
    return plan


def tma_geometry(t: torch.Tensor) -> List[int]:
    """The 4-D tensor map of a (B, H, T, D) bf16 view as the kernels take
    it: dims (D, T, H, B) innermost first, then the byte strides of T, H
    and B. Rows past T lie outside the map, so TMA fills them with zeros
    and never reads the next head's rows."""
    B, H, T, D = t.shape
    e = t.element_size()
    return [D, T, H, B, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e]


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read the view in place: D contiguous, the base and
    every other stride a multiple of 16 bytes (below 2^40)."""
    e = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * e % 16 == 0 and s * e < 2**40 for s in t.stride()[:3]))


def _as_tma(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it (the strided q, k, v views of one
    qkv tensor can), else an aligned contiguous copy."""
    if tma_ready(t):
        return t
    t = t.contiguous()
    return t if tma_ready(t) else t.clone()


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


def _geometry(*tensors: torch.Tensor):
    """The tensor maps' geometry of the tensors in turn, as a C array."""
    flat = [x for t in tensors for x in tma_geometry(t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _as_read(q, k, v, bias):
    """q, k, v and the bias as K6 reads them: bf16 q, k, v where TMA can
    read them (``_as_tma``), f32 ones contiguous and aligned, the bias
    contiguous in its own dtype (the kernel widens it on chip)."""
    as_read = _as_tma if q.dtype == torch.bfloat16 else _aligned
    return as_read(q), as_read(k), as_read(v), None if bias is None else bias.contiguous()


_GEOM = ctypes.POINTER(I64)
_FWD_F32 = _build.Entry("global_attention", "soccdpt_global_attention_f32",
                        [PTR] * 6 + [INT] * 5 + [F32], "global attention kernel")
_FWD_BF16 = _build.Entry("global_attention", "soccdpt_global_attention_bf16",
                         [PTR] * 3 + [_GEOM] + [PTR] * 3 + [INT] * 5 + [F32],
                         "global attention kernel")
_BWD_F32 = _build.Entry("global_attention_bwd", "soccdpt_global_attention_bwd_f32",
                        [PTR] * 12 + [INT] * 5 + [F32], "global attention backward kernel")
_BWD_BF16 = _build.Entry("global_attention_bwd", "soccdpt_global_attention_bwd_bf16",
                         [PTR] * 4 + [_GEOM] + [PTR] * 8 + [INT] * 5 + [F32, INT],
                         "global attention backward kernel")


def _launch(q, k, v, bias, scale, want_lse=False):
    """K6 on CUDA tensors: ``(out, lse, (q, k, v, bias) as the kernel read
    them)``; ``lse`` (B, H, T) f32 only when ``want_lse``. bf16 runs the
    tensor-core route, f32 the CUDA cores."""
    B, H, T, d = q.shape
    q, k, v, bias = _as_read(q, k, v, bias)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if want_lse else None
    out = torch.empty((B, H, T, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        plan_attention(B, H, T, d)  # raises on what the route cannot take
        _FWD_BF16(q.device, q, k, v, _geometry(q, k, v), bias, out, lse, B, H, T, d,
                  _bias_kind(bias), float(scale))
    else:
        _FWD_F32(q.device, q, k, v, bias, out, lse, B, H, T, d, _bias_kind(bias), float(scale))
    return out, lse, (q, k, v, bias)


def _launch_backward(q, k, v, bias, out, lse, g, scale, want_dbias, img=None):
    """K7 on CUDA tensors (q, k, v, bias, out as K6 read and wrote them):
    ``(dq, dk, dv, dbias or None)``; ``img`` overrides the planner's images
    a dq CTA holds (bf16)."""
    B, H, T, d = q.shape
    g = _aligned(g.to(q.dtype))
    dq, dk, dv = (torch.empty((B, H, T, d), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty_like(lse)
    dbias = None
    if want_dbias:
        dbias = torch.empty((H, T, T), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        plan = plan_attention(B, H, T, d, img=img)
        _BWD_BF16(q.device, q, k, v, g, _geometry(q, k, v, g), out, bias, lse, delta, dq, dk,
                  dv, dbias, B, H, T, d, _bias_kind(bias), float(scale), plan.img)
    else:
        _BWD_F32(q.device, q, k, v, g, out, bias, lse, delta, dq, dk, dv, dbias, B, H, T, d,
                 _bias_kind(bias), float(scale))
    if want_dbias:
        dbias = dbias.to(bias.dtype)
    return dq, dk, dv, dbias


def _lse_plain(q, k, bias, scale):
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[None]
    return torch.logsumexp(s, dim=-1)


def _global_attention_with_lse_cpu(q, k, v, bias, scale):
    return global_attention_plain(q, k, v, bias, scale), _lse_plain(q, k, bias, scale)


def _forward_fake(q, k, v, bias, scale):
    return v.new_empty(q.shape)


_global_attention_op = _build.op(
    "global_attention(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale) -> Tensor",
    lambda q, k, v, bias, scale: _launch(q, k, v, bias, scale)[0], global_attention_plain,
    _forward_fake)
_global_attention_with_lse_op = _build.op(
    "global_attention_with_lse(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale)"
    " -> (Tensor, Tensor)",
    lambda q, k, v, bias, scale: _launch(q, k, v, bias, scale, want_lse=True)[:2],
    _global_attention_with_lse_cpu,
    lambda q, k, v, bias, scale: (_forward_fake(q, k, v, bias, scale),
                                  q.new_empty(q.shape[:3], dtype=torch.float32)))


def _backward_cuda(q, k, v, bias, out, lse, g, scale, want_dbias):
    """K7, after K6 where the forward's ``out`` and ``lse`` are not given.
    The op returns an empty dbias where none is asked for (or there is no
    bias): its schema has no optional output."""
    q, k, v, bias = _as_read(q, k, v, bias)
    if out is None or lse is None:
        out, lse = _global_attention_with_lse_op(q, k, v, bias, scale)
    dq, dk, dv, dbias = _launch_backward(q, k, v, bias, _aligned(out), lse.contiguous(), g,
                                         scale, want_dbias and bias is not None)
    return dq, dk, dv, q.new_empty((0,)) if dbias is None else dbias


def _backward_cpu(q, k, v, bias, out, lse, g, scale, want_dbias):
    dq, dk, dv, dbias = global_attention_backward_plain(q, k, v, bias, scale, g)
    return dq, dk, dv, dbias if want_dbias and bias is not None else q.new_empty((0,))


def _backward_fake(q, k, v, bias, out, lse, g, scale, want_dbias):
    dbias = bias.new_empty(bias.shape) if want_dbias and bias is not None else q.new_empty((0,))
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape), dbias


_global_attention_backward_op = _build.op(
    "global_attention_backward(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? out, "
    "Tensor? lse, Tensor g, float scale, bool want_dbias) -> (Tensor, Tensor, Tensor, Tensor)",
    _backward_cuda, _backward_cpu, _backward_fake)


class _GlobalAttention(torch.autograd.Function):
    """Forward K6, backward K7 (the ops: the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        if q.device.type == "cuda":
            # saved as the kernel read them, so the backward reads the same
            q, k, v, bias = _as_read(q, k, v, bias)
            out, lse = _global_attention_with_lse_op(q, k, v, bias, scale)
        else:  # the plain backward needs no log-sum-exp
            out, lse = _global_attention_op(q, k, v, bias, scale), None
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _global_attention_backward_op(q, k, v, bias, out, lse, g, ctx.scale,
                                                          want_dbias)
        return dq, dk, dv, dbias if want_dbias else None, None


def global_attention_with_lse(q, k, v, bias=None, scale=1.0):
    """``(out, lse)``: the attention output and each row's log-sum-exp of
    its scores, (B, H, T) f32, which the backward starts from. One K6
    launch on CUDA tensors."""
    check_args(q, k, v, bias)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    return _global_attention_with_lse_op(q, k, v, bias, scale)


def global_attention_backward(
    q, k, v, bias, scale, g, out=None, lse=None, want_dbias=True
):
    """``(dq, dk, dv, dbias)`` of ``global_attention`` for the cotangent
    ``g``: K7 on CUDA tensors, the plain backward on CPU tensors. It is
    what ``loss.backward()`` runs through the ``autograd.Function``,
    callable by itself. ``out`` and ``lse`` are the forward's
    (``global_attention_with_lse``); without them the forward runs first."""
    check_args(q, k, v, bias)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"global attention runs on cuda or cpu, not {q.device}")
    want_dbias = want_dbias and bias is not None
    dq, dk, dv, dbias = _global_attention_backward_op(q, k, v, bias, out, lse, g, scale,
                                                      want_dbias)
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
    return _global_attention_op(q, k, v, bias, scale)
