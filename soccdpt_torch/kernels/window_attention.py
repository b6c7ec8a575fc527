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

Two routes, by dtype. bf16 runs on the tensor cores: ``wgmma`` fed by TMA
(``csrc/attention_wgmma.cuh``, K6's machinery), q, k and v read in place
through 4-D tensor maps of the caller's strides (the strided views the
Swin block hands over), tau, B and M read in their own dtype (f32 or
bf16) where they lie on the card: one CUDA launch a call, planned by
``plan_window_attention``. f32 runs the CUDA-core kernel, whose f32
products the f32 bound (2e-5) needs. A shape the bf16 route cannot take
raises; nothing falls back.

Rounding (bf16). The kernel walks the keys in tiles of 64 with a running
row maximum and rounds the un-normalised weight ``exp(s - m_running)``
of each tile to bf16 before P v, where the plain version rounds the
normalised ``softmax`` (``attn.to(v.dtype)``); both are off by at most
2^-9 of the weight (kernels/global_attention.py, "Rounding, forward"), well
inside the bf16 bound of 5e-2.

Bound on the H100: memory. One flagship forward at batch 1 (12 calls,
d = 32, N = 256 or 64) moves about 45 MB (bf16 q/k/v/out, f32 bias and
mask) for about 1.9 GFLOP, so the bytes dominate (about 13 us at
3.35 TB/s against 2 us of bf16 tensor-core time); a single launch moves
0.2-2.4 us of bytes, so its floor is the launch itself.

The forward is the custom op ``soccdpt::window_attention``
(``torch.library``): its CUDA implementation launches the kernel, its CPU
implementation is ``window_attention_plain``, and a fake implementation
gives the output's shape and dtype, so ``torch.export`` records the call
as one node and an exported program launches the kernel when it runs on
the card. A device with no implementation raises. ``window_attention``
calls the op; ``window_attention.launches`` counts kernel launches
(forward only: the backward launches none).

Gradient. The JAX package's backward of this kernel is no Pallas kernel:
``_pwa_bwd`` re-derives the attention matrix through ``xla_reference``
with plain XLA ops and lets autodiff give dq, dk, dv, dtau and dB (the
mask gets none). The port mirrors that design: when an input needs a
gradient the call is a ``torch.autograd.Function`` whose forward is the
CUDA kernel and whose backward recomputes through
``window_attention_plain`` under ``torch.enable_grad()`` and returns its
autograd gradients.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .global_attention import _as_tma, tma_geometry

SUPPORTED_D = (16, 32, 64)
MAX_SMEM_BYTES = 232448  # per block on sm_90
SM_SMEM_BYTES = 233472  # per SM (228 KB), shared by the CTAs resident on it
WARPS = 8  # the f32 route's warps a block: must match csrc/window_attention.cu
SMS = 132  # streaming multiprocessors of an H100 SXM

# The bf16 route (csrc/window_attention.cu, namespace wgattn), restated for
# the planner: query rows a CTA (one warpgroup), keys a tile, the ring's
# depth at most, CTAs an SM at most (``__launch_bounds__``: two, one for a
# call with a shift mask, whose loads need the registers of two)
WIN_BM, WIN_KT, WIN_MAX_STAGES = 64, 64, 4
WIN_CTAS_PER_SM = {False: 2, True: 1}  # by whether the call has a mask


def smem_bytes(N: int, d: int) -> int:
    """Shared memory one block of the f32 route needs."""
    return (2 * N * (d + 1) + WARPS * N) * 4


def check_kernel_shape(N: int, d: int) -> None:
    """Raise ``ValueError`` on an (N, d) the f32 route does not take."""
    if d not in SUPPORTED_D:
        raise ValueError(f"window attention kernel takes head dim {SUPPORTED_D}, got {d}")
    if smem_bytes(N, d) > MAX_SMEM_BYTES:
        raise ValueError(
            f"window attention kernel: N={N}, d={d} needs {smem_bytes(N, d)} B "
            f"of shared memory, more than {MAX_SMEM_BYTES}"
        )


def win_smem_bytes(d: int, stages: int) -> int:
    """The bf16 route's CTA: 1 KB of alignment slack, Q (64 rows), the ring
    of K and V tiles (64 keys, d padded to 64 columns), the barriers."""
    return 1024 + (WIN_BM + stages * 2 * WIN_KT) * max(d, 64) * 2 + (1 + 2 * stages) * 8


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """The launch of one bf16 call: the grid (windows, tiles of 64 query
    rows, heads), the ring's depth, a CTA's shared memory and the CTAs an
    SM holds."""

    grid: Tuple[int, int, int]
    stages: int
    smem: int
    ctas_per_sm: int


def plan_window_attention(Bw: int, H: int, N: int, d: int, masked: bool = False) -> WindowPlan:
    """The bf16 route's launch for (Bw, H, N, d), with a shift mask or
    without. The ring holds as many 64-key tiles of K and V as the window
    has, up to ``WIN_MAX_STAGES``: at N <= 256 the window-head's whole K and
    V, every load issued at once; at N = 576 a ring of four that the
    producer refills. Raises on what the kernel cannot take."""
    if d not in SUPPORTED_D:
        raise ValueError(f"window attention kernel takes head dim {SUPPORTED_D}, got {d}")
    if min(Bw, H, N) < 1:
        raise ValueError(f"window attention needs Bw, H, N >= 1, got {(Bw, H, N)}")
    tiles = -(-N // WIN_KT)
    if H > 65535 or tiles > 65535 or Bw > 2**31 - 1:
        raise ValueError(f"grid too large: Bw = {Bw}, H = {H}, {tiles} tiles of 64 rows")
    stages = min(tiles, WIN_MAX_STAGES)
    smem = win_smem_bytes(d, stages)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the bf16 route's tiles do not fit a block at d = {d}")
    return WindowPlan(grid=(Bw, tiles, H), stages=stages, smem=smem,
                      ctas_per_sm=min(WIN_CTAS_PER_SM[masked], SM_SMEM_BYTES // smem))


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


def _check(q, k, v, scale, bias, mask):
    if q.dim() != 4:
        raise ValueError(f"q must be (Bw, H, N, d), got {tuple(q.shape)}")
    Bw, H, N, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window attention kernel takes f32 or bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share shape and dtype")
    if d not in SUPPORTED_D:
        raise ValueError(f"window attention kernel takes head dim {SUPPORTED_D}, got {d}")
    if bias.shape != (H, N, N):
        raise ValueError(f"bias must be {(H, N, N)}, got {tuple(bias.shape)}")
    if scale.numel() != H:
        raise ValueError(f"scale must hold {H} values, got {scale.numel()}")
    if mask is not None:
        nW = mask.shape[0]
        if mask.shape != (nW, N, N) or Bw % nW:
            raise ValueError(f"mask {tuple(mask.shape)} does not fit {Bw} windows of {N}")


def _on_card(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as the bf16 route reads it: itself where it lies on the card,
    contiguous, in f32 or bf16; else an f32 contiguous copy there."""
    if t.device == like.device and t.dtype in (torch.float32, torch.bfloat16) and t.is_contiguous():
        return t
    return t.to(like.device, torch.float32).contiguous()


def _kind(t: Optional[torch.Tensor]) -> int:
    """A tensor's dtype as the bf16 entry takes it: 0 none, 1 f32, 2 bf16."""
    if t is None:
        return 0
    return 1 if t.dtype == torch.float32 else 2


def _launch_bf16(q, k, v, scale, bias, mask):
    """One launch of the tensor-core route: q, k, v read in place (a view
    TMA cannot read is copied once), tau, B and M passed as they lie."""
    Bw, H, N, d = q.shape
    plan = plan_window_attention(Bw, H, N, d, masked=mask is not None)
    q, k, v = _as_tma(q), _as_tma(k), _as_tma(v)
    tau = _on_card(scale.reshape(H), q)
    bias = _on_card(bias, q)
    mask = None if mask is None else _on_card(mask, q)
    out = torch.empty((Bw, H, N, d), dtype=q.dtype, device=q.device)
    flat = [x for t in (q, k, v) for x in tma_geometry(t)]
    lib = _build.load("window_attention")
    fn = lib.soccdpt_window_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), (ctypes.c_longlong * len(flat))(*flat),
            tau.data_ptr(), _kind(tau), bias.data_ptr(), _kind(bias),
            None if mask is None else mask.data_ptr(), _kind(mask), out.data_ptr(),
            Bw, H, N, d, 1 if mask is None else mask.shape[0], plan.stages,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "window attention kernel")
    return out


def _launch_f32(q, k, v, scale, bias, mask):
    """The CUDA-core route: contiguous f32 operands."""
    Bw, H, N, d = q.shape
    check_kernel_shape(N, d)
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        mask = mask.to(q.device, torch.float32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = scale.to(q.device, torch.float32).reshape(H).contiguous()
    bias = bias.to(q.device, torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("window_attention")
    fn = lib.soccdpt_window_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        Bw, H, N, d, nW, pick_q_tile(Bw, H, N),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "window attention kernel")
    return out


def _launch(q, k, v, scale, bias, mask):
    _check(q, k, v, scale, bias, mask)
    launch = _launch_bf16 if q.dtype == torch.bfloat16 else _launch_f32
    out = launch(q, k, v, scale, bias, mask)
    window_attention.launches += 1
    return out


# The custom op, registered through ``torch.library.Library``: cheaper to
# call than through ``torch.library.custom_op``, whose Python wrappers run
# on every call (PERF.md §6)
_LIB = torch.library.Library("soccdpt", "FRAGMENT")
_LIB.define(
    "window_attention(Tensor q, Tensor k, Tensor v, Tensor scale, Tensor bias, Tensor? mask)"
    " -> Tensor"
)
_LIB.impl("window_attention", _launch, "CUDA")
_LIB.impl("window_attention", window_attention_plain, "CPU")


@torch.library.register_fake("soccdpt::window_attention", lib=_LIB)
def _window_attention_fake(q, k, v, scale, bias, mask):
    return q.new_empty(q.shape)


_window_attention_op = torch.ops.soccdpt.window_attention.default


def _forward(q, k, v, scale, bias, mask):
    return _window_attention_op(q, k, v, scale, bias, mask)


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel (the plain version on CPU tensors). Backward: a
    recompute through the plain version, as the JAX package's."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bias, mask):
        ctx.save_for_backward(q, k, v, scale, bias, mask)
        return _forward(q, k, v, scale, bias, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *inputs, mask = ctx.saved_tensors
        needed = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in needed) for i, t in enumerate(inputs)]
            out = window_attention_plain(*leaves, mask)
            grads = torch.autograd.grad(out, [leaves[i] for i in needed], g.to(out.dtype))
        result = [None] * 6
        for i, grad in zip(needed, grads):
            result[i] = grad
        return tuple(result)


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused window attention: the CUDA kernels for CUDA tensors (bf16 on the
    tensor cores, f32 on CUDA cores), the plain version for CPU tensors. Returns (Bw, H, N, d) in q's dtype. When an
    input needs a gradient the call is recorded for autograd (see the
    module docstring); otherwise it is the bare forward."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"window attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, scale, bias)):
        return _WindowAttention.apply(q, k, v, scale, bias, mask)
    return _forward(q, k, v, scale, bias, mask)


window_attention.launches = 0
