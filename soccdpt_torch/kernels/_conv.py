"""What the three decoder-convolution wrappers (K3 ``fused_rcu``, K4
``fused_fusion``, K5 ``fused_head``) share: argument checks, the weights
in the kernels' layout, the guard against gradients, the tile choice of
the f32 route on CUDA cores (``pick_tile``), and the launch planner and
call of the bf16 route on the tensor cores (``plan_conv``, ``conv_bf16``:
``csrc/conv_wgmma.cuh``).

Public weights are HWIO, ``(3, 3, Ci, Co)``, as the JAX package passes
them; flattened, that is the kernels' ``[tap][Ci][Co]`` layout, so the
CUDA path reshapes and the plain versions permute to torch's OIHW.
``conv_weights`` takes a port module's ``nn.Conv2d`` (OIHW) to HWIO: the
one conversion between the modules and the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from . import _build

MAX_SMEM_BYTES = 232448  # per block on sm_90
SMS = 132  # streaming multiprocessors of an H100 SXM
TILES = (8, 4)  # square tiles of the f32 route, largest first
KC, CO = 8, 64  # staged input channels and output channels per chunk (conv_common.cuh)

# The bf16 route (csrc/conv_wgmma.cuh): input channels a K-step, stages of
# the TMA ring, and the (box_h, box_w, bn) of each compiled tile, by the
# kernel's ``config`` index, larger first (more reuse of each loaded byte)
KSTEP, STAGES = 64, 6
WGMMA_TILES = ((16, 8, 128), (8, 8, 128), (8, 8, 64))
EPI_CONV1, EPI_RESIDUAL, EPI_BIAS = 0, 1, 2  # conv_wgmma.cuh, enum Epilogue
MIN_SPLIT_KSTEPS = 9  # the shortest run of K-steps a split-K CTA is given


def conv_weights(conv: nn.Conv2d) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(kernel, bias)`` of a port conv in the public layout: HWIO
    ``(kh, kw, Ci, Co)`` and ``(Co,)``."""
    return conv.weight.permute(2, 3, 1, 0), conv.bias


def oihw(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO ``(kh, kw, Ci, Co)`` -> torch's OIHW in ``dtype``."""
    return w.permute(3, 2, 0, 1).to(dtype)


def check_activation(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} takes NHWC (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes f32 or bf16, got {x.dtype}")
    if x.shape[-1] % KC:
        raise ValueError(f"{what}: channels must be a multiple of {KC}, got {x.shape[-1]}")


def check_shape(t: torch.Tensor, shapes, name: str) -> None:
    if tuple(t.shape) not in [tuple(s) for s in shapes]:
        raise ValueError(f"{name} must be one of {list(shapes)}, got {tuple(t.shape)}")


def check_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when a CUDA call would need a gradient through a forward-only
    kernel (the Pallas kernels K3 and K4 have none either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {what} kernel is forward only, as the JAX package's: call it under "
            "torch.no_grad() or on detached tensors"
        )


def activation(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def kernel_param(t: torch.Tensor, shape, like: torch.Tensor) -> torch.Tensor:
    """A weight or bias as the kernels read it: rounded to the
    activation's dtype (as the plain version's convolution rounds it),
    held in f32, contiguous in ``shape``, on the activation's device."""
    return t.detach().to(like.device, like.dtype).float().reshape(shape).contiguous()


def check_tile(x: torch.Tensor, tile: Optional[int], what: str) -> None:
    """``tile`` belongs to the f32 route: a bf16 call that passes one raises
    rather than ignore it."""
    if tile is not None and x.dtype == torch.bfloat16:
        raise ValueError(f"{what}: tile is an argument of the f32 route only; the bf16 route "
                         "plans its own launch (kernels/_conv.py, plan_conv)")


def pick_tile(B: int, H: int, W: int, smem_bytes: Callable[[int], int],
              tile: Optional[int] = None) -> int:
    """The f32 route's square tile: ``tile`` if given, else the largest of
    ``TILES`` whose shared memory fits and that gives at least one block
    per SM, else the smallest that fits."""
    if tile is not None:
        if tile not in TILES:
            raise ValueError(f"tile must be one of {TILES}, got {tile}")
        if smem_bytes(tile) > MAX_SMEM_BYTES:
            raise ValueError(f"tile {tile} needs {smem_bytes(tile)} B of shared memory")
        return tile
    fits = [t for t in TILES if smem_bytes(t) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"no tile fits in shared memory ({smem_bytes(TILES[-1])} B)")
    for t in fits:
        if B * -(-H // t) * -(-W // t) >= SMS:
            return t
    return fits[-1]


def call(lib: ctypes.CDLL, name: str, tensors, ints, stream) -> int:
    """Call C entry ``name`` with pointer arguments (``None`` for a null
    pointer), int arguments and a stream, and return its CUDA error code."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(*[None if t is None else t.data_ptr() for t in tensors], *ints, stream)


# --- the bf16 route: one tensor-core convolution a launch --------------------------------


def wgmma_smem_bytes(box_h: int, box_w: int, bn: int) -> int:
    """Shared memory of one CTA (``conv_wgmma.cuh``, ``smem_bytes``): 1 KB
    of alignment slack, the ring, its barriers and the last-CTA flag."""
    return 1024 + STAGES * (box_h * box_w + bn) * 2 * KSTEP + 2 * STAGES * 8 + 16


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One launch of the tensor-core convolution over (B, H, W, C)."""

    config: int  # index into WGMMA_TILES
    boxes_y: int  # boxes along H, along W, and images
    boxes_x: int
    batch: int
    n_tiles: int  # tiles of bn output channels
    ksteps: int  # taps x ceil(C / KSTEP)
    splits: int  # CTAs that share the K-steps of one output tile

    @property
    def box(self) -> Tuple[int, int, int]:
        return WGMMA_TILES[self.config]

    @property
    def tiles(self) -> int:
        return self.batch * self.boxes_y * self.boxes_x * self.n_tiles

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    @property
    def smem_bytes(self) -> int:
        return wgmma_smem_bytes(*self.box)

    @property
    def partial_floats(self) -> int:
        """f32 workspace of the split-K partial sums: a box x bn tile per CTA."""
        box_h, box_w, bn = self.box
        return self.ctas * box_h * box_w * bn if self.splits > 1 else 0


def plan_conv(B: int, H: int, W: int, C: int, taps: int) -> ConvPlan:
    """The launch of one bf16 convolution: the largest tile of
    ``WGMMA_TILES`` that gives at least half the SMs a CTA without splitting
    K; where none does, the tile with the most CTAs and K split by the
    smallest divisor of its K-steps that reaches ``SMS`` CTAs, but into runs
    of no fewer than ``MIN_SPLIT_KSTEPS`` K-steps.

    Both thresholds are measured by chip_smoke.py's plan check (PERF.md, K3;
    one RCU at C = 256): at 64x64 the 128 CTAs of 8x8 x 128 tiles beat both
    the 256 of 8x8 x 64 (more bytes through the L2 for the same work) and
    the 64 of 16x8 x 128 (half the card idle); at 16x16 and 32x32 runs of 9
    or 12 K-steps beat runs of 4 and 1, which fill the card but lose more to
    the last CTA's sum of the partials than they gain. At 8x8 runs of 4 were
    about 1 µs faster a call; runs of 1 were slower there too."""
    ksteps = taps * -(-C // KSTEP)

    def plan(config: int, splits: int = 1) -> ConvPlan:
        box_h, box_w, bn = WGMMA_TILES[config]
        return ConvPlan(config, -(-H // box_h), -(-W // box_w), B, -(-C // bn), ksteps, splits)

    plans = [plan(i) for i in range(len(WGMMA_TILES))]
    for p in plans:
        if 2 * p.ctas >= SMS:
            return p
    most = max(plans, key=lambda p: p.ctas)
    divisors = [d for d in range(1, ksteps + 1)
                if ksteps % d == 0 and ksteps // d >= min(MIN_SPLIT_KSTEPS, ksteps)]
    splits = next((d for d in divisors if most.tiles * d >= SMS), divisors[-1])
    return dataclasses.replace(most, splits=splits)


def prepare_bf16(lib: ctypes.CDLL, like: torch.Tensor, weights, scratch: "Scratch"):
    """The one launch that prepares a bf16 call: each HWIO weight
    ``(3, 3, C, C)`` or ``(1, 1, C, C)`` (any strides, f32 or bf16; a port module's OIHW
    weight seen through ``conv_weights`` is one) to bf16 ``[tap][C][C]`` as
    the tensor-core convolution reads it, and the split-K counters of
    ``scratch`` to zero. Returns the converted weights."""
    C = like.shape[-1]
    views = []
    for w in weights:
        w = w.detach().to(like.device)
        views.append(w if w.dtype in (torch.float32, torch.bfloat16) else w.float())
    outs = [torch.empty((v.shape[0] * v.shape[1], C, C), dtype=torch.bfloat16, device=like.device)
            for v in views]
    n = len(views)
    fn = lib.soccdpt_prepare_bf16
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [(ctypes.c_void_p * n)(*[v.data_ptr() for v in views]),
            (ctypes.c_longlong * (4 * n))(*[st for v in views for st in v.stride()]),
            (ctypes.c_int * n)(*[v.shape[0] * v.shape[1] for v in views]),
            (ctypes.c_int * n)(*[int(v.dtype == torch.bfloat16) for v in views]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])]
    counters = scratch.counters
    rc = fn(n, *[ctypes.cast(a, ctypes.c_void_p) for a in args],
            None if counters is None else counters.data_ptr(),
            0 if counters is None else counters.numel(), C,
            torch.cuda.current_stream(like.device).cuda_stream)
    _build.check(lib, rc, "weight preparation kernel")
    return outs


def wgmma_bias(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A bias as the bf16 route reads it: f32 (the kernel rounds it to
    bf16, as the served modules do), contiguous, on the activation's device;
    no copy where it already is that."""
    return activation(b.detach().to(like.device, torch.float32).reshape(-1))


class Scratch:
    """The split-K workspace of a call's convolutions, in one allocation each:
    f32 partial sums, shared by the convolutions (they run in stream order),
    and one counter per output tile of each convolution, which
    ``prepare_bf16`` zeroes."""

    def __init__(self, plans, device):
        split = [p for p in plans if p.splits > 1]
        self.partials = self.counters = None
        if split:
            self.partials = torch.empty(max(p.partial_floats for p in split), dtype=torch.float32,
                                        device=device)
            self.counters = torch.empty(sum(p.tiles for p in split), dtype=torch.int32,
                                        device=device)
        self._next = 0

    def take(self, plan: ConvPlan):
        """(partials, counters) of the next convolution of ``plan``."""
        if plan.splits == 1:
            return None, None
        counters = self.counters[self._next:self._next + plan.tiles]
        self._next += plan.tiles
        return self.partials, counters


def conv_bf16(lib: ctypes.CDLL, plan: ConvPlan, scratch: Scratch, src: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, out: torch.Tensor, epilogue: int,
              residual: Optional[torch.Tensor] = None) -> None:
    """One tensor-core convolution of ``src`` (B, H, W, C) into ``out``:
    ``w`` bf16 (taps, C, C), ``bias`` f32 (C,), ``epilogue`` one of
    EPI_CONV1, EPI_RESIDUAL (with ``residual``), EPI_BIAS. Raises on a
    launch error."""
    B, H, W, C = src.shape
    partials, counters = scratch.take(plan)
    rc = call(lib, "soccdpt_conv_bf16", [src, w, bias, residual, out, partials, counters],
              [B, H, W, C, w.shape[0], epilogue, plan.config, plan.splits],
              torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, rc, "tensor-core convolution kernel")
