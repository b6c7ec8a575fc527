"""The decoder's 2x bilinear upsample (``align_corners=True``) in bf16.

Replaces no TPU kernel: the JAX package upsamples through interpolation
matrices that XLA multiplies (``soccdpt_tpu/ops/resize.py``). The CUDA
source is ``csrc/upsample.cuh`` (the kernel and its design) with its C
entry in ``csrc/upsample.cu``.

Contract: ``out = F.interpolate(x, size=(2H, 2W), mode="bilinear",
align_corners=True)`` over a contiguous NHWC bf16 ``x (B, H, W, C)``, as
``(B, 2H, 2W, C)``, within one bf16 step of aten's CUDA kernel and mostly
bit for bit: the same f32 weights and neighbours, one rounding.

Bound on the H100: bytes, each input value read once and each output
value written once (``upsample_bytes``); at the BEiT-L/512 decoder's
refinenet1 at batch 6 about 75 us. ``plan_rows`` gives the output rows a
CTA walks (``BAND_ROWS``), from a sweep of 1 to 32 rows at the benchmark
cells' twelve calls on the H100 (PERF.md, section 6): a thread's walk down
its band waits on each new source row, so short bands, many CTAs, keep
more loads in flight, while each band re-reads its first source rows; 4
rows were fastest for 16-byte chunks from 16x16 maps up, 16 for the
one-channel path, whose thread stores 2 bytes a row. A grid of fewer CTAs
than the card has SMs (``_build.SMS``) halves the band until it fills them
or is one row.

The op is ``soccdpt::upsample2x`` (``_build.op``): its CUDA implementation
launches the kernel on the current stream and allocates only its output,
its CPU implementation is ``upsample2x_plain``. ``ops/resize.py`` decides
which calls take it. ``kernels.ops.launches()["upsample2x"]`` counts the
op's launches from the decoder and the heads; ``fallbacks()["upsample2x"]``
the card's bilinear ``align_corners=True`` resizes that ``ops/resize.py``
left to ``F.interpolate``. K4 and K5 launch the kernel through
``launch``, inside their own ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import INT, PTR

THREADS = 256  # a CTA's threads: must match UP_THREADS in csrc/upsample.cuh
BAND_ROWS = {True: 4, False: 16}  # output rows a CTA walks, by whether chunks are 16 bytes


def upsample_bytes(B: int, H: int, W: int, C: int) -> int:
    """Bytes the bound counts: the bf16 input read once, the output written once."""
    return 2 * B * H * W * C * 5


def plan_rows(B: int, H: int, W: int, C: int, wide: bool = True) -> int:
    """Output rows a CTA walks: ``BAND_ROWS[wide]``, halved while the grid
    has fewer CTAs than the card's ``_build.SMS`` SMs. ``wide``: 16-byte
    chunks of 8 channels (C % 8 == 0, aligned), else one channel a thread."""
    col_ctas = -(-2 * W * (C // 8 if wide else C) // THREADS)
    rows = BAND_ROWS[wide]
    while rows > 1 and col_ctas * -(-2 * H // rows) * B < _build.SMS:
        rows //= 2
    return rows


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.interpolate`` on the NCHW view, returned as a
    contiguous NHWC tensor."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * x.shape[1], 2 * x.shape[2]),
                        mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1).contiguous()


def launch(x: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on ``x`` (B, H, W, C), contiguous bf16 on
    the card; returns a new (B, 2H, 2W, C)."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"the upsample kernel takes contiguous 4-D bf16 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)} at strides {x.stride()}")
    B, H, W, C = x.shape
    out = torch.empty((B, 2 * H, 2 * W, C), dtype=x.dtype, device=x.device)
    _UPSAMPLE(x.device, x, out, B, H, W, C,
              plan_rows(B, H, W, C, C % 8 == 0 and x.data_ptr() % 16 == 0))
    return out


_UPSAMPLE = _build.Entry("upsample", "soccdpt_upsample2x_bf16", [PTR] * 2 + [INT] * 5,
                         "upsample kernel")


def _upsample2x_fake(x):
    B, H, W, C = x.shape
    return x.new_empty((B, 2 * H, 2 * W, C))


_upsample2x_op = _build.op("upsample2x(Tensor x) -> Tensor", launch, upsample2x_plain,
                           _upsample2x_fake)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample (``align_corners=True``) of NHWC ``x`` through
    the op: the kernel on the card, ``upsample2x_plain`` on the CPU. No
    gradient: ``ops/resize.py`` sends what autograd records elsewhere."""
    return _upsample2x_op(x)
