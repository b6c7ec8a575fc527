"""The precision the reference computes in.

``"float32"`` is the reference itself: everything in f32 (the harness
turns TF32 off before it runs). ``"fp8"`` is the control, one step below
what the configurations state (bf16 compute, f32 norms, softmax and
geometry): the network's activations are bf16 as the program's are,
every operand of a matrix product or a convolution is rounded to float8
e4m3 (per tensor, scaled to its largest magnitude), and the geometry
tail, which the program runs in f32, runs in bf16.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

MODES = ("float32", "fp8")
_MODE = contextvars.ContextVar("reference_precision", default="float32")


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference in ``mode`` inside the block."""
    if mode not in MODES:
        raise ValueError(f"precision is one of {MODES}, not {mode!r}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in x's type."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product, in the precision in force."""
    if _MODE.get() == "float32" or x is None:
        return x
    return quantize(x, torch.float8_e4m3fn)


def act_dtype() -> torch.dtype:
    """The dtype of the network's activations."""
    return torch.float32 if _MODE.get() == "float32" else torch.bfloat16


def tail_dtype() -> torch.dtype:
    """The dtype of the geometry tail (resizes, unprojection, voxelization)."""
    return torch.float32 if _MODE.get() == "float32" else torch.bfloat16
