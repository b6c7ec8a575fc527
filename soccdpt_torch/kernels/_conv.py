"""What the three decoder-convolution wrappers (K3 ``fused_rcu``, K4
``fused_fusion``, K5 ``fused_head``) share: argument checks, the weights
in the kernels' layout, the tile choice and the guard against gradients.

Public weights are HWIO, ``(3, 3, Ci, Co)``, as the JAX package passes
them; flattened, that is the kernels' ``[tap][Ci][Co]`` layout, so the
CUDA path reshapes and the plain versions permute to torch's OIHW.
``conv_weights`` takes a port module's ``nn.Conv2d`` (OIHW) to HWIO: the
one conversion between the modules and the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

MAX_SMEM_BYTES = 232448  # per block on sm_90
SMS = 132  # streaming multiprocessors of an H100 SXM
TILES = (8, 4)  # square tiles the kernels are built for, largest first
KC, CO = 8, 64  # staged input channels and output channels per chunk (conv_common.cuh)


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


def pick_tile(B: int, H: int, W: int, smem_bytes: Callable[[int], int],
              tile: Optional[int] = None) -> int:
    """The square tile of a launch: ``tile`` if given, else the largest of
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
    """Call C entry ``name`` with pointer arguments, int arguments and a
    stream, and return its CUDA error code."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(*[t.data_ptr() for t in tensors], *ints, stream)
