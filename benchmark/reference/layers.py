"""Plain layer calls of the reference, NHWC at module boundaries as in the
program, every product through :func:`precision.operand`. A layer runs
in its input's dtype, its weights cast to it; norms and softmax compute
in f32 and cast back (all no-ops in f32)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import operand


def _as(p, x: torch.Tensor):
    return None if p is None else p.to(x.dtype)


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(operand(x), operand(_as(mod.weight, x)), _as(mod.bias, x))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(operand(a), operand(b))


def softmax(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.softmax(s.float(), dim=-1).to(dtype)


def conv(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(operand(x.permute(0, 3, 1, 2)), operand(_as(mod.weight, x)),
                 _as(mod.bias, x), mod.stride, mod.padding, mod.dilation, mod.groups)
    return y.permute(0, 2, 3, 1)


def conv_transpose(mod: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    y = F.conv_transpose2d(operand(x.permute(0, 3, 1, 2)), operand(_as(mod.weight, x)),
                           _as(mod.bias, x), mod.stride, mod.padding, mod.output_padding,
                           mod.groups, mod.dilation)
    return y.permute(0, 2, 3, 1)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias,
                        mod.eps).to(x.dtype)


def batch_norm(mod: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis with the running statistics."""
    xf = x.float()
    mean, var = mod.running_mean, mod.running_var
    return ((xf - mean) * torch.rsqrt(var + mod.eps) * mod.weight + mod.bias).to(x.dtype)


def resize(x: torch.Tensor, size, method: str, align_corners: bool = False) -> torch.Tensor:
    """Resize the (H, W) axes of an NHWC tensor."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = x.permute(0, 3, 1, 2)
    if method == "nearest":
        y = F.interpolate(y, size=tuple(size), mode="nearest")
    else:
        y = F.interpolate(y, size=tuple(size), mode=method, align_corners=align_corners,
                          antialias=False)
    return y.permute(0, 2, 3, 1)
