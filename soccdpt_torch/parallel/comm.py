"""The collectives of the data- and tensor-parallel trainer.

* :func:`all_reduce_` sums a tensor over a group in place;
  :func:`all_reduce_buckets_` does it for a list of tensors (gradients),
  packed into flat buckets of at most ``BUCKET_BYTES``;
* :func:`all_reduce_sum` is differentiable (BatchNorm's moments): its
  backward sums the incoming gradients over the same group, so a rank's
  rows receive the gradient of every rank's loss;
* :func:`all_gather_dim` puts the full tensor together from each rank's
  slice along one dim (the sharded optimizer update).

Gloo takes CUDA tensors in few of its collectives. Under a gloo group a
CUDA tensor therefore goes through pinned host memory
(:func:`_gloo_staged`), and only there: NCCL, and gloo on CPU tensors,
take the tensors where they are.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2**20


def _gloo_staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through pinned host memory for ``group``: a CUDA
    tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``t`` over ``group`` in place; returns ``t``."""
    if _gloo_staged(t, group):
        host = _pinned_copy(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_buckets_(
    tensors: Sequence[torch.Tensor], group, bucket_bytes: int = BUCKET_BYTES
) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, a flat
    bucket of one dtype per collective."""
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    sizes: Dict[torch.dtype, int] = {}

    def flush(dtype):
        bucket = buckets.pop(dtype)
        sizes.pop(dtype)
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]), group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
        sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel() * t.element_size()
        if sizes[t.dtype] >= bucket_bytes:
            flush(t.dtype)
    for dtype in list(buckets):
        flush(dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable: every rank must
    call the backward too, in the same order, as identical graphs do."""
    return _AllReduceSum.apply(x, group)


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The tensor whose slices along ``dim`` are the ranks' ``t``, in rank
    order of ``group``."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _gloo_staged(t, group):
        host = _pinned_copy(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)
