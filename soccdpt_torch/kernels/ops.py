"""The ``soccdpt::`` ops: every hand-written kernel, and their counts.

Importing this module registers every kernel's op (``_build.op``) and
imports no model code: a program written by ``cli/export.py`` is loaded
with ``torch.export.load`` after it, in a process that knows nothing else
of the package (``cli/run_exported.py``).

* ``window_attention``: K1 (``kernels/window_attention.py``), the
  attention of every Swin-V2 block;
* ``global_attention``, ``global_attention_with_lse`` and
  ``global_attention_backward``: K6 and K7 (``kernels/global_attention.py``),
  the attention of every ViT/BEiT block and its gradient;
* ``segment_sum`` and ``segment_sum_backward``: K2
  (``kernels/segment_sum.py``), the voxelizer's accumulation and its
  gradient;
* ``fused_rcu``, ``fused_rcu_tail`` and ``fused_head_tail``: K3, K4 and K5
  (``kernels/fused_rcu.py``, ``fused_fusion.py``, ``fused_head.py``), the
  DPT decoder's fused convolutions;
* ``upsample2x`` (``kernels/upsample.py``): the DPT decoder's and heads'
  bf16 2x bilinear upsample;
* ``unproject_slots`` (``kernels/unproject_slots.py``): the geometry tail,
  inverse depth at camera resolution to points and the voxelizer's slot
  keys.

On CUDA tensors each launches its kernels, whose library ``nvcc`` builds
from ``soccdpt_torch/csrc/`` at the first launch; on CPU tensors each runs
its plain PyTorch version. ``launches()`` counts each op's calls on the
card, ``fallbacks()`` the card's calls that ``ops/resize.py`` and
``ops/geometry.py`` left to the plain path (``count_fallback``).
"""
from __future__ import annotations

from . import (  # noqa: F401  (each registers its ops)
    fused_fusion,
    fused_head,
    fused_rcu,
    global_attention,
    segment_sum,
    unproject_slots,
    upsample,
    window_attention,
)
from ._build import count_fallback, fallbacks, launches  # noqa: F401
