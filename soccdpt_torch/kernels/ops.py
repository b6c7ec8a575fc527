"""The ``soccdpt::`` custom ops that an exported program calls.

Importing this module registers them with ``torch.library`` and imports no
model code: a program written by ``cli/export.py`` is loaded with
``torch.export.load`` after it, in a process that knows nothing else of
the package (``cli/run_exported.py``).

* ``soccdpt::window_attention`` is K1 (``kernels/window_attention.py``),
  the attention of every Swin-V2 block;
* ``soccdpt::global_attention`` and ``soccdpt::global_attention_with_lse``
  are K6 (``kernels/global_attention.py``), the attention of every
  ViT/BEiT block;
* ``soccdpt::upsample2x`` (``kernels/upsample.py``) is the DPT decoder's
  and heads' bf16 2x bilinear upsample;
* ``soccdpt::unproject_slots`` (``kernels/unproject_slots.py``) is the
  geometry tail: inverse depth at camera resolution to points and the
  voxelizer's slot keys.

On CUDA tensors each launches its hand-written kernel, whose library
``nvcc`` builds from ``soccdpt_torch/csrc/`` at the first launch; on CPU
tensors each runs its plain PyTorch version.
"""
from __future__ import annotations

from typing import Dict

from .global_attention import global_attention
from .unproject_slots import unproject_slots
from .upsample import upsample2x
from .window_attention import window_attention

# the function whose ``launches`` counts each kernel's launches
COUNTERS = {"window_attention": window_attention, "global_attention": global_attention,
            "upsample2x": upsample2x, "unproject_slots": unproject_slots}


def launches() -> Dict[str, int]:
    """The kernels' launch counts so far."""
    return {name: fn.launches for name, fn in COUNTERS.items()}


def fallbacks() -> int:
    """The card's bilinear ``align_corners=True`` resizes so far that did
    not take the upsample kernel (``ops/resize.py``): beside
    ``launches()["upsample2x"]``, the kernel's hit share. The geometry
    kernel's are ``unproject_slots.fallbacks``."""
    return upsample2x.fallbacks
