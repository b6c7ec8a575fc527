"""Backbone registry: every backbone family of the JAX package.

Every backbone is a module whose ``forward(x_nhwc, generator=None)``
returns the tuple of stage feature maps, NHWC; ``generator`` feeds what a
backbone draws at random in training mode. ``vit_3d`` is the odd one: the
JAX package's standalone volumetric refiner, which reads an occupancy
grid and gives no stage features.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

SWIN2_NAMES = ("swin2t16_256", "swin2b24_384", "swin2l24_384", "swin2test_64")
SWIN1_NAMES = ("swinl12_384", "swin1test_64")
VIT_NAMES = (
    "vitb16_384", "vitl16_384", "beitb16_384", "beitl16_384", "beitl16_512",
    "vittest_64", "beittest_64",
)
HYBRID_NAMES = ("vitb_rn50_384", "hybridtest_64")
LEVIT_NAMES = ("levit_384", "levittest_64")
NEXT_VIT_NAMES = ("next_vit_large_6m", "nextvittest_64")
VIT3D_NAMES = ("vit_3d",)


def make_backbone(
    name: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
    remat: bool = False,
):
    """Return (backbone module factory, stage channel widths). ``remat``
    recomputes each Swin-V2 block in the backward pass; the other trunks
    take none, as in the JAX package. ``input_size`` fixes the stage grids
    of the windowed and grid-biased trunks (Swin, BEiT, LeViT); ViT and the
    hybrid resize their position embedding to any input, and Next-ViT is
    convolutional apart from its global attention. ``vit_3d`` gives the
    ``ViT3D`` class, which takes the grid size, and no widths."""
    if name in SWIN2_NAMES:
        from .swin2 import make_swin2_backbone

        return make_swin2_backbone(name, hooks=hooks, input_size=input_size, remat=remat)
    if name in SWIN1_NAMES:
        from .swin import make_swin1_backbone

        return make_swin1_backbone(name, hooks=hooks, input_size=input_size)
    if name in VIT_NAMES:
        from .vit import make_vit_backbone

        return make_vit_backbone(name, hooks=hooks, input_size=input_size)
    if name in HYBRID_NAMES:
        from .vit_hybrid import make_vit_hybrid_backbone

        return make_vit_hybrid_backbone(name, hooks=hooks)
    if name in LEVIT_NAMES:
        from .levit import make_levit_backbone

        return make_levit_backbone(name, hooks=hooks, input_size=input_size)
    if name in NEXT_VIT_NAMES:
        from .next_vit import make_next_vit_backbone

        return make_next_vit_backbone(name, hooks=hooks)
    if name in VIT3D_NAMES:
        from .vit_3d import ViT3D

        return ViT3D, ()
    raise ValueError(f"backbone {name!r} not implemented")


def dpt_extras(name: str) -> dict:
    """Backbone-specific DPT wiring: LeViT is a 3-level pyramid whose
    refinenet3 has a fixed size (the level-2 grid, ceil(g / 2)) and puts a
    transposed-conv stem before the head; the other families need none."""
    if name in LEVIT_NAMES:
        from .levit import LEVIT_CONFIGS, StemTranspose

        g = -(-LEVIT_CONFIGS[name].img_size // 16)
        return {"size_refinenet3": (-(-g // 2), -(-g // 2)), "stem_transpose": StemTranspose}
    return {}
