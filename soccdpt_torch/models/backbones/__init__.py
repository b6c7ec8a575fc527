"""Backbone registry (the Swin-V2 and ViT/BEiT families so far).

Every backbone is a module whose ``forward(x_nhwc, generator=None)``
returns the tuple of stage feature maps, NHWC; ``generator`` feeds what a
backbone draws at random in training mode. The other families of the JAX
package are still to be ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

SWIN2_NAMES = ("swin2t16_256", "swin2b24_384", "swin2l24_384", "swin2test_64")
VIT_NAMES = (
    "vitb16_384", "vitl16_384", "beitb16_384", "beitl16_384", "beitl16_512",
    "vittest_64", "beittest_64",
)


def make_backbone(
    name: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
    remat: bool = False,
):
    """Return (backbone module factory, stage channel widths). ``remat``
    recomputes each Swin-V2 block in the backward pass; the ViT/BEiT trunk
    takes none, as in the JAX package."""
    if name in SWIN2_NAMES:
        from .swin2 import make_swin2_backbone

        return make_swin2_backbone(name, hooks=hooks, input_size=input_size, remat=remat)
    if name in VIT_NAMES:
        from .vit import make_vit_backbone

        return make_vit_backbone(name, hooks=hooks, input_size=input_size)
    raise NotImplementedError(
        f"backbone {name!r} is not ported to soccdpt_torch yet (see ROADMAP.md)"
    )


def dpt_extras(name: str) -> dict:
    """Backbone-specific DPT wiring; the Swin-V2 and ViT/BEiT families
    need none."""
    if name in SWIN2_NAMES or name in VIT_NAMES:
        return {}
    raise NotImplementedError(
        f"backbone {name!r} is not ported to soccdpt_torch yet (see ROADMAP.md)"
    )
