"""Backbone registry (the Swin-V2 family so far).

Every backbone is a module whose ``forward(x_nhwc)`` returns the tuple of
stage feature maps, NHWC. The other families of the JAX package are
still to be ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

SWIN2_NAMES = ("swin2t16_256", "swin2b24_384", "swin2l24_384", "swin2test_64")


def make_backbone(
    name: str,
    hooks: Optional[Sequence[int]] = None,
    input_size: Optional[Tuple[int, int]] = None,
):
    """Return (backbone module factory, stage channel widths)."""
    if name in SWIN2_NAMES:
        from .swin2 import make_swin2_backbone

        return make_swin2_backbone(name, hooks=hooks, input_size=input_size)
    raise NotImplementedError(
        f"backbone {name!r} is not ported to soccdpt_torch yet (see ROADMAP.md)"
    )


def dpt_extras(name: str) -> dict:
    """Backbone-specific DPT wiring; the Swin-V2 family needs none."""
    if name in SWIN2_NAMES:
        return {}
    raise NotImplementedError(
        f"backbone {name!r} is not ported to soccdpt_torch yet (see ROADMAP.md)"
    )
