"""The operations of a whole request, counted once by
``torch.utils.flop_counter.FlopCounterMode`` on the reference at the
cell's shapes, on the meta device: the same count whatever implements
the work."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import reference
from .reference import geometry


def _meta_model(cfg: dict):
    with torch.device("meta"):
        return reference.SOccDPTV3(cfg)


def request_flops(cfg: dict, batch: int) -> int:
    """A grid request of ``batch`` frames: preprocessing, network, geometry."""
    model = _meta_model(cfg).eval()
    cam = cfg["camera"]
    frames = torch.empty(batch, cam["height"], cam["width"], 3, dtype=torch.uint8,
                         device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        inv, seg = model(reference.preprocess(frames, cfg["net_size"]))
        inv_up, _ = geometry.upsample(inv, seg, (cam["height"], cam["width"]))
        geometry.unproject(inv_up, cam)
    return counter.get_total_flops()
