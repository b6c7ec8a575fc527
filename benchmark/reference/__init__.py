"""The plain PyTorch reference of SOccDPT V3 that decides ``correct``.

A frozen copy of the architecture the configuration files describe,
written with plain ``torch`` operations: no kernel, cache, graph or
batching of the program, and nothing imported from it. It runs in f32
(the harness turns TF32 off) or, as the control, with fp8 products
(``precision.py``). A trunk family is a module of its own,
``<family>.py``, found by the configuration's ``backbone.family``
(``model.trunk_module``).
"""
from __future__ import annotations

import torch

from . import geometry
from .model import SOccDPTV3, kernel_calls, preprocess, trunk_module


def build(cfg: dict, state: dict, device) -> SOccDPTV3:
    """The reference model of configuration ``cfg`` holding ``state`` (a
    state dict under the program's names), in eval mode."""
    with torch.device("meta"):
        model = SOccDPTV3(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


@torch.no_grad()
def serve(model: SOccDPTV3, frames_u8: torch.Tensor, cfg: dict):
    """A grid request: (inverse depth, segmentation, points, grid) at
    camera resolution."""
    inv, seg = model(preprocess(frames_u8, cfg["net_size"]))
    hw = (cfg["camera"]["height"], cfg["camera"]["width"])
    inv_up, seg_up = geometry.upsample(inv, seg, hw)
    points = geometry.unproject(inv_up, cfg["camera"])
    return inv_up, seg_up, points, geometry.voxelize(points, seg_up, cfg["occupancy"])
