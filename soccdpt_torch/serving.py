"""End-to-end serving: raw camera frames -> depth, segmentation, points
and the occupancy grid (the port of ``soccdpt_tpu/serving.py``).

One call preprocesses uint8 frames on the device, runs the network and
the geometry tail, and returns outputs at camera resolution. The
network runs in bf16 when ``cfg.compute_dtype == "bfloat16"``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .core.config import ModelConfig
from .core.device import resolve_device
from .data.transforms import device_preprocess
from .models.bias_cache import build_inference_cache
from .models.soccdpt import compute_dtype


def make_serving_fn(
    cfg: ModelConfig,
    model: nn.Module,
    compute_occ: bool = False,
    output_size: Optional[Tuple[int, int]] = None,
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Build ``serve(frames_u8) -> (inv_depth, seg, points, occ|None)``.

    ``frames_u8``: (B, H, W, 3) uint8 RGB, a numpy array or a tensor on
    any device. ``model`` moves to ``device`` (the card unless ``device``
    says otherwise) and its attention biases are folded from its current
    weights; a later weight load is detected and never served stale
    (``models/bias_cache.py``).
    """
    if getattr(model, "cfg", None) != cfg:
        raise ValueError("the model was built for another config")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    build_inference_cache(model)
    net_w, net_h = cfg.net_size
    dtype = compute_dtype(cfg)

    def serve(frames_u8):
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(frames_u8)
        with torch.inference_mode():
            x = device_preprocess(frames_u8.to(dev), (net_w, net_h), dtype=dtype)
            return model(x, compute_occ=compute_occ, output_size=output_size)

    return serve
