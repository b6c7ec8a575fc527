"""Synthetic training batches from a numpy seed.

The procedural scene of the JAX package's ``data/synthetic.py`` and a
batch maker around it; the fixture trees on disk that honour the BDD and
IDD directory contracts are still to be ported, with the datasets
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# class -> colour of the BDD segmentation images (background, vehicle, pedestrian)
CLASS_COLORS = ((0, 0, 0), (0, 0, 142), (220, 20, 60))


def _scene(rng, width, height, num_boxes=4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Procedural street-ish scene: (rgb u8, seg_rgb u8, disparity u8)."""
    rgb = rng.integers(40, 216, (height, width, 3), dtype=np.uint8)
    seg = np.zeros((height, width, 3), np.uint8)  # class 0 = black bg
    # horizontal disparity ramp: nearer at the bottom
    ramp = np.linspace(8, 200, height, dtype=np.float32)[:, None]
    disparity = np.broadcast_to(ramp, (height, width)).copy()
    for _ in range(num_boxes):
        cls = int(rng.integers(1, 3))
        w = int(rng.integers(width // 8, width // 3))
        h = int(rng.integers(height // 8, height // 3))
        x0 = int(rng.integers(0, width - w))
        y0 = int(rng.integers(height // 2, height - h)) if height - h > height // 2 else 0
        color = CLASS_COLORS[cls]
        seg[y0 : y0 + h, x0 : x0 + w] = color
        rgb[y0 : y0 + h, x0 : x0 + w] = color
        disparity[y0 : y0 + h, x0 : x0 + w] = float(rng.integers(60, 250))
    return rgb, seg, np.clip(disparity, 1, 255).astype(np.uint8)


def make_batch(
    seed: int,
    batch: int,
    hw: Tuple[int, int],
    net_hw: Tuple[int, int],
    num_classes: int = 3,
) -> Dict[str, np.ndarray]:
    """One training batch of ``batch`` scenes at GT resolution ``hw``:

    * ``image``      (B, 3, net_h, net_w) f32, the frame subsampled to net
      size (nearest) and normalised to [-1, 1] as the served frames are;
    * ``disparity``  (B, H, W) f32;
    * ``mask_disp``  (B, H, W) bool, all true;
    * ``seg``        (B, C, H, W) f32 one-hot class masks;
    * ``mask_seg``   (B, C, H, W) bool, all true.
    """
    if not 1 <= num_classes <= len(CLASS_COLORS):
        raise ValueError(f"num_classes must lie in 1..{len(CLASS_COLORS)}, got {num_classes}")
    rng = np.random.default_rng(seed)
    (H, W), (nh, nw) = hw, net_hw
    rows = (np.arange(nh) * H) // nh
    cols = (np.arange(nw) * W) // nw
    colors = np.asarray(CLASS_COLORS[:num_classes], np.uint8)
    images, disps, segs = [], [], []
    for _ in range(batch):
        rgb, seg, disp = _scene(rng, W, H)
        x = rgb[rows][:, cols].astype(np.float32) / 255.0
        images.append(((x - 0.5) / 0.5).transpose(2, 0, 1))
        disps.append(disp.astype(np.float32))
        onehot = (seg[None] == colors[:, None, None, :]).all(-1)
        segs.append(onehot.astype(np.float32))
    return {
        "image": np.stack(images),
        "disparity": np.stack(disps),
        "mask_disp": np.ones((batch, H, W), bool),
        "seg": np.stack(segs),
        "mask_seg": np.ones((batch, num_classes, H, W), bool),
    }
