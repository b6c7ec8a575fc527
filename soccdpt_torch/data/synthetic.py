"""Synthetic data from a numpy seed: training batches, and fixture trees
on disk that honour the BDD and IDD directory contracts.

The port of the JAX package's ``data/synthetic.py``: the same procedural
scene and the same fixture writers (``make_bdd_fixture``,
``make_idd_fixture``, ``make_selfconsistent_bdd_fixture``), writing PNG
files through ``image_io``. From one seed both packages write the same
pixels; the self-consistent fixture runs the port's own model, whose
random weights differ from the JAX package's.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from ..core.config import CameraConfig
from . import image_io as io
from .anue_labels import LABELS

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


def make_bdd_fixture(
    base_path: str,
    sequences: Sequence[str] = ("1000000000001", "1000000000002"),
    frames_per_seq: int = 3,
    width: int = 128,
    height: int = 96,
    seed: int = 0,
) -> str:
    """Create a miniature Depth_Dataset_Bengaluru tree; returns calib path."""
    rng = np.random.default_rng(seed)
    camera = CameraConfig(
        fx=width * 0.9,
        fy=width * 0.9,
        cx=width / 2,
        cy=height / 2,
        width=width,
        height=height,
    )
    calib_dir = os.path.join(base_path, "calibration", "pocoX3")
    os.makedirs(calib_dir, exist_ok=True)
    calib_path = os.path.join(calib_dir, "calib.yaml")
    camera.to_yaml(calib_path)

    for seq in sequences:
        seq_dir = os.path.join(base_path, seq)
        for sub in ("rgb_img", "depth_img", "seg_img"):
            os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
        rows = ["index,Timestamp"]
        for i in range(frames_per_seq):
            ts = int(seq) + i * 33
            rgb, seg, disp = _scene(rng, width, height)
            io.imwrite(os.path.join(seq_dir, "rgb_img", f"{ts}.png"), rgb)
            io.imwrite(os.path.join(seq_dir, "seg_img", f"{ts}.png"), seg)
            io.imwrite(os.path.join(seq_dir, "depth_img", f"{ts}.png"), disp)
            rows.append(f"{i},{ts}")
        with open(os.path.join(seq_dir, f"{seq}.csv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    return calib_path


def make_idd_fixture(
    base_path: str,
    folders_per_split: int = 2,
    frames_per_folder: int = 2,
    width: int = 128,
    height: int = 96,
    level_id: str = "level1Ids",
    seed: int = 0,
) -> str:
    """Create a miniature IDD_Segmentation tree; returns base_path."""
    rng = np.random.default_rng(seed)
    # draw from ids valid for the level: use level1Id/level3Id/level4Id
    attr = {
        "level1Ids": "level1Id",
        "level3Ids": "level3Id",
        "level4Ids": "level4Id",
    }[level_id]
    valid_ids = sorted({getattr(l, attr) for l in LABELS if getattr(l, attr) != 255})

    for split in ("train", "val"):
        for fi in range(folders_per_split):
            folder = str(fi)
            left = os.path.join(base_path, "leftImg8bit", split, folder)
            fine = os.path.join(base_path, "gtFine", split, folder)
            depth = os.path.join(base_path, "depth", split, folder)
            for d in (left, fine, depth):
                os.makedirs(d, exist_ok=True)
            for i in range(frames_per_folder):
                stem = f"{split}_{folder}_{i:06d}"
                rgb, _, disp = _scene(rng, width, height)
                ids = rng.choice(valid_ids, size=(height, width)).astype(np.uint8)
                io.imwrite(os.path.join(left, stem + "_leftImg8bit.png"), rgb)
                io.imwrite(
                    os.path.join(fine, f"{stem}_gtFine_label{level_id}.png"), ids
                )
                io.imwrite(os.path.join(depth, stem + "_leftImg8bit.png"), disp)
    return base_path


def make_selfconsistent_bdd_fixture(
    base_path: str,
    model_type: str = "dpt_swin2_tiny_256",
    version: int = 3,
    frames_per_seq: int = 8,
    width: int = 1024,
    height: int = 768,
    seed: int = 0,
    device: Union[str, "torch.device", None] = None,
) -> str:
    """A BDD fixture whose GT disparity is the frozen base model's own
    predicted inverse depth, so that occupancy-head training has a signal
    to learn (on the procedural fixtures it has none: val IoU stays at the
    predict-all floor). The model is the one the occupancy trainer builds,
    ``build_model(..., seed=0)``, run on ``device`` (the card unless it
    says otherwise); its inverse depth is mapped onto the disparity range
    that keeps the GT inside the ``GT_OCCUPANCY`` volume and written as
    the tree's depth PNGs, uint16 where that range passes 255. Returns the
    calib path."""
    import torch

    from ..core.config import ModelConfig
    from ..models.soccdpt import build_model
    from .bdd import BDDSequence
    from .transforms import load_transforms

    sequences = ("1000000000001", "1000000000002")
    calib = make_bdd_fixture(base_path, sequences=sequences, frames_per_seq=frames_per_seq,
                             width=width, height=height, seed=seed)
    camera = BDDSequence(os.path.join(base_path, sequences[0]), calib).camera
    mcfg = ModelConfig(model_type=model_type, version=version, compute_occ=True,
                       occupancy_head=True, compute_dtype="bfloat16", camera=camera)
    model = build_model(mcfg, device=device, seed=0)
    dev = next(model.parameters()).device
    transform, _, _ = load_transforms(model_type)
    target_size = (camera.width, camera.height)

    # depth = baseline * f / disparity spans [0.0046, 0.144], the range of
    # the 128x96 procedural fixture, which GT_OCCUPANCY keeps in the grid
    bf = 1.0e-2 * camera.fx
    disp_lo, disp_hi = bf / 0.144, bf / 0.0046
    for seq_name in sequences:
        seq = BDDSequence(os.path.join(base_path, seq_name), calib)
        for i in range(len(seq)):
            frame = seq[i]
            rgb = io.resize(frame["rgb_frame"], target_size)
            x = transform({"image": rgb.astype(np.float32)})["image"]
            with torch.no_grad():
                inv = model(torch.from_numpy(x[None]).to(dev), return_raw=True)[0]
            inv = inv[0].float().cpu().numpy()
            lo, hi = float(inv.min()), float(inv.max())
            disp = (inv - lo) / max(hi - lo, 1e-9) * (disp_hi - disp_lo) + disp_lo
            disp = io.resize(disp.astype(np.float32), target_size, interpolation=io.INTER_LINEAR)
            path = os.path.join(base_path, seq_name, "depth_img", f"{frame['timestamp']}.png")
            if disp_hi > 255:
                io.imwrite(path, np.clip(disp, 1, 65535).astype(np.uint16))
            else:
                io.imwrite(path, np.clip(disp, 1, 255).astype(np.uint8))
    return calib
