"""Preprocessing of camera frames: the host pipeline of the datasets and
the on-device one of serving.

The host pipeline is the port of ``soccdpt_tpu/data/transforms.py``
(MiDaS-style: an aspect-aware resize to a multiple of 32, mean/std
normalisation, HWC -> CHW float32) with ``image_io.resize`` in place of
``cv2.resize``. Its normalisation divides by nothing first: an image of
0..255 values comes out in -1..509, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import MODEL_TYPES
from ..ops.resize import resize_hw
from . import image_io as io


def _constrain_to_multiple_of(
    x: float, multiple: int, min_val: float = 0, max_val: Optional[float] = None
) -> int:
    y = int(round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(math.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(math.ceil(x / multiple) * multiple)
    return y


def compute_resize_shape(
    in_width: int,
    in_height: int,
    out_width: int,
    out_height: int,
    keep_aspect_ratio: bool = False,
    ensure_multiple_of: int = 1,
    resize_method: str = "lower_bound",
) -> Tuple[int, int]:
    """(new_width, new_height) per the reference's Resize.get_size
    (transforms.py:120-177): lower_bound / upper_bound / minimal."""
    scale_h = out_height / in_height
    scale_w = out_width / in_width

    if keep_aspect_ratio:
        if resize_method == "lower_bound":
            scale_h = scale_w = max(scale_w, scale_h)
        elif resize_method == "upper_bound":
            scale_h = scale_w = min(scale_w, scale_h)
        elif resize_method == "minimal":
            if abs(1 - scale_w) < abs(1 - scale_h):
                scale_h = scale_w
            else:
                scale_w = scale_h
        else:
            raise ValueError(f"resize_method {resize_method!r} not implemented")

    if resize_method == "lower_bound":
        new_h = _constrain_to_multiple_of(
            scale_h * in_height, ensure_multiple_of, min_val=out_height
        )
        new_w = _constrain_to_multiple_of(
            scale_w * in_width, ensure_multiple_of, min_val=out_width
        )
    elif resize_method == "upper_bound":
        new_h = _constrain_to_multiple_of(
            scale_h * in_height, ensure_multiple_of, max_val=out_height
        )
        new_w = _constrain_to_multiple_of(
            scale_w * in_width, ensure_multiple_of, max_val=out_width
        )
    elif resize_method == "minimal":
        new_h = _constrain_to_multiple_of(scale_h * in_height, ensure_multiple_of)
        new_w = _constrain_to_multiple_of(scale_w * in_width, ensure_multiple_of)
    else:
        raise ValueError(f"resize_method {resize_method!r} not implemented")

    return new_w, new_h


class Resize:
    """Resize sample dict (image [+ disparity/depth/mask]) on host."""

    def __init__(
        self,
        width: int,
        height: int,
        resize_target: bool = True,
        keep_aspect_ratio: bool = False,
        ensure_multiple_of: int = 1,
        resize_method: str = "lower_bound",
        image_interpolation_method: Optional[int] = None,
    ) -> None:
        self.width = width
        self.height = height
        self.resize_target = resize_target
        self.keep_aspect_ratio = keep_aspect_ratio
        self.multiple_of = ensure_multiple_of
        self.resize_method = resize_method
        self.interp = (
            image_interpolation_method
            if image_interpolation_method is not None
            else io.INTER_CUBIC
        )

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        h, w = sample["image"].shape[:2]
        new_w, new_h = compute_resize_shape(
            w,
            h,
            self.width,
            self.height,
            self.keep_aspect_ratio,
            self.multiple_of,
            self.resize_method,
        )
        sample["image"] = io.resize(
            sample["image"], (new_w, new_h), interpolation=self.interp
        )
        if self.resize_target:
            for key in ("disparity", "depth"):
                if key in sample:
                    sample[key] = io.resize(
                        sample[key], (new_w, new_h), interpolation=io.INTER_NEAREST
                    )
            if "mask" in sample:
                sample["mask"] = io.resize(
                    sample["mask"].astype(np.float32),
                    (new_w, new_h),
                    interpolation=io.INTER_NEAREST,
                ).astype(bool)
        return sample


class NormalizeImage:
    def __init__(self, mean, std) -> None:
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample):
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class PrepareForNet:
    """HWC -> CHW float32 contiguous (reference transforms.py:229-251)."""

    def __call__(self, sample):
        sample["image"] = np.ascontiguousarray(
            np.transpose(sample["image"], (2, 0, 1))
        ).astype(np.float32)
        for key in ("mask", "disparity", "depth"):
            if key in sample:
                sample[key] = np.ascontiguousarray(
                    sample[key].astype(np.float32)
                )
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def load_transforms(
    model_type: str = "dpt_large_384", height: int = 0, square: bool = False
) -> Tuple[Compose, int, int]:
    """Preprocessing pipeline per model type (reference loader.py:141-272).

    All model types normalize with mean=std=0.5 and resize with the
    "minimal" method; swin/levit families additionally force exact square
    network input (keep_aspect_ratio=False).
    """
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type {model_type!r} not implemented")
    _, net_w, net_h = MODEL_TYPES[model_type]
    fixed_size_families = ("swin", "levit", "test")
    keep_aspect_ratio = not square and not any(
        f in model_type for f in fixed_size_families
    )
    if height != 0:
        net_w = net_h = height

    transform = Compose(
        [
            Resize(
                net_w,
                net_h,
                resize_target=None,
                keep_aspect_ratio=keep_aspect_ratio,
                ensure_multiple_of=32,
                resize_method="minimal",
            ),
            NormalizeImage(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
            PrepareForNet(),
        ]
    )
    return transform, net_w, net_h




def device_preprocess(
    image_u8: torch.Tensor,
    net_size: Tuple[int, int],
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalized (B, 3, net_h, net_w) in ``dtype``.

    ``/255``, then ``(x - 0.5) / 0.5``, then a non-antialiased bicubic
    resize to net size, then NCHW: the JAX package's
    ``data/transforms.py::device_preprocess``.
    """
    dtype = dtype or torch.float32
    net_w, net_h = net_size
    x = image_u8.to(dtype) / 255.0
    x = (x - 0.5) / 0.5
    x = resize_hw(x, (net_h, net_w), "bicubic", align_corners=False)
    return x.permute(0, 3, 1, 2)
