"""Indian Driving Dataset (IDD) views (reference datasets/idd.py).

Samples are numpy dicts in the same convention as data.bdd. Depth GT for
IDD is the 8-bit "boosted depth" disparity image (reference idd.py:118).

The port of ``soccdpt_tpu/data/idd.py``: the same code, whose relative
imports find the port's ``anue_labels`` and ``bdd``.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .anue_labels import (
    IDD_DATASET_PATH,
    IDDFolder,
    LEVEL1_ID,
    get_train_val_test_folders,
    level1_to_class,
)
from .bdd import ConcatDataset


class IDDDepthSegmentation:
    """Joint depth+seg view (reference IDD_Depth_Segmentation,
    idd.py:72-122)."""

    def __init__(
        self,
        leftImg8bit_path: str,
        gtFine_path: str,
        depth_path: str,
        level_id: str = LEVEL1_ID,
        level_2_class: Dict[int, int] = level1_to_class,
        transform: Optional[Callable] = None,
    ) -> None:
        self.idd = IDDFolder(
            leftImg8bit_path, gtFine_path, depth_path, level_id, level_2_class
        )
        self.transform = transform if transform is not None else (lambda s: s)
        self.num_classes = self.idd.num_classes

    def __len__(self) -> int:
        return len(self.idd)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rgb, seg_bool, depth = self.idd[index]
        x = self.transform({"image": rgb.astype(np.float32)})["image"]
        depth = depth.astype(np.float32)
        return {
            "image": x,
            "image_raw": rgb,
            "disparity": depth,
            "mask_disp": np.ones_like(depth, bool),
            "seg": seg_bool.transpose(2, 0, 1).astype(np.float32),
            "mask_seg": np.ones((self.num_classes, *depth.shape), bool),
        }


class IDDSegmentation(IDDDepthSegmentation):
    """Seg-only view (reference IDD_Segmentation, idd.py:23-69)."""

    def __getitem__(self, index):
        s = super().__getitem__(index)
        return {k: s[k] for k in ("image", "image_raw", "mask_seg", "seg")}


def get_all_idd_datasets(
    transform: Callable,
    dataset_cls=IDDDepthSegmentation,
    level_id: str = LEVEL1_ID,
    level_2_class: Dict[int, int] = level1_to_class,
    idd_dataset_path: str = IDD_DATASET_PATH,
) -> Tuple[ConcatDataset, ConcatDataset]:
    """Discover train/val sequence folders and build concat datasets
    (reference get_all_IDD_datasets, idd.py:151-206)."""
    train_folders, val_folders, _ = get_train_val_test_folders(idd_dataset_path)

    def build(split, folders):
        return ConcatDataset(
            [
                dataset_cls(
                    leftImg8bit_path=os.path.join(
                        idd_dataset_path, "leftImg8bit", split, f
                    ),
                    gtFine_path=os.path.join(idd_dataset_path, "gtFine", split, f),
                    depth_path=os.path.join(idd_dataset_path, "depth", split, f),
                    level_id=level_id,
                    level_2_class=level_2_class,
                    transform=transform,
                )
                for f in folders
            ]
        )

    return build("train", train_folders), build("val", val_folders)


def get_all_IDD_Depth_Segmentation_datasets(
    transform, level_id=LEVEL1_ID, level_2_class=level1_to_class,
    idd_dataset_path=IDD_DATASET_PATH,
):
    return get_all_idd_datasets(
        transform, IDDDepthSegmentation, level_id, level_2_class, idd_dataset_path
    )


def get_all_IDD_Segmentation_datasets(
    transform, level_id=LEVEL1_ID, level_2_class=level1_to_class,
    idd_dataset_path=IDD_DATASET_PATH,
):
    return get_all_idd_datasets(
        transform, IDDSegmentation, level_id, level_2_class, idd_dataset_path
    )
