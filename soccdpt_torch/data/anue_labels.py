"""AutoNUE / IDD label taxonomy and the IDD on-disk dataset contract.

The port's copy of ``soccdpt_tpu/data/anue_labels.py``, the same table
and maps; ``IDDFolder`` reads and resizes through ``image_io`` instead of
``cv2``.

The taxonomy is public data from the AutoNUE benchmark (the reference
carries it as 40 ``Label`` namedtuples, anue_labels.py:43-569); here it
is stored as a compact table of the fields this framework actually uses,
with every derived class map computed from it (reference
anue_labels.py:571-731).

Dataset contract (reference anue_labels.py:770-862): parallel trees
``leftImg8bit/<split>/<seq>/*_leftImg8bit.png``,
``gtFine/<split>/<seq>/*_gtFine_label{level}.png`` (grayscale ids), and
``depth/<split>/<seq>/*_leftImg8bit.png``.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class Label(NamedTuple):
    name: str
    id: int
    level4Id: int
    level3Id: int
    level2IdName: str
    level1Id: int
    color: Tuple[int, int, int]


# (name, id, level4Id, level3Id, level2IdName, level1Id, color)
LABELS: List[Label] = [
    Label("road", 0, 0, 0, "drivable", 0, (128, 64, 128)),
    Label("parking", 1, 1, 1, "drivable", 0, (250, 170, 160)),
    Label("drivable fallback", 2, 2, 1, "drivable", 0, (81, 0, 81)),
    Label("sidewalk", 3, 3, 2, "non-drivable", 1, (244, 35, 232)),
    Label("rail track", 4, 3, 3, "non-drivable", 1, (230, 150, 140)),
    Label("non-drivable fallback", 5, 4, 3, "non-drivable", 1, (152, 251, 152)),
    Label("person", 6, 5, 4, "living-thing", 2, (220, 20, 60)),
    Label("animal", 7, 6, 4, "living-thing", 2, (246, 198, 145)),
    Label("rider", 8, 7, 5, "living-thing", 2, (255, 0, 0)),
    Label("motorcycle", 9, 8, 6, "2-wheeler", 3, (0, 0, 230)),
    Label("bicycle", 10, 9, 7, "2-wheeler", 3, (119, 11, 32)),
    Label("autorickshaw", 11, 10, 8, "autorickshaw", 3, (255, 204, 54)),
    Label("car", 12, 11, 9, "car", 3, (0, 0, 142)),
    Label("truck", 13, 12, 10, "large-vehicle", 3, (0, 0, 70)),
    Label("bus", 14, 13, 11, "large-vehicle", 3, (0, 60, 100)),
    Label("caravan", 15, 14, 12, "large-vehicle", 3, (0, 0, 90)),
    Label("trailer", 16, 15, 12, "large-vehicle", 3, (0, 0, 110)),
    Label("train", 17, 15, 12, "large-vehicle", 3, (0, 80, 100)),
    Label("vehicle fallback", 18, 15, 12, "large-vehicle", 3, (136, 143, 153)),
    Label("curb", 19, 16, 13, "barrier", 4, (220, 190, 40)),
    Label("wall", 20, 17, 14, "barrier", 4, (102, 102, 156)),
    Label("fence", 21, 18, 15, "barrier", 4, (190, 153, 153)),
    Label("guard rail", 22, 19, 16, "barrier", 4, (180, 165, 180)),
    Label("billboard", 23, 20, 17, "structures", 4, (174, 64, 67)),
    Label("traffic sign", 24, 21, 18, "structures", 4, (220, 220, 0)),
    Label("traffic light", 25, 22, 19, "structures", 4, (250, 170, 30)),
    Label("pole", 26, 23, 20, "structures", 4, (153, 153, 153)),
    Label("polegroup", 27, 23, 20, "structures", 4, (153, 153, 153)),
    Label("obs-str-bar-fallback", 28, 24, 21, "structures", 4, (169, 187, 214)),
    Label("building", 29, 25, 22, "construction", 5, (70, 70, 70)),
    Label("bridge", 30, 26, 23, "construction", 5, (150, 100, 100)),
    Label("tunnel", 31, 26, 23, "construction", 5, (150, 120, 90)),
    Label("vegetation", 32, 27, 24, "vegetation", 5, (107, 142, 35)),
    Label("sky", 33, 28, 25, "sky", 6, (70, 130, 180)),
    Label("fallback background", 34, 29, 25, "object fallback", 6, (169, 187, 214)),
    Label("unlabeled", 35, 255, 255, "void", 255, (0, 0, 0)),
    Label("ego vehicle", 36, 255, 255, "void", 255, (0, 0, 0)),
    Label("rectification border", 37, 255, 255, "void", 255, (0, 0, 0)),
    Label("out of roi", 38, 255, 255, "void", 255, (0, 0, 0)),
    Label("license plate", 39, 255, 255, "vehicle", 255, (0, 0, 142)),
]

name2label = {l.name: l for l in LABELS}
id2label = {l.id: l for l in LABELS}

# ---------------------------------------------------------------------------
# Derived class maps (reference anue_labels.py:571-731)
# ---------------------------------------------------------------------------

LEVEL1_ID = "level1Ids"
LEVEL3_ID = "level3Ids"
LEVEL4_ID = "level4Ids"
LEVEL4_BASICS_ID = "level4Ids"

level1_to_class: Dict[int, int] = {**{i: i for i in range(7)}, 255: 7}
level3_to_class: Dict[int, int] = {**{i: i for i in range(26)}, 255: 26}

level1_to_color = {
    0: (127, 127, 127),
    1: (0, 0, 0),
    2: (255, 0, 0),
    3: (10, 10, 255),
    4: (80, 80, 80),
    5: (0, 255, 0),
    6: (10, 10, 0),
    7: (0, 0, 255),
}

level3_to_color = {
    level3_to_class[l.level3Id]: l.color for l in LABELS
}

# Training map used by the flagship configs (reference
# anue_labels.py:704-722): 0=drivable, 1=vehicle, 2=living.
_L4_GROUPS = {
    "drivable": 0,
    "2-wheeler": 1,
    "autorickshaw": 1,
    "car": 1,
    "large-vehicle": 1,
    "vehicle": 1,
    "living-thing": 2,
}
level4_basics_to_class: Dict[int, int] = {}
for _l in LABELS:
    if _l.level2IdName in _L4_GROUPS:
        level4_basics_to_class[_l.level4Id] = _L4_GROUPS[_l.level2IdName]

level4_basics_to_color = {
    0: (244, 35, 232),
    1: (0, 0, 142),
    2: (220, 20, 60),
    3: (128, 64, 128),
    4: (0, 255, 255),
}

# Drivable/non-drivable split (reference anue_labels.py:616-627)
level1_road_to_class = {
    l.level1Id: (0 if l.level2IdName == "drivable" else 1)
    for l in LABELS
    if l.level2IdName in ("drivable", "non-drivable")
}
level1_road_to_color = {0: (128, 64, 128), 1: (244, 35, 232)}

level4_road_to_class = {i: i for i in range(5)}
level4_road_to_color = {
    0: (128, 64, 128),
    1: (250, 170, 160),
    2: (81, 0, 81),
    3: (244, 35, 232),
    4: (152, 251, 152),
}


def seg_ids_to_bool(
    id_map: np.ndarray, level_2_class: Dict[int, int]
) -> np.ndarray:
    """Grayscale label-id map (H, W) -> boolean (H, W, num_classes)."""
    num_classes = len(set(level_2_class.values()))
    out = np.zeros((*id_map.shape, num_classes), dtype=bool)
    for level_id, cls in level_2_class.items():
        out[..., cls] |= id_map == level_id
    return out


def color_mask(seg_map: np.ndarray, color_map=level1_to_color) -> np.ndarray:
    """Boolean (H, W, C) masks -> RGB visualization."""
    img = np.zeros((*seg_map.shape[:2], 3), np.uint8)
    for cls, color in color_map.items():
        if cls < seg_map.shape[2]:
            img[seg_map[..., cls]] = color
    return img


# ---------------------------------------------------------------------------
# On-disk dataset (reference anue_labels.py:770-862)
# ---------------------------------------------------------------------------

IDD_DATASET_PATH = os.path.expanduser("~/Datasets/IDD_Segmentation/")


class IDDFolder:
    """One (leftImg8bit, gtFine, depth) folder triple.

    ``__getitem__`` returns (rgb (H,W,3) uint8, seg_bool (H,W,C),
    depth (H,W) uint8), all resized to ``target_size`` (the reference
    hardcodes 1920x1080, anue_labels.py:847-849).
    """

    def __init__(
        self,
        leftImg8bit_path: str,
        gtFine_path: str,
        depth_path: str,
        level_id: str = LEVEL1_ID,
        level_2_class: Dict[int, int] = level1_to_class,
        target_size: Tuple[int, int] = (1920, 1080),
    ) -> None:
        self.level_id = level_id
        self.level_2_class = level_2_class
        self.num_classes = len(set(level_2_class.values()))
        self.target_size = target_size

        for p in (leftImg8bit_path, gtFine_path, depth_path):
            if not os.path.isdir(p):
                raise FileNotFoundError(f"not a directory: {p}")

        stems = sorted(
            os.path.basename(f)[: -len("_leftImg8bit.png")]
            for f in glob.glob(os.path.join(leftImg8bit_path, "*_leftImg8bit.png"))
        )
        self.rgb_files = [
            os.path.join(leftImg8bit_path, s + "_leftImg8bit.png") for s in stems
        ]
        self.seg_files = [
            os.path.join(gtFine_path, f"{s}_gtFine_label{level_id}.png")
            for s in stems
        ]
        self.depth_files = [
            os.path.join(depth_path, s + "_leftImg8bit.png") for s in stems
        ]
        for f in self.seg_files + self.depth_files:
            if not os.path.isfile(f):
                raise FileNotFoundError(f)

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, index: int):
        from . import image_io as io

        rgb = io.imread(self.rgb_files[index])
        seg_ids = io.imread(self.seg_files[index], io.IMREAD_GRAYSCALE)
        depth = io.imread(self.depth_files[index])
        if depth.ndim == 3:
            depth = io.bgr_to_gray(depth)

        rgb = io.resize(rgb, self.target_size)
        seg_ids = io.resize(seg_ids, self.target_size, interpolation=io.INTER_NEAREST)
        depth = io.resize(depth, self.target_size)

        seg_bool = seg_ids_to_bool(seg_ids, self.level_2_class)
        return rgb, seg_bool, depth


def get_train_val_test_folders(dataset_path: str = IDD_DATASET_PATH):
    """Sequence-folder discovery (reference anue_labels.py:875-891)."""
    if not os.path.isdir(dataset_path):
        raise FileNotFoundError(dataset_path)

    def _ls(split):
        fs = glob.glob(os.path.join(dataset_path, "leftImg8bit", split, "*"))
        return sorted(os.path.basename(f) for f in fs)

    return _ls("train"), _ls("val"), _ls("test")
