"""Bengaluru Driving Dataset (BDD) on-disk contract + dataset views.

Directory contract (reference bdd_helper.py:60-124): per-sequence folder
``<seq>/{rgb_img,depth_img,seg_img}/<timestamp>.png`` plus
``<seq>/<seq>.csv`` (column 1 = timestamp ms) and a YAML camera calib.
Samples come back as plain numpy dicts; batching is done by
``data.loader`` (replacing the reference's manual ``get_batch`` concat,
utils/__init__.py:768-780).

Colors: 3 classes — background/vehicle/pedestrian
(reference bengaluru_driving_dataset.py:59-64).

The port of ``soccdpt_tpu/data/bdd.py``: the same samples, read through
``image_io`` (PNG, resizes, CSV) instead of ``cv2`` and ``pandas``, with
the host library of ``soccdpt_torch/native.py``. The trajectory file, when
a sequence has one, is a dict of columns: ``Timestamp`` an int64 array,
``rot`` a list of (3, 3) float32 matrices, any other column its strings.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..core.config import GT_OCCUPANCY, CameraConfig, OccupancyConfig
from ..ops.geometry import rotation_matrix
from . import image_io as io

color_2_class = {
    (0, 0, 0): 0,  # background
    (0, 0, 142): 1,  # vehicle
    (220, 20, 60): 2,  # pedestrian
}
class_2_color = {v: k for k, v in color_2_class.items()}
NUM_CLASSES = 3

# The six sequences the reference trains on
# (bengaluru_driving_dataset.py:172-207).
DEFAULT_SEQUENCES = (
    "1653972957447",
    "1652937970859",
    "1654493684259",
    "1654507149598",
    "1658384707877",
    "1658384924059",
)

DATASET_BASE = "~/Datasets/Depth_Dataset_Bengaluru"
DEFAULT_CALIB = os.path.join(DATASET_BASE, "calibration/pocoX3/calib.yaml")


_COLOR_TABLE = np.asarray(
    [class_2_color[c] for c in range(NUM_CLASSES)], np.uint8
)


def rgb_seg_to_bool(seg_frame: np.ndarray) -> np.ndarray:
    """RGB seg image -> boolean (H, W, 3) class masks
    (reference bengaluru_driving_dataset.py:67-76). Uses the C++
    host library when it is built (soccdpt_torch.native)."""
    return native.rgb_to_bool_masks(seg_frame, _COLOR_TABLE)


def rgb_seg_to_class(seg_frame: np.ndarray) -> np.ndarray:
    """RGB seg image -> integer class map (reference bdd_helper.py:10-25)."""
    return native.rgb_to_class(seg_frame, _COLOR_TABLE)


def parse_rot(rot: str) -> np.ndarray:
    """Parse a '[r r r ...]' rotation-matrix string from the trajectory
    CSV (reference bdd_helper.py:46-50)."""
    rot = rot.replace("[", "").replace("]", "").replace("\n", "")
    return np.asarray(rot.split(), np.float32).reshape(3, 3)


class BDDSequence:
    """Iterator over one sequence folder (reference
    BengaluruDepthDatasetIterator, bdd_helper.py:60-192)."""

    def __init__(
        self,
        dataset_path: str,
        settings_doc: str = DEFAULT_CALIB,
        file_extension: str = ".png",
    ) -> None:
        self.dataset_path = os.path.expanduser(dataset_path)
        self.dataset_id = os.path.basename(self.dataset_path.rstrip("/"))
        self.rgb_dir = os.path.join(self.dataset_path, "rgb_img")
        self.depth_dir = os.path.join(self.dataset_path, "depth_img")
        self.seg_dir = os.path.join(self.dataset_path, "seg_img")
        self.file_extension = file_extension

        csv_path = os.path.join(self.dataset_path, self.dataset_id + ".csv")
        # column 1 is the timestamp in ms (the reference reads row.iloc[1])
        self.timestamps = io.read_csv_column(csv_path, 1)
        self.camera = CameraConfig.from_yaml(settings_doc)

        # optional trajectory CSV with per-row 3x3 rotation matrices
        # (reference bdd_helper.py:75-77,120-124)
        traj_path = os.path.join(
            self.dataset_path, self.dataset_id + "_traj.csv"
        )
        self.traj = None
        if os.path.isfile(traj_path):
            self.traj = io.read_csv_columns(traj_path)
            if "Timestamp" in self.traj:
                self.traj["Timestamp"] = np.asarray(
                    [int(float(t)) for t in self.traj["Timestamp"]], np.int64
                )
            if "rot" in self.traj:
                self.traj["rot"] = [parse_rot(r) for r in self.traj["rot"]]

    def __len__(self) -> int:
        return len(self.timestamps)

    def traj_between(self, start_ts: int, end_ts: int):
        """Trajectory rows between two timestamps (reference
        get_item_between_timestamp, bdd_helper.py:28-43)."""
        if self.traj is None:
            return None
        keep = np.flatnonzero(
            (self.traj["Timestamp"] >= start_ts) & (self.traj["Timestamp"] <= end_ts)
        )
        return {
            k: v[keep] if isinstance(v, np.ndarray) else [v[i] for i in keep]
            for k, v in self.traj.items()
        }

    def __getitem__(self, key: int) -> Dict[str, np.ndarray]:
        ts = str(int(float(self.timestamps[key])))
        rgb = io.imread(os.path.join(self.rgb_dir, ts + self.file_extension))
        # The reference loads via PIL (RGB) then calls cv2 BGR2RGB,
        # net-effect channel swap; imread gives BGR directly, so the
        # loaded array matches the reference's "rgb_frame" values.
        seg = io.imread(os.path.join(self.seg_dir, ts + self.file_extension))
        disparity = np.asarray(
            io.imread(
                os.path.join(self.depth_dir, ts + self.file_extension),
                io.IMREAD_UNCHANGED,
            )
        )
        if disparity.ndim == 3:
            disparity = disparity[..., 0]
        return {
            "rgb_frame": rgb,
            "seg_frame": seg,
            "disparity_frame": disparity,
            "timestamp": ts,
        }


class BDDDepthSegmentation:
    """Joint depth+seg view, the training dataset
    (reference BDD_Depth_Segmentation, bengaluru_driving_dataset.py:104-137):
    frames resized to 1920x1080, image transformed for the net, boolean
    seg masks, all-ones loss masks."""

    def __init__(
        self,
        dataset_path: str,
        settings_doc: str = DEFAULT_CALIB,
        transform: Optional[Callable] = None,
        target_size: Tuple[int, int] = (1920, 1080),
    ) -> None:
        self.seq = BDDSequence(dataset_path, settings_doc)
        self.transform = transform if transform is not None else (lambda s: s)
        self.target_size = target_size

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        frame = self.seq[index]
        rgb = io.resize(frame["rgb_frame"], self.target_size)
        seg = io.resize(frame["seg_frame"], self.target_size)
        disparity = io.resize(
            frame["disparity_frame"].astype(np.float32), self.target_size
        )
        seg_bool = rgb_seg_to_bool(seg)

        x = self.transform({"image": rgb.astype(np.float32)})["image"]
        return {
            "image": x,  # (3, net_h, net_w) float32
            "image_raw": rgb,  # (H, W, 3) uint8
            "disparity": disparity.astype(np.float32),  # (H, W)
            "mask_disp": np.ones_like(disparity, bool),
            "seg": seg_bool.transpose(2, 0, 1).astype(np.float32),  # (C, H, W)
            "mask_seg": np.ones((NUM_CLASSES, *disparity.shape), bool),
        }


class BDDDepth(BDDDepthSegmentation):
    """Depth-only view (reference BDD_Depth)."""

    def __getitem__(self, index):
        s = super().__getitem__(index)
        return {k: s[k] for k in ("image", "image_raw", "mask_disp", "disparity")}


class BDDSegmentation(BDDDepthSegmentation):
    """Seg-only view (reference BDD_Segmentation)."""

    def __getitem__(self, index):
        s = super().__getitem__(index)
        return {k: s[k] for k in ("image", "image_raw", "mask_seg", "seg")}


# ---------------------------------------------------------------------------
# GT occupancy pipeline (reference OccupancyProcessor, bdd_helper.py:238-542)
# ---------------------------------------------------------------------------


class OccupancyProcessor:
    """Host-side GT occupancy from disparity + RGB segmentation."""

    def __init__(
        self,
        camera: CameraConfig,
        occ: OccupancyConfig = GT_OCCUPANCY,
        point_count_threshold: int = 10,
        baseline: float = 1.0e-2,
    ) -> None:
        self.camera = camera
        self.occ = occ
        self.threshold = point_count_threshold
        self.baseline = baseline
        self.focal_length = (camera.fx + camera.fy) / 2.0

    def depth_from_disparity(self, disparity: np.ndarray) -> np.ndarray:
        """depth = baseline * f / disparity, top image half masked out
        (reference bdd_helper.py:447-455)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = self.baseline * self.focal_length / disparity.astype(np.float32)
        depth[: depth.shape[0] // 2, :] = 0.0  # hide sky/upper half
        depth[~np.isfinite(depth)] = 0.0
        return depth

    def voxelize(
        self, points: np.ndarray, semantics: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """Vectorized voxelization + threshold (semantics of reference
        transform_points_to_occupancy_grid_vect, bdd_helper.py:289-362);
        scatter runs in the C++ host library when it is built."""
        shape_m = np.asarray(self.occ.occupancy_shape, np.float32)
        grid = native.voxelize_points(
            points,
            semantics,
            tuple(self.occ.occupancy_shape),
            tuple(self.occ.grid_size),
            NUM_CLASSES,
        )

        occupied = grid > self.threshold
        idx = np.argwhere(grid >= self.threshold)
        pts_out = (
            idx[:, :3] / np.asarray(self.occ.grid_size) * shape_m
        ).astype(np.float32)
        occ_points = np.concatenate(
            [pts_out, idx[:, 3:4].astype(np.float32)], axis=1
        )
        return {"occupancy_grid": occupied, "occupancy_points": occ_points}

    def process_frame(self, frame: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """reference bdd_helper.py:433-542 (with the GT rotation
        convention, points @ R.T)."""
        cam = self.camera
        disparity = frame["disparity_frame"].astype(np.float32)
        seg_rgb = np.ascontiguousarray(frame["seg_frame"][..., ::-1])  # BGR -> RGB
        sem_class = rgb_seg_to_class(seg_rgb).reshape(-1)

        depth = self.depth_from_disparity(disparity)
        u = np.arange(cam.height)[:, None]
        v = np.arange(cam.width)[None, :]
        x = (v - cam.cx) * depth / cam.fx
        y = (u - cam.cy) * depth / cam.fy
        points = np.stack([x.ravel(), y.ravel(), depth.ravel()], axis=1)

        points = points * np.asarray(self.occ.pc_scale) + np.asarray(
            self.occ.pc_shift
        )
        rot = rotation_matrix(self.occ.correction_angle, transpose=True)
        points = points @ rot

        data = self.voxelize(points.astype(np.float32), sem_class)

        # Map occupancy points back into the camera frame (undo rotation,
        # shift, scale — reference bdd_helper.py:500-528).
        op = data["occupancy_points"]
        inv_rot = rotation_matrix(
            tuple(-a for a in self.occ.correction_angle), transpose=True
        )
        op[:, :3] = op[:, :3] @ inv_rot
        op[:, :3] = (op[:, :3] - np.asarray(self.occ.pc_shift)) / np.asarray(
            self.occ.pc_scale
        )
        op[:, :3] = op[:, :3] @ rot

        out = dict(frame)
        out.update(
            depth=depth,
            points=points,
            occupancy_grid=data["occupancy_grid"],
            occupancy_points=op,
        )
        return out


class BDDOccupancy:
    """GT-occupancy training view (reference BDD_Occupancy_Dataset,
    bengaluru_driving_dataset.py:140-169)."""

    def __init__(
        self,
        dataset_path: str,
        settings_doc: str = DEFAULT_CALIB,
        transform: Optional[Callable] = None,
        occ: OccupancyConfig = GT_OCCUPANCY,
        target_size: Tuple[int, int] = (1920, 1080),
    ) -> None:
        self.seq = BDDSequence(dataset_path, settings_doc)
        self.proc = OccupancyProcessor(self.seq.camera, occ)
        self.transform = transform if transform is not None else (lambda s: s)
        self.target_size = target_size

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        frame = self.proc.process_frame(self.seq[index])
        rgb = io.resize(frame["rgb_frame"], self.target_size)
        x = self.transform({"image": rgb.astype(np.float32)})["image"]
        grid = frame["occupancy_grid"].astype(np.float32)
        return {
            "image": x,
            "image_raw": rgb,
            "occupancy_grid": grid,
            "mask_occ": np.ones_like(grid, bool),
        }


class ConcatDataset:
    """Datasets one after another, indexed as one."""

    def __init__(self, datasets: Sequence) -> None:
        self.datasets = list(datasets)
        self.offsets: List[int] = []
        total = 0
        for d in self.datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, index: int):
        if index < 0:
            index += self.total
        for ds, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if index >= off:
                return ds[index - off]
        raise IndexError(index)


def discover_sequences(base_path: str) -> Tuple[str, ...]:
    """Any directory under base_path with an ``rgb_img/`` subfolder."""
    import glob as _glob

    found = sorted(
        os.path.basename(os.path.dirname(p.rstrip("/")))
        for p in _glob.glob(os.path.join(base_path, "*", "rgb_img/"))
    )
    return tuple(found)


def get_bdd_dataset(
    dataset_cls,
    transform: Callable,
    base_path: str,
    sequences: Optional[Sequence[str]] = None,
    settings_doc: Optional[str] = None,
    dataset_kwargs: Optional[dict] = None,
) -> ConcatDataset:
    """Concat the training sequences (reference hardcodes six,
    bengaluru_driving_dataset.py:172-207; here the reference list is the
    default with directory discovery as fallback)."""
    base_path = os.path.expanduser(base_path)
    if sequences is None:
        if all(
            os.path.isdir(os.path.join(base_path, s)) for s in DEFAULT_SEQUENCES
        ):
            sequences = DEFAULT_SEQUENCES
        else:
            sequences = discover_sequences(base_path)
            if not sequences:
                raise FileNotFoundError(
                    f"no BDD sequences found under {base_path}"
                )
    if settings_doc is None:
        settings_doc = os.path.join(base_path, "calibration/pocoX3/calib.yaml")
        if not os.path.isfile(settings_doc):
            settings_doc = DEFAULT_CALIB
    return ConcatDataset(
        [
            dataset_cls(
                dataset_path=os.path.join(base_path, seq),
                settings_doc=settings_doc,
                transform=transform,
                **(dataset_kwargs or {}),
            )
            for seq in sequences
        ]
    )
