"""Configuration dataclasses: camera, occupancy grid, model and training,
and the reference's sweep files.

The port's own copy of ``soccdpt_tpu/core/config.py``'s ``CameraConfig``,
``OccupancyConfig``, ``GT_OCCUPANCY``, ``MODEL_TYPES``, ``ModelConfig``,
``TrainConfig``, ``SweepConfig`` and ``train_config_from_params``, so the
port never imports the JAX package. Field names and defaults are the same,
so a config built for one package reads the same in the other.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

_CAMERA_KEYS = ("fx", "fy", "cx", "cy", "width", "height", "k1", "k2", "p1", "p2", "k3")


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics (reference calib.yaml keys)."""

    fx: float = 1000.0
    fy: float = 1000.0
    cx: float = 960.0
    cy: float = 540.0
    width: int = 1920
    height: int = 1080
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @classmethod
    def from_yaml(cls, path: str) -> "CameraConfig":
        """Read a calib file of flat ``Camera.<key>: value`` lines: what
        ``to_yaml`` (and the JAX package's, through PyYAML) writes, and the
        reference's OpenCV ``%YAML:1.0`` files. ``fx``, ``fy``, ``cx``,
        ``cy``, ``width`` and ``height`` are required, the distortion terms
        default to 0. No PyYAML: a line is ``key: scalar``, a ``#`` starts
        a comment, and directives (``%``) and document markers are
        skipped."""
        cam = {}
        with open(os.path.expanduser(path)) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or line.startswith("%") or line in ("---", "..."):
                    continue
                key, sep, value = line.partition(":")
                if not sep:
                    raise ValueError(f"{path}: not a 'key: value' line: {line!r}")
                cam[key.strip()] = value.strip().strip("'\"")

        def get(key, cast, default=None):
            if f"Camera.{key}" not in cam:
                if default is None:
                    raise KeyError(f"{path} has no Camera.{key}")
                return default
            return cast(float(cam[f"Camera.{key}"]))

        return cls(**{k: get(k, int) if k in ("width", "height") else
                      get(k, float, None if k in ("fx", "fy", "cx", "cy") else 0.0)
                      for k in _CAMERA_KEYS})

    def to_yaml(self, path: str) -> None:
        """Write the calib as PyYAML's ``safe_dump`` writes the JAX
        package's: one ``Camera.<key>: value`` line a key, keys sorted."""
        with open(path, "w") as fh:
            for key in sorted(f"Camera.{k}" for k in _CAMERA_KEYS):
                fh.write(f"{key}: {_yaml_scalar(getattr(self, key[7:]))}\n")


def _yaml_scalar(value) -> str:
    """A number as PyYAML writes it: ints plainly, floats by ``repr`` with a
    ``.0`` before a bare exponent (``1.0e-05``), so YAML 1.1 reads them
    back as floats."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise TypeError(f"not a number: {value!r}")
    if isinstance(value, int):
        return str(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


@dataclass(frozen=True)
class OccupancyConfig:
    grid_size: Tuple[int, int, int] = (256, 256, 32)
    scale: Tuple[float, float, float] = (2.0, 2.0, 0.666)  # voxels / meter
    shift: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # meters
    pc_scale: Tuple[float, float, float] = (10000.0, 50000.0, 800.0)
    pc_shift: Tuple[float, float, float] = (55.0, -20.0, 15.0)
    correction_angle: Tuple[float, float, float] = (7.0, 0.0, 0.0)  # degrees

    @property
    def occupancy_shape(self) -> Tuple[float, float, float]:
        """Grid extent in meters."""
        return tuple(g / s for g, s in zip(self.grid_size, self.scale))


# the GT occupancy pipeline's point-cloud scaling, not the model's
GT_OCCUPANCY = OccupancyConfig(
    pc_scale=(500.0, 2500.0, 200.0),
    pc_shift=(100.0, 40.0, 0.0),
)


# model_type -> (backbone name, net_w, net_h)
MODEL_TYPES: Dict[str, Tuple[str, int, int]] = {
    "dpt_beit_large_512": ("beitl16_512", 512, 512),
    "dpt_beit_large_384": ("beitl16_384", 384, 384),
    "dpt_beit_base_384": ("beitb16_384", 384, 384),
    "dpt_swin2_large_384": ("swin2l24_384", 256, 256),
    "dpt_swin2_base_384": ("swin2b24_384", 256, 256),
    "dpt_swin2_tiny_256": ("swin2t16_256", 256, 256),
    "dpt_swin_large_384": ("swinl12_384", 256, 256),
    "dpt_next_vit_large_384": ("next_vit_large_6m", 384, 384),
    "dpt_levit_224": ("levit_384", 224, 224),
    "dpt_large_384": ("vitl16_384", 384, 384),
    "dpt_hybrid_384": ("vitb_rn50_384", 384, 384),
    # Tiny model for fast unit tests on CPU.
    "dpt_swin2_test_64": ("swin2test_64", 64, 64),
}


@dataclass(frozen=True)
class ModelConfig:
    model_type: str = "dpt_swin2_tiny_256"
    version: int = 3  # SOccDPT V1 / V2 / V3
    num_classes: int = 3
    features: int = 256  # DPT fusion width
    head_features_1: Optional[int] = None  # defaults to `features`
    head_features_2: int = 32
    non_negative: bool = True
    sigmoid: bool = True  # seg activation: sigmoid vs scaled-tanh
    use_bn: bool = False  # fusion-block batchnorm
    compute_occ: bool = False
    occupancy_head: bool = False  # real 3D-conv occupancy refiner
    camera: CameraConfig = field(default_factory=CameraConfig)
    occupancy: OccupancyConfig = field(default_factory=OccupancyConfig)
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def backbone(self) -> str:
        return MODEL_TYPES[self.model_type][0]

    @property
    def net_size(self) -> Tuple[int, int]:
        """(width, height) of the network input."""
        _, w, h = MODEL_TYPES[self.model_type]
        return (w, h)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters, with the field names and defaults of the
    JAX package's ``TrainConfig``. Its ``mesh_shape`` and ``mesh_axes`` are
    left out: nothing in either package reads them (the mesh comes from
    ``tp`` and the world size, ``Trainer.default_mesh``), and a sweep that
    sets them loses nothing, since ``train_config_from_params`` ignores
    unknown keys."""

    epochs: int = 15
    batch_size: int = 3
    learning_rate: float = 1e-5
    val_percent: float = 0.05
    save_checkpoint: bool = True
    amp: bool = False  # bf16 compute, f32 master weights, no loss scaling
    weight_decay: float = 0.0
    encoder_percentage: float = 0.5
    patchwise_percentage: float = 1.0
    # "inplace": sequential patch steps, each seeing the last one's update;
    # "snapshot": every patch trained from the same start weights, the
    # updates applied together at the end
    patchwise_mode: str = "inplace"
    loss_weights: Tuple[float, float] = (0.5, 0.5)  # (depth, seg)
    dataset_percentage: float = 1.0
    compute_scale_and_shift: bool = True
    sigmoid: bool = False
    load: Optional[str] = None
    load_depth: Optional[str] = None
    load_seg: Optional[str] = None
    dataset: str = "bdd"
    base_path: str = "~/Datasets/Depth_Dataset_Bengaluru"
    checkpoint_dir: str = "checkpoints"
    project_name: str = "SOccDPT"
    seed: int = 0
    # subsample the GT tensors k-fold per axis on the host before the copy
    # to the device (k^2 fewer bytes); 1 keeps the full-resolution GT
    gt_downscale: int = 1
    # tensor-parallel axis size: the ranks arrange as a (data, model) mesh
    # with model = tp, and Adam's moments and update of the large leaves
    # are sharded over "model" (parallel/sharding.py); 1 = pure data parallel
    tp: int = 1
    # leaves with fewer elements than this stay replicated under tp > 1
    tp_min_size: int = 2**16
    remat_backbone: bool = False  # recompute backbone blocks in the backward
    log_histograms: bool = False  # per-leaf weight stats at eval rounds
    log_visuals: bool = True  # eval-round visualization panels


def dataclass_replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Sweep-JSON interop (reference config/*.json schema)
# ---------------------------------------------------------------------------


@dataclass
class SweepConfig:
    """Parsed reference sweep JSON: ``{"method": "grid"|"random",
    "metric": {...}, "parameters": {name: {"values": [...]}}}``."""

    method: str
    metric: Dict[str, Any]
    parameters: Dict[str, List[Any]]

    @classmethod
    def load(cls, path: str) -> "SweepConfig":
        with open(path, "r") as fh:
            raw = json.load(fh)
        params = {}
        for name, spec in raw.get("parameters", {}).items():
            if isinstance(spec, dict) and "values" in spec:
                params[name] = list(spec["values"])
            elif isinstance(spec, dict) and "value" in spec:
                params[name] = [spec["value"]]
            else:
                params[name] = [spec]
        return cls(
            method=raw.get("method", "grid"),
            metric=raw.get("metric", {}),
            parameters=params,
        )

    def override(self, **kw) -> None:
        for name, value in kw.items():
            self.parameters[name] = [value]

    def trials(self, count: Optional[int] = None, seed: int = 0) -> Iterator[Dict[str, Any]]:
        """Yield flat hyperparameter dicts: full cartesian product for
        ``grid``, independent uniform draws for ``random``."""
        names = sorted(self.parameters)
        if self.method == "random":
            rng = random.Random(seed)
            n = count if count is not None else 1
            for _ in range(n):
                yield {k: rng.choice(self.parameters[k]) for k in names}
        else:
            combos = itertools.product(*(self.parameters[k] for k in names))
            for i, combo in enumerate(combos):
                if count is not None and i >= count:
                    return
                yield dict(zip(names, combo))


def train_config_from_params(params: Dict[str, Any]) -> TrainConfig:
    """Build a TrainConfig from a sweep-trial dict, ignoring unknown keys."""
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    kw: Dict[str, Any] = {}
    for k, v in params.items():
        if k not in known:
            continue
        if k == "loss_weights":
            kw[k] = tuple(float(x) for x in v)
        elif k in ("load", "load_depth", "load_seg") and isinstance(v, bool):
            kw[k] = None if not v else kw.get(k)
        else:
            kw[k] = v
    return TrainConfig(**kw)
