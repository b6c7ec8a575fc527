"""Configuration dataclasses: camera, occupancy grid and model.

The port's own copy of the serving half of ``soccdpt_tpu/core/config.py``
(``CameraConfig``, ``OccupancyConfig``, ``MODEL_TYPES``, ``ModelConfig``),
so the port never imports the JAX package. Field names and defaults are
the same, so a config built for one package reads the same in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


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
