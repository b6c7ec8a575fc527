"""The numbers that decide ``correct`` and their limits.

Serving, by the worst sampled frame:

* ``depth_err``: the served inverse depth at camera resolution against
  the reference's from the same frames and weights, each less its own
  frame mean, over the reference's deviation from its mean (2-norms):
  the error of the depth map's shape against the map's own spread. (With
  the mean kept in, bf16 puts an offset in some seeds' maps that reads as
  large as the control's error, which then fails to separate the two.)
* ``seg_err``: the served segmentation against the reference's,
  ``|got - want| / |want - mean(want)|``;
* ``points_err``: the served points against the reference's
  unprojection of the served inverse depth, ``|got - want| / |want|``;
* ``grid_err``: the served grid against the reference's voxelization of
  the served points and segmentation, the share of the grid's mass that
  differs;
* ``depth_shift``: the served inverse depth's frame mean against the
  reference's, relative: the offset that ``depth_err`` leaves out, and
  that ``points_err`` and ``grid_err``, which start from the served
  inverse depth, cannot see.

The limits of a cell are in ``limits/<workload>.json``, each set between
the largest reading of sound runs and the smallest of the control (or of
a fault), with the readings it was set from. A number the file gives no
limit is computed and not compared: no control or fault separates it
from sound runs.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from .reference import geometry

SERVE_NUMBERS = ("depth_err", "seg_err", "points_err", "grid_err", "depth_shift")
LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def serve_numbers(got, want, cfg: dict) -> Dict[str, float]:
    inv, seg, points, grid = (t.float() for t in got)
    inv_r, seg_r = want[0].float(), want[1].float()
    want_points = geometry.unproject(inv, cfg["camera"])
    want_grid = geometry.voxelize(points, seg, cfg["occupancy"])
    mass = float(want_grid.double().sum())
    return {
        "depth_err": _norm((inv - inv.mean()) - (inv_r - inv_r.mean()))
        / max(_norm(inv_r - inv_r.mean()), 1e-30),
        "seg_err": _norm(seg - seg_r) / max(_norm(seg_r - seg_r.mean()), 1e-30),
        "points_err": _norm(points - want_points) / max(_norm(want_points), 1e-30),
        "grid_err": float((grid - want_grid).double().abs().sum()) / mass if mass > 0
        else float("inf"),
        "depth_shift": abs(float(inv.double().mean() - inv_r.double().mean()))
        / max(abs(float(inv_r.double().mean())), 1e-30),
    }


def limits(workload: str) -> Dict[str, float]:
    path = LIMITS_DIR / f"{workload}.json"
    if not path.exists():
        raise FileNotFoundError(f"no limits for workload {workload!r}: {path}")
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text())["limits"].items()}


def decide(numbers: Dict[str, float], lim: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}) over the numbers ``lim``
    names: every one finite and at most its limit. A number that is not
    finite is written as null."""
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": v}
              for k, v in lim.items()}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in lim.items())
    return ok, checks
