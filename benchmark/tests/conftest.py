"""Cells of ``BENCHMARK.json`` shrunk to run on the CPU in seconds: the
test trunks of the program (``swin2test_64``, ``beittest_64``) at 64 px,
a 48x64 camera, a 16x16x8 grid, small batches and short windows. Tests
that need a card carry the ``gpu`` marker and decide inside the test."""
from __future__ import annotations

import copy

import pytest

from benchmark import run, spec

TINY_BACKBONES = {
    "swin2": ("dpt_swin2_test_64", {
        "family": "swin2", "img_size": 64, "patch_size": 4, "embed_dim": 16,
        "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 4,
        "pretrained_window_sizes": [0, 0, 0, 0], "mlp_ratio": 4.0, "drop_path_rate": 0.1,
        "hooks": [1, 1, 1, 1]}),
    "beit": ("dpt_beit_test_64", {
        "family": "beit", "img_size": 64, "patch_size": 8, "embed_dim": 32, "depth": 4,
        "num_heads": 2, "mlp_ratio": 4.0, "post_channels": [16, 32, 64, 128],
        "hooks": [0, 1, 2, 3]}),
}


def shrink(cell: spec.Cell) -> spec.Cell:
    cell = copy.deepcopy(cell)
    cfg, tr = cell.config, cell.traffic
    cfg["model_type"], cfg["backbone"] = copy.deepcopy(TINY_BACKBONES[cfg["backbone"]["family"]])
    cfg.update(net_size=[64, 64], features=16, head_features_2=8)
    cfg["camera"].update(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0)
    cfg["occupancy"].update(grid_size=[16, 16, 8], pc_scale=[1.0, 1.0, 1.0],
                            pc_shift=[4.0, 4.0, 0.0])
    tr.update(batch=2, ring=min(tr["ring"], 4), trace=[1, 2, 1])
    if tr["kind"] == "rig":
        tr["rate_hz"] = 4.0
    if tr["kind"] == "backlog":
        tr["sample_within"] = 2
    return cell


@pytest.fixture
def tiny(monkeypatch):
    """``tiny(workload)``: the shrunk cell, with the program's test model
    types registered and ``spec.load`` returning it."""
    from soccdpt_torch.core import config as pconfig

    monkeypatch.setitem(pconfig.MODEL_TYPES, "dpt_beit_test_64", ("beittest_64", 64, 64))

    def make(workload: str) -> spec.Cell:
        cell = shrink(spec.load(run.ROOT, workload))
        monkeypatch.setattr(spec, "load", lambda root, name: cell)
        return cell

    return make
