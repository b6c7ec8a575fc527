"""Cells of ``BENCHMARK.json`` shrunk to run on the CPU in seconds: the
trunk family's test-sized trunk (``TINY`` of ``benchmark/reference/<family>.py``,
a test trunk of the program at 64 px), a 48x64 camera, a 16x16x8 grid,
small batches and short windows. Tests that need a card carry the ``gpu``
marker and decide inside the test."""
from __future__ import annotations

import copy

import pytest

from benchmark import reference, run, spec


def tiny_trunk(cfg: dict) -> tuple:
    """``(model_type, (backbone, net_w, net_h), backbone_cfg)``: the
    test-sized trunk that the configuration's family module gives."""
    module = reference.trunk_module(cfg)
    if not hasattr(module, "TINY"):
        raise AttributeError(f"{module.__name__} gives no TINY: its cells cannot be shrunk")
    return copy.deepcopy(module.TINY)


def shrink(cell: spec.Cell) -> spec.Cell:
    cell = copy.deepcopy(cell)
    cfg, tr = cell.config, cell.traffic
    cfg["model_type"], _, cfg["backbone"] = tiny_trunk(cfg)
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
    """``tiny(workload)``: the shrunk cell, with its test trunk's model
    type registered in the program and ``spec.load`` returning it."""
    from soccdpt_torch.core import config as pconfig

    def make(workload: str) -> spec.Cell:
        cell = shrink(spec.load(run.ROOT, workload))
        model_type, entry, _ = tiny_trunk(cell.config)
        monkeypatch.setitem(pconfig.MODEL_TYPES, model_type, tuple(entry))
        monkeypatch.setattr(spec, "load", lambda root, name: cell)
        return cell

    return make
