"""A cell of ``BENCHMARK.json`` resolved to its files: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<traffic>.json``)
and the reader of each per-layer metric (``metrics/<name>.py``, or
``metrics/<stem>.py`` for a name ``<stem>.<cells>``)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path, workload: str) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer)


def reader(name: str) -> Callable:
    """The ``read(reading)`` function of per-layer metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} in {HERE / 'metrics'}")


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in cell.per_layer}
