"""Metric logging: console and JSONL.

The port of ``soccdpt_tpu/utils/logging.py``'s ``MetricWriter``, without
its wandb, image and point-cloud sinks, which no ported caller uses.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricWriter:
    """Prints each step's scalars and, given ``log_dir``, appends them as
    one JSON line each to ``<log_dir>/metrics_<run_id>.jsonl``."""

    def __init__(self, log_dir: Optional[str] = None, run_id: Optional[str] = None) -> None:
        self.run_id = run_id or time.strftime("%Y%m%d_%H%M%S")
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(log_dir, f"metrics_{self.run_id}.jsonl"), "a"
            )

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
        record = {"step": step, "time": time.time(), **scalars}
        pretty = " ".join(f"{k}={v:.6g}" for k, v in scalars.items() if k != "time")
        print(f"[step {step}] {pretty}")
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
