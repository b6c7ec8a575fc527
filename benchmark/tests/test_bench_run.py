"""The harness end to end on the CPU at tiny width, the look for a card
skipped: the last line of standard output, the checks on standard
error, and what happens without a card."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import run

CONTRACT = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["beitl512.rig6.20hz.grid", "swin2t.backlog.b6.grid"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_last_line(workload, trace, tiny, monkeypatch, capsys):
    cell = tiny(workload)
    monkeypatch.setattr(run, "find_device", lambda chips: torch.device("cpu"))
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 11), "--seconds", "1",
                   "--trace", str(trace)])
    captured = capsys.readouterr()
    assert rc == 0
    line = json.loads(captured.out.strip().splitlines()[-1])
    keys = CONTRACT[:4] + (["breakdown"] if trace else []) + CONTRACT[4:]
    assert list(line) == keys
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    err = captured.err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(line["checks"]):]] == list(line["checks"])
    assert all(ln.startswith("check ") and " limit " in ln for ln in err[-len(line["checks"]):])


def test_same_seed_same_inputs():
    from benchmark import system

    cfg = {"camera": {"height": 8, "width": 12}}
    a = system.frames(2**31 + 3, 2, 3, cfg, "cpu")
    b = system.frames(2**31 + 3, 2, 3, cfg, "cpu")
    c = system.frames(2**31 + 4, 2, 3, cfg, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_no_card_no_result(tmp_path):
    """Without a card the run exits nonzero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ cannot run."""
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_one_cell_on_the_card():
    """One short run of the rig cell on a card: a correct result line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "5", "--seconds", "3", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
