"""The port's host tools against the JAX package's, on the CPU:
``cli/datasets_analysis.py`` (``analyze`` on each package's dataset of its
own BDD fixture tree, which the two write byte for byte alike),
``cli/graph_runs.py`` (``load_runs``, ``plot_metric`` and ``main`` on one
set of JSONL logs) and ``utils/debug.py`` (``tree_finite_report`` on one
nested tree of arrays, given to the port as arrays and as tensors;
``set_determinism``; ``enable_nan_checks``). Equal results are asked for:
the analysis reads the same pixels and rounds its fractions to 5 places.
"""
import json
import sys

import numpy as np
import pytest
import torch

from soccdpt_tpu.cli import datasets_analysis as jda
from soccdpt_tpu.cli import graph_runs as jgr
from soccdpt_tpu.cli.train import build_datasets as jax_build_datasets
from soccdpt_tpu.core.config import TrainConfig as JaxTrainConfig
from soccdpt_tpu.data import synthetic as jsynthetic
from soccdpt_tpu.utils import debug as jdebug

from soccdpt_torch.cli import datasets_analysis as pda
from soccdpt_torch.cli import graph_runs as pgr
from soccdpt_torch.cli.train import build_datasets
from soccdpt_torch.core.config import TrainConfig
from soccdpt_torch.data import synthetic
from soccdpt_torch.utils import debug as pdebug


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    port_tree = tmp_path_factory.mktemp("bdd_port")
    jax_tree = tmp_path_factory.mktemp("bdd_jax")
    synthetic.make_bdd_fixture(str(port_tree), frames_per_seq=3)
    jsynthetic.make_bdd_fixture(str(jax_tree), frames_per_seq=3)
    return str(port_tree), str(jax_tree)


@pytest.mark.parametrize("max_samples", [2, 50])
def test_analyze_is_the_jax_one(trees, max_samples):
    port_ds, nc, _ = build_datasets(TrainConfig(dataset="bdd", base_path=trees[0]),
                                    "dpt_swin2_test_64")
    jax_ds, jnc, _ = jax_build_datasets(JaxTrainConfig(dataset="bdd", base_path=trees[1]),
                                        "dpt_swin2_test_64")
    got = pda.analyze(port_ds, nc, max_samples)
    want = jda.analyze(jax_ds, jnc, max_samples)
    assert got == want
    assert got["analyzed"] == min(max_samples, got["num_samples"]) and "disparity" in got


def test_datasets_analysis_main_prints_the_analysis(trees, capsys):
    out = pda.main(["-dt", "bdd", "-b", trees[0], "-t", "dpt_swin2_test_64",
                    "--max_samples", "3"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["analyzed"] == 3 and len(out["class_pixel_fraction"]) == 3


def _write_logs(log_dir):
    log_dir.mkdir()
    rng = np.random.default_rng(0)
    for run in ("trial000", "trial001"):
        with open(log_dir / f"metrics_{run}.jsonl", "w") as fh:
            for step in range(5):
                row = {"step": step, "loss": float(rng.uniform(0, 1))}
                if step % 2:
                    row["val/rmse"] = float(rng.uniform(12, 14))
                fh.write(json.dumps(row) + "\n")
            fh.write(json.dumps({"step": None, "loss": 0.0}) + "\n\n")
    return str(log_dir)


def test_load_runs_and_plot_metric_are_the_jax_ones(tmp_path):
    log_dir = _write_logs(tmp_path / "logs")
    runs = pgr.load_runs(log_dir)
    assert runs == jgr.load_runs(log_dir) and sorted(runs) == ["trial000", "trial001"]
    for metric, ylim in (("loss", None), ("val/rmse", (12.0, 14.0)), ("val/iou", None)):
        name = metric.replace("/", "_")
        got = pgr.plot_metric(runs, metric, str(tmp_path / "port" / f"{name}.png"), ylim)
        want = jgr.plot_metric(runs, metric, str(tmp_path / "jax" / f"{name}.png"), ylim)
        assert got == want == (metric != "val/iou")
        assert (tmp_path / "port" / f"{name}.png").exists() == got


def test_graph_runs_main(tmp_path, capsys):
    log_dir = _write_logs(tmp_path / "logs")
    pgr.main(["--log_dir", log_dir, "--out_dir", str(tmp_path / "graphs")])
    wrote = sorted(p.name for p in (tmp_path / "graphs").iterdir())
    assert wrote == ["loss.png", "val_rmse.png"]
    assert "wrote" in capsys.readouterr().out
    pgr.main(["--log_dir", str(tmp_path / "none")])
    assert "no runs found" in capsys.readouterr().out


def test_graph_runs_names_matplotlib_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        pgr.plot_metric({"r": [{"step": 0, "loss": 1.0}]}, "loss", str(tmp_path / "x.png"))


def _tree():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    a[0, 1] = np.nan
    b = np.full(4, np.inf, np.float32)
    return {
        "params": {"dense": {"kernel": a, "bias": np.zeros(3, np.float32)},
                   "blocks": [np.ones(2, np.float32), b]},
        "batch_stats": (np.array([np.nan, -np.inf], np.float32),),
        "count": np.int32(7),
        "none": None,
    }


def _as_tensors(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def test_tree_finite_report_is_the_jax_one():
    want = jdebug.tree_finite_report(_tree())
    assert want == {"['params']['dense']['kernel']": 1, "['params']['blocks'][1]": 4,
                    "['batch_stats'][0]": 2}
    assert pdebug.tree_finite_report(_tree()) == want
    assert pdebug.tree_finite_report(_as_tensors(_tree())) == want
    bf16 = _as_tensors(_tree())
    bf16["params"]["dense"]["kernel"] = bf16["params"]["dense"]["kernel"].bfloat16()
    assert pdebug.tree_finite_report(bf16) == want


def test_set_determinism_seeds_every_generator_and_cudnn(monkeypatch):
    import random

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    draws = []
    for _ in range(2):
        pdebug.set_determinism(3)
        draws.append((random.random(), np.random.rand(), torch.rand(2).tolist()))
    assert draws[0] == draws[1]
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_nan_checks_raise_at_the_backward_that_makes_a_nan():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    pdebug.enable_nan_checks(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        pdebug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x.detach().clone().requires_grad_()).sum().backward()  # unchecked: no error
