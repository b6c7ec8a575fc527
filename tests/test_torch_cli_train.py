"""The port's training CLI (``soccdpt_torch/cli/train.py``) and the pieces
it brought (sweep files, ``StepTimer``, ``param_histograms``,
``utils/visualize.py``) against the JAX package's, on the CPU, on the
BDD fixture tree of ``data/synthetic.py``.

Tolerances: sweep trials and ``TrainConfig`` fields equal; ``StepTimer``
equal on one fake clock; ``param_histograms`` 1e-6 relative (numpy's f32
std of the same values in another memory order, the port's torch layout
against the JAX tree's flax layout); eval panels decoded from their PNG
files within one level of uint8.
"""
import dataclasses
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from soccdpt_tpu.core import config as jconfig
from soccdpt_tpu.utils import logging as jlogging
from soccdpt_tpu.utils import timing as jtiming
from soccdpt_tpu.utils import visualize as jvisualize

from soccdpt_torch.cli import train as ptrain
from soccdpt_torch.core import config as pconfig
from soccdpt_torch.core.checkpoint import restore_checkpoint
from soccdpt_torch.core.config import ModelConfig
from soccdpt_torch.data import synthetic
from soccdpt_torch.data.bdd import class_2_color
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.utils import logging as plogging
from soccdpt_torch.utils import timing as ptiming
from soccdpt_torch.utils import visualize as pvisualize
from soccdpt_torch.weights import named_flax_params, to_jax_variables

from chip_smoke import reference_state_dict

CONFIG = os.path.join(os.path.dirname(__file__), "..", "config")


@pytest.fixture(scope="module")
def bdd_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("bdd_cli")
    synthetic.make_bdd_fixture(str(base), frames_per_seq=3)
    return str(base)


def tiny_sweep(tmp_path, **params):
    """config/test_tiny.json with ``params`` replaced."""
    with open(os.path.join(CONFIG, "test_tiny.json")) as fh:
        raw = json.load(fh)
    for k, v in params.items():
        raw["parameters"][k] = {"values": [v]}
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(raw))
    return str(path)


def cli_args(tree, sweep, *extra):
    return ["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_test_64", "-b", tree,
            "--sweep_json", sweep, "--device", "cpu", *extra]


def test_train_cli_few_steps(bdd_tree, tmp_path, monkeypatch):
    """tests/test_cli.py::test_train_cli_few_steps on the port."""
    monkeypatch.chdir(tmp_path)
    results = ptrain.main(cli_args(bdd_tree, os.path.join(CONFIG, "test_tiny.json"),
                                   "--max_steps", "2", "--log_dir", str(tmp_path / "logs")))
    assert len(results) == 1
    assert "rmse" in results[0] and "iou" in results[0]
    logs = list((tmp_path / "logs").glob("*.jsonl"))
    assert logs, "JSONL metrics written"
    lines = [json.loads(l) for l in logs[0].read_text().splitlines()]
    assert any("loss" in l for l in lines)
    assert sum("loss" in l for l in lines) == 2
    assert all(np.isfinite(l["loss"]) for l in lines if "loss" in l)
    assert list((tmp_path / "logs").glob("trial000_step*.png"))  # the eval rounds' panels


def test_all_sweep_configs_load_and_yield_trials():
    """tests/test_cli.py::test_all_sweep_configs_load_and_yield_trials on
    the port, and for every sweep file the port's trials and ``TrainConfig``
    are the JAX package's (the fields the port has: all but ``mesh_shape``
    and ``mesh_axes``, which neither package reads)."""
    paths = sorted(glob.glob(os.path.join(CONFIG, "*.json")))
    assert len(paths) >= 24, paths
    port_fields = {f.name for f in dataclasses.fields(pconfig.TrainConfig)}
    jax_fields = {f.name for f in dataclasses.fields(jconfig.TrainConfig)}
    assert jax_fields - port_fields == {"mesh_shape", "mesh_axes"}
    assert port_fields <= jax_fields
    for path in paths:
        sweep = pconfig.SweepConfig.load(path)
        trial = next(sweep.trials(count=1, seed=0))
        cfg = pconfig.train_config_from_params(trial)
        assert cfg.batch_size >= 1, path
        assert 0 < cfg.learning_rate < 1, path
        assert cfg.epochs >= 1, path
        if "loss_weights" in trial:
            assert len(cfg.loss_weights) == 2, path

        jsweep = jconfig.SweepConfig.load(path)
        assert (sweep.method, sweep.metric, sweep.parameters) == (
            jsweep.method, jsweep.metric, jsweep.parameters), path
        count = None if sweep.method == "grid" else 3
        trials = list(sweep.trials(count=count, seed=0))
        assert trials == list(jsweep.trials(count=count, seed=0)), path
        for t in trials:
            got = pconfig.train_config_from_params(t)
            want = jconfig.train_config_from_params(t)
            for name in port_fields:
                assert getattr(got, name) == getattr(want, name), (path, name)


def test_tensor_parallelism_raises(bdd_tree):
    """``--tp`` that does not divide the world raises: one process is a
    world of 1. The sweep's parallelism keys are the JAX package's."""
    with pytest.raises(ValueError, match="--tp 2 does not divide the world size 1"):
        ptrain.main(cli_args(bdd_tree, os.path.join(CONFIG, "test_tiny.json"), "--tp", "2"))
    assert pconfig.train_config_from_params({"tp": 2, "tp_min_size": 256}) == \
        pconfig.TrainConfig(tp=2, tp_min_size=256)
    assert pconfig.train_config_from_params({"tp": 1, "mesh_shape": (1,)}) == pconfig.TrainConfig()


def test_checkpoint_is_read_back_by_eval(bdd_tree, tmp_path, monkeypatch):
    """A trial's epoch checkpoint holds the weights, the BatchNorm
    statistics, Adam's moments and the step, and ``cli/eval.py -l`` serves
    exactly those weights."""
    from soccdpt_torch.cli import eval as peval

    monkeypatch.chdir(tmp_path)
    ptrain.main(cli_args(bdd_tree, tiny_sweep(tmp_path, save_checkpoint=True),
                         "--max_steps", "2", "-c", str(tmp_path / "ck"),
                         "--host_prefetch", "0"))
    path = tmp_path / "ck" / "SOccDPT_V3_dpt_swin2_test_64_bdd" / "trial000" / "checkpoint_epoch_1"
    ckpt = restore_checkpoint(str(path))
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
    assert "seg_head.bn.running_mean" in ckpt["batch_stats"]
    assert set(ckpt["opt_state"]["mu"]) == {p for p, _ in named_flax_params(
        build_model(ModelConfig(model_type="dpt_swin2_test_64"), device="cpu"))}

    loaded = []
    load_weights = ptrain.load_weights

    def spy(model, *args):
        out = load_weights(model, *args)
        loaded.append({k: v.clone() for k, v in model.state_dict().items()})
        return out

    monkeypatch.setattr(ptrain, "load_weights", spy)
    metrics = peval.main(["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_test_64", "-b", bdd_tree,
                          "-l", str(path), "--num_samples", "2", "--skip_fps",
                          "--media_dir", str(tmp_path / "media"), "--device", "cpu"])
    assert len(loaded) == 1
    for name, t in {**ckpt["params"], **ckpt["batch_stats"]}.items():
        assert torch.equal(loaded[0][name], t), name
    assert all(np.isfinite(v) for v in metrics.values())
    assert len(list((tmp_path / "media" / "dpt_swin2_test_64_bdd_v3").glob("*.png"))) == 2


def test_train_cli_starts_from_a_reference_pth(bdd_tree, tmp_path, monkeypatch, capsys):
    """The sweep's ``load`` names a reference-layout ``.pth``: every leaf
    of the model is read from it, nothing is left over."""
    monkeypatch.chdir(tmp_path)
    source = build_model(ModelConfig(model_type="dpt_swin2_test_64", features=256), device="cpu",
                         seed=3)
    sd = reference_state_dict(to_jax_variables(source), 3, "swin")
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "optimizer": {"lr": 1e-3}}, pth)
    ptrain.main(cli_args(bdd_tree, tiny_sweep(tmp_path, load=pth), "--max_steps", "1"))
    out = capsys.readouterr().out
    assert "[torch_import] loaded 200/200 leaves; 0 unused imported keys; 0 shape mismatches" in out
    assert "[torch_import] loaded 2/2 leaves; 0 unused imported keys; 0 shape mismatches" in out


def test_step_timer_matches_jax(monkeypatch):
    clock = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.1, 3.3])
    times = list(clock)
    got, want = ptiming.StepTimer(window=3), jtiming.StepTimer(window=3)
    for t in times:
        monkeypatch.setattr(ptiming.time, "perf_counter", lambda t=t: t)
        monkeypatch.setattr(jtiming.time, "perf_counter", lambda t=t: t)
        assert got.tick() == want.tick()
        assert got.mean == want.mean
    assert got.times == want.times and len(got.times) == 3


def test_param_histograms_match_jax():
    model = build_model(ModelConfig(model_type="dpt_swin2_test_64", features=32), device="cpu")
    rng = np.random.default_rng(0)
    for i, (_, p) in enumerate(named_flax_params(model)):
        if i % 2:  # the others have no gradient: zeros in the JAX tree
            p.grad = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
    tree = to_jax_variables(model)["params"]
    grads = to_jax_variables(model, grads=True)["params"]
    want = jlogging.param_histograms(tree, grads)
    got = plogging.param_histograms(model, grads=True)
    assert list(got) == list(want)
    assert "Weights/['depth_net']['backbone']['patch_embed']['kernel'].std" in got
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-6)
    assert list(plogging.param_histograms(model)) == list(jlogging.param_histograms(tree))


def test_eval_panel_matches_jax(tmp_path):
    """Predictions at half the frame's size (resized into the panel) and a
    NaN in the ground truth (black, as matplotlib colours it)."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    disp_pred = rng.random((24, 32)).astype(np.float32)
    disp_gt = (rng.random((48, 64)) * 3).astype(np.float32)
    seg_pred = rng.random((3, 24, 32)).astype(np.float32)
    seg_gt = (rng.random((3, 48, 64)) > 0.5).astype(np.float32)
    args = (rgb, disp_pred, disp_gt, seg_pred, seg_gt, class_2_color)
    got, want = pvisualize.eval_panel(*args), jvisualize.eval_panel(*args)
    assert got.shape == want.shape == (96, 192, 3) and got.dtype == np.uint8
    pvisualize.save_image(str(tmp_path / "port" / "p.png"), got)
    jvisualize.save_image(str(tmp_path / "jax" / "p.png"), want)
    a = cv2.imread(str(tmp_path / "port" / "p.png")).astype(int)
    b = cv2.imread(str(tmp_path / "jax" / "p.png")).astype(int)
    assert np.abs(a - b).max() <= 1
    np.testing.assert_array_equal(a[..., ::-1], got)  # written as RGB -> BGR
    disp_gt[0, 0] = np.nan
    for cmap in ("plasma", "viridis"):
        np.testing.assert_array_equal(pvisualize.colorize_disparity(disp_gt, cmap),
                                      jvisualize.colorize_disparity(disp_gt, cmap))
    pts = rng.standard_normal((50, 3))
    np.testing.assert_array_equal(pvisualize.color_by_height(pts, invert=True),
                                  jvisualize.color_by_height(pts, invert=True))
