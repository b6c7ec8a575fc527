"""The port's eval CLI (``soccdpt_torch/cli/eval.py``) against the JAX
package's (``soccdpt_tpu/cli/eval.py``), on the CPU: the same BDD fixture
tree and the same reference-layout ``.pth``, written from one JAX
variables tree (tests/test_torch_import.py's ``_to_torch_sd``), which
covers every leaf, so neither side keeps a weight of its own init.

Both CLIs build their model in bf16; here both are made to build it in
f32 (``ModelConfig`` wrapped in either package), so that the comparison
holds the metrics, the reader and the panels and not two CPUs' bf16
rounding. Tolerances: every metric to 1e-4 relative; the panels, decoded
from their PNG files, within one level of uint8, but for the coloured
predicted disparity: where a net-resolution pixel's normalised value lies
within f32 noise of an edge between two of the colormap's 256 rows, the
two stacks take neighbouring rows, and the panel's bilinear upscale
spreads that step over its footprint. There the bound is the table's
largest step between neighbouring rows (``PLASMA_STEP``), on at most
``PANEL_SHARE_OFF`` of the pixels (the first run: 101 of 12.4 M pixels
off by 2 levels, in one of three panels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cv2

from soccdpt_tpu.cli import eval as jeval
from soccdpt_tpu.core import config as jconfig
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model

from soccdpt_torch.cli import eval as peval
from soccdpt_torch.core import config as pconfig
from soccdpt_torch.data import synthetic
from soccdpt_torch.utils import visualize

from test_torch_import import _to_torch_sd

MODEL = "dpt_swin2_test_64"
PANEL_SHARE_OFF = 1e-4
# the largest step of a channel between two neighbouring rows of the table
PLASMA_STEP = int(np.abs(np.diff(visualize._table("plasma").astype(int), axis=0)).max())


def f32(config_module, monkeypatch):
    """Make ``config_module.ModelConfig(...)`` build an f32 config."""
    real = config_module.ModelConfig
    monkeypatch.setattr(config_module, "ModelConfig",
                        lambda **kw: real(**{**kw, "compute_dtype": "float32"}))


@pytest.fixture(scope="module")
def fixture_and_pth(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_cli")
    tree = str(base / "bdd")
    synthetic.make_bdd_fixture(tree, frames_per_seq=3)
    # the eval CLI's model: V3, default widths, three classes
    model = jax_build_model(jconfig.ModelConfig(model_type=MODEL, version=3))
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)), return_raw=True))
    # inverse depth near 0.3 and still varied: the metrics fit a scale and
    # shift to it in closed form, and a prediction made flat (the kernel
    # x 0.01) lets that fit's scale blow f32 noise up to 1.4e-4 of sq_rel,
    # between the port's own runs at 1 and 8 threads as between the two
    # packages; at x 0.1 both stay within 3e-6
    head = v["params"]["depth_net"]["head"]["conv3"]
    head["kernel"] = head["kernel"] * 0.1
    head["bias"] = np.full_like(head["bias"], 0.3)
    sd = _to_torch_sd(v["params"], v["batch_stats"])
    pth = str(base / "model.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}, pth)
    return tree, pth


def test_eval_cli_matches_jax(fixture_and_pth, tmp_path, monkeypatch, capsys):
    tree, pth = fixture_and_pth
    f32(jconfig, monkeypatch)
    f32(pconfig, monkeypatch)
    args = ["-v", "3", "-dt", "bdd", "-t", MODEL, "-b", tree, "-l", pth, "--num_samples", "3",
            "--skip_fps"]
    want = jeval.main(args + ["--media_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    got = peval.main(args + ["--media_dir", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    # both readers took every leaf from the file
    for out in (jax_out, port_out):
        assert "unused imported keys; 0 shape mismatches" in out
    assert set(got) == set(want) and {"rmse", "iou", "a1"} <= set(got)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    sub = f"{MODEL}_bdd_v3"
    for i in range(3):
        a = cv2.imread(str(tmp_path / "port" / sub / f"sample_{i:03d}.png")).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / sub / f"sample_{i:03d}.png")).astype(int)
        assert a.shape == b.shape == (2160, 5760, 3)
        diff = np.abs(a - b).max(-1)
        assert diff.max() <= PLASMA_STEP, f"panel {i}"
        assert (diff > 1).sum() <= PANEL_SHARE_OFF * diff.size, f"panel {i}"
        # only in the predicted disparity: top row, second image
        assert not (diff[:, :1920] > 1).any() and not (diff[1080:] > 1).any(), f"panel {i}"
