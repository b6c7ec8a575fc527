"""The port's baseline-comparison harness (``soccdpt_torch.cli.eval_others``)
against the JAX package's (``soccdpt_tpu/cli/eval_others.py``), on the CPU,
on BDD fixture trees written by each package's ``data/synthetic.py``.

It mirrors tests/test_cli.py's eval_others tests (the builtin adapter, the
file adapters, the onnx error, the registry, the mocked hub for MiDaS and
vidar, the package-gated errors, ``--list``), with ``pt2:<path>`` (a
``torch.export`` program) where the JAX package has ``stablehlo:<path>``.
``evaluate_adapter`` is held to JAX's on one numpy adapter that reads the
raw frame (the same bytes in both packages): the metrics agree to
``METRIC_RTOL`` = 1e-5, the two bicubic resizes (the JAX package's
matrices, torch's ``interpolate``) differing by the order of their f32
sums. There is no network: the hub is mocked.
"""
import json

import numpy as np
import pytest
import torch

from soccdpt_tpu.cli import eval_others as jeo
from soccdpt_tpu.cli.train import build_datasets as jax_build_datasets
from soccdpt_tpu.core.config import TrainConfig as JaxTrainConfig
from soccdpt_tpu.data import synthetic as jsynthetic

from soccdpt_torch.cli import eval_others as peo
from soccdpt_torch.cli.export import export_model
from soccdpt_torch.cli.train import build_datasets, dataset_camera
from soccdpt_torch.core.config import TrainConfig
from soccdpt_torch.data import synthetic

MODEL = "dpt_swin2_test_64"
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def bdd_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("bdd_eval_others")
    synthetic.make_bdd_fixture(str(base), frames_per_seq=3)
    return str(base)


@pytest.fixture(scope="module")
def dataset(bdd_tree):
    return build_datasets(TrainConfig(dataset="bdd", base_path=bdd_tree), MODEL)[0]


def _finite(metrics):
    return "rmse" in metrics and "a1" in metrics and all(np.isfinite(list(metrics.values())))


def test_builtin_and_pt2_adapters_give_the_same_metrics(dataset, tmp_path):
    """The builtin adapter (the model from numpy seed 0, bf16) and the
    ``pt2:`` adapter on that model's exported program score the same."""
    builtin = peo.evaluate_adapter(peo.builtin_adapter(MODEL, device="cpu"), dataset,
                                   max_samples=2)
    path = export_model(MODEL, 3, str(tmp_path / "m.pt2"), device="cpu")
    exported = peo.evaluate_adapter(peo.load_adapter(f"pt2:{path}", device="cpu"), dataset,
                                    max_samples=2)
    assert _finite(builtin) and builtin == exported


def test_builtin_adapter_loads_a_checkpoint(dataset, tmp_path):
    """``load``: a checkpoint of the port moves the metrics off the seed's."""
    from soccdpt_torch.core.checkpoint import save_checkpoint
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model

    other = build_model(ModelConfig(model_type=MODEL), device="cpu", seed=5)
    save_checkpoint(str(tmp_path / "ckpt"), {"params": other.state_dict()})
    seeded = peo.builtin_adapter(MODEL, device="cpu")
    loaded = peo.builtin_adapter(MODEL, load=str(tmp_path / "ckpt"), device="cpu")
    x = dataset[0]["image"][None]
    assert loaded(x).shape == seeded(x).shape == (1, 64, 64)
    assert not np.array_equal(loaded(x), seeded(x))


def test_file_adapter_errors(tmp_path):
    """Without onnxruntime the ``onnx:`` adapter fails with an actionable
    message; unknown schemes and missing files are rejected."""
    p = tmp_path / "m.onnx"
    p.write_bytes(b"\x00")
    try:
        import onnxruntime  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="onnxruntime"):
            peo.file_adapter("onnx", str(p))
    with pytest.raises(ValueError, match="unknown file adapter"):
        peo.file_adapter("bogus", str(p))
    with pytest.raises(ValueError, match="unknown file adapter"):
        peo.file_adapter("stablehlo", str(p))
    with pytest.raises(FileNotFoundError):
        peo.file_adapter("pt2", str(tmp_path / "missing"))


def test_custom_adapter_spec(dataset):
    """``module.path:function`` calls the function for the adapter."""
    fn = peo.load_adapter("test_torch_eval_others:_mean_adapter")
    assert _finite(peo.evaluate_adapter(fn, dataset, max_samples=1))


def _mean_adapter():
    return lambda images: np.asarray(images, np.float32).mean(axis=1) + 3.0


def test_external_registry_is_the_jax_one():
    """All seven reference wrappers, with the corrected transform for
    DPT_Hybrid and DPT_Large."""
    assert peo.EXTERNAL_BASELINES == jeo.EXTERNAL_BASELINES
    assert set(peo.EXTERNAL_BASELINES) == {
        "DPT_SwinV2_T_256", "DPT_Hybrid", "DPT_Large",
        "monodepth2", "manydepth", "zerodepth", "packnet",
    }
    assert peo.EXTERNAL_BASELINES["DPT_Large"]["transform"] == "dpt_transform"


class FakeMidas(torch.nn.Module):
    def forward(self, x):  # (B, 3, H, W) -> (B, H, W) inverse depth
        return x.abs().mean(dim=1) + 0.1


class FakeTransforms:
    @staticmethod
    def swin256_transform(img):
        t = torch.tensor(np.asarray(img, np.float32).transpose(2, 0, 1)[None] / 255.0)
        return torch.nn.functional.interpolate(t, size=(256, 256), mode="bilinear",
                                               align_corners=False)

    dpt_transform = swin256_transform


def test_midas_adapter_on_a_mocked_hub(monkeypatch, dataset):
    """Raw frame -> hub transform -> model -> (1, H', W') disparity ->
    shared SSI metrics; the hub is mocked (no network)."""
    calls = []

    def fake_hub_load(repo, name, *a, **k):
        calls.append((repo, name))
        assert repo == "intel-isl/MiDaS"
        return FakeTransforms() if name == "transforms" else FakeMidas()

    monkeypatch.setattr(torch.hub, "load", fake_hub_load)
    adapter = peo.external_adapter("DPT_SwinV2_T_256")
    assert adapter.wants_raw
    assert adapter(np.asarray(dataset[0]["image_raw"])).shape == (1, 256, 256)
    assert _finite(peo.evaluate_adapter(adapter, dataset, max_samples=2))
    assert ("intel-isl/MiDaS", "DPT_SwinV2_T_256") in calls


def test_vidar_adapters_on_a_mocked_hub(monkeypatch, dataset):
    """zerodepth/packnet emit DEPTH: the adapter resizes and normalizes as
    the reference does, passes the camera's intrinsics (zerodepth), and
    inverts to disparity (reference eval_others.py:157-199, 228-241)."""
    seen = {}

    class FakeZeroDepth(torch.nn.Module):
        def forward(self, x, intrinsics):
            seen["intrinsics"] = np.asarray(intrinsics)
            seen["zx"] = np.asarray(x)
            return torch.full((1, 1, x.shape[2], x.shape[3]), 2.0)

    class FakePackNet(torch.nn.Module):
        def forward(self, x):
            seen["px"] = np.asarray(x)
            return [torch.full((1, 1, x.shape[2], x.shape[3]), 4.0)]

    def fake_hub_load(repo, name, *a, **k):
        assert repo == "TRI-ML/vidar"
        return FakeZeroDepth() if name == "ZeroDepth" else FakePackNet()

    monkeypatch.setattr(torch.hub, "load", fake_hub_load)
    cam = dataset_camera(dataset)
    raw = np.asarray(dataset[0]["image_raw"])
    z = peo.external_adapter("zerodepth", camera=cam)
    np.testing.assert_allclose(z(raw), 0.5)  # depth 2.0 -> disparity 0.5
    K = seen["intrinsics"][0]
    assert K[0, 0] == pytest.approx(cam.fx * 0.5) and K[2, 2] == pytest.approx(1.0)
    assert seen["zx"].max() <= 1.0  # /255 normalization applied
    assert seen["zx"].shape[-2:] == (raw.shape[0] // 2, raw.shape[1] // 2)
    p = peo.external_adapter("packnet")
    np.testing.assert_allclose(p(raw), 0.25)  # depth 4.0 -> disparity 0.25
    assert seen["px"].shape[-2:] == (384, 640)  # reference resize (640, 384)
    assert np.isfinite(peo.evaluate_adapter(z, dataset, max_samples=1)["rmse"])


def test_resize_of_the_raw_frame_is_opencv_s():
    """The wrappers' bilinear uint8 resize gives OpenCV's bits."""
    cv2 = pytest.importorskip("cv2")
    raw = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    for wh in ((640, 192), (64, 48), (640, 384)):
        np.testing.assert_array_equal(peo._resize_hwc(raw, wh), cv2.resize(raw, wh))


def test_hub_failure_is_a_clean_error(monkeypatch):
    """No network: the hub's failure becomes a RuntimeError naming the
    baseline and the repo."""
    def no_hub(*a, **k):
        raise OSError("network is unreachable")

    monkeypatch.setattr(torch.hub, "load", no_hub)
    adapter = peo.external_adapter("DPT_Hybrid")
    with pytest.raises(RuntimeError, match="DPT_Hybrid.*intel-isl/MiDaS"):
        adapter(np.zeros((32, 48, 3), np.uint8))


def test_package_gated_adapters_raise_a_clear_error():
    """monodepth2/manydepth need packages absent here: a clear RuntimeError
    naming the requirement on first use, not an ImportError at registry
    time."""
    for name in ("monodepth2", "manydepth"):
        adapter = peo.external_adapter(name)  # construction must not raise
        with pytest.raises(RuntimeError, match=name):
            adapter(np.zeros((32, 48, 3), np.uint8))


def test_list_registry(capsys):
    peo.main(["--list"])
    listed = json.loads(capsys.readouterr().out)
    jeo.main(["--list"])
    jax_listed = json.loads(capsys.readouterr().out)
    assert listed["file_schemes"] == ["pt2:<path>", "onnx:<path>"]
    assert {k: v for k, v in listed.items() if k != "file_schemes"} == {
        k: v for k, v in jax_listed.items() if k != "file_schemes"}


def _raw_adapter(raw):
    return np.asarray(raw, np.float32).mean(axis=-1)[None] / 255.0 + 0.1


_raw_adapter.wants_raw = True


def test_evaluate_adapter_is_the_jax_one(tmp_path_factory):
    """One numpy adapter of the raw frame, each package's dataset of its own
    fixture tree: equal metrics."""
    port_tree = tmp_path_factory.mktemp("bdd_port")
    jax_tree = tmp_path_factory.mktemp("bdd_jax")
    synthetic.make_bdd_fixture(str(port_tree), frames_per_seq=3)
    jsynthetic.make_bdd_fixture(str(jax_tree), frames_per_seq=3)
    port_ds = build_datasets(TrainConfig(dataset="bdd", base_path=str(port_tree)), MODEL)[0]
    jax_ds = jax_build_datasets(JaxTrainConfig(dataset="bdd", base_path=str(jax_tree)), MODEL)[0]
    got = peo.evaluate_adapter(_raw_adapter, port_ds, max_samples=3)
    want = jeo.evaluate_adapter(_raw_adapter, jax_ds, max_samples=3)
    assert got.keys() == want.keys() and _finite(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL, abs=1e-7), k


def test_main_scores_the_builtin_model_and_its_program(bdd_tree, tmp_path, capsys):
    path = export_model(MODEL, 3, str(tmp_path / "m.pt2"), device="cpu")
    rows = peo.main(["-m", MODEL, f"pt2:{path}", "-b", bdd_tree, "--num_samples", "1",
                     "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == rows and [r["model"] for r in rows] == [MODEL, f"pt2:{path}"]
    assert {k: v for k, v in rows[0].items() if k != "model"} == {
        k: v for k, v in rows[1].items() if k != "model"}
