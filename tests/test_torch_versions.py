"""SOccDPT V1 and V2 of the port against the JAX package, on the CPU.

One weight set per model: the JAX variables tree, every leaf moved off its
init (``perturbed_variables``), goes into the port through
``load_jax_variables``. Both stacks run in f32, the JAX models
deterministic and the port's in ``eval()`` mode. V1 and V2 on the
Swin-V2 test config, V2 also on the BEiT test config.

Tolerances: 1e-4 on the raw outputs (two f32 stacks through a whole
model), and the ladder of tests/test_composition_oracle.py on the served
path: atol 1e-4 on inv_depth and seg, 5e-3 m on points (the depth head's
last conv is biased so inv stays near 0.3, which bounds the 1/inv
amplification), under 1 % of the grid's mass mismatched (a point within
float error of a voxel face may land one cell apart).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.models.heads import SegHead
from soccdpt_torch.models.soccdpt import (
    SOccDPT_V1,
    SOccDPT_V2,
    build_model,
    depth_net,
    seg_net,
)
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.weights import load_jax_variables

from test_torch_modules import perturbed_variables, to_np

JAX_MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))
MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))
torch.set_num_threads(2)  # the suite runs several worker processes side by side

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
CASES = [(1, "dpt_swin2_test_64"), (2, "dpt_swin2_test_64"), (2, "dpt_beittest_64")]
IDS = ["v1-swin2", "v2-swin2", "v2-beit"]
DEPTH_HEAD = {1: ("depth_net", "head"), 2: ("depth_head",)}


def _cfgs(version, model_type, **extra):
    kw = dict(model_type=model_type, version=version, features=64, **extra)
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **kw)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _stacks(version, model_type):
    """(JAX config, port config, JAX model, variables, port model, frames)."""
    jcfg, cfg = _cfgs(version, model_type)
    jmodel = jax_build_model(jcfg)
    init = jax.jit(lambda key, x: jmodel.init(key, x, return_raw=True))
    variables = perturbed_variables(init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64))), 0)
    # keep inv_depth near 0.3, where depth = 1 / inv stays well conditioned
    head = variables["params"]
    for scope in DEPTH_HEAD[version]:
        head = head[scope]
    head["conv3"]["kernel"] = head["conv3"]["kernel"] * 0.002
    head["conv3"]["bias"] = np.full_like(head["conv3"]["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, jmodel, variables, model, frames


@pytest.mark.parametrize("version,model_type", CASES, ids=IDS)
def test_raw_outputs_match_jax(version, model_type):
    _, _, jmodel, variables, model, _ = _stacks(version, model_type)
    x = np.random.default_rng(7).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want_inv, want_seg = jmodel.apply(variables, jnp.asarray(x), return_raw=True)
    with torch.no_grad():
        inv, seg = model(torch.from_numpy(x), return_raw=True)
    assert tuple(inv.shape) == want_inv.shape and inv.dim() == 3
    assert tuple(seg.shape) == want_seg.shape and seg.shape[:2] == (2, 3)
    np.testing.assert_allclose(to_np(inv), np.asarray(want_inv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(seg), np.asarray(want_seg), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("compute_occ", [False, True])
@pytest.mark.parametrize("version,model_type", CASES, ids=IDS)
def test_serving_matches_jax(version, model_type, compute_occ):
    jcfg, cfg, _, variables, model, frames = _stacks(version, model_type)
    want = jax_make_serving_fn(jcfg, variables, compute_occ=compute_occ)(jnp.asarray(frames))
    kernels = ("global_attention", "window_attention", "segment_sum")
    counts = [kernel_ops.launches()[k] for k in kernels]
    got = make_serving_fn(cfg, model, compute_occ=compute_occ, device="cpu")(frames)
    assert counts == [kernel_ops.launches()[k] for k in kernels]  # CPU: plain versions

    shapes = [(2, 48, 64), (2, 3, 48, 64), (2, 48, 64, 3)]
    for g, w, shape, atol, name in zip(
        got[:3], want[:3], shapes, (1e-4, 1e-4, 5e-3), ("inv_depth", "seg", "points")
    ):
        assert tuple(g.shape) == shape, name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)
    assert float(got[0].min()) > 0.1  # the band that bounds the depth amplification

    if not compute_occ:
        assert got[3] is None and want[3] is None
        return
    grid, wgrid = got[3].numpy(), np.asarray(want[3])
    assert grid.shape == (2, 16, 16, 8, 3)
    total = wgrid.sum()
    assert grid.sum() > 50.0 and total > 50.0, "degenerate fixture: the grid is empty"
    assert np.abs(grid - wgrid).sum() / total < 0.01


def test_v1_seg_head_is_sigmoid_whatever_the_config_says():
    """V1's segmentation DPT is always sigmoid; V2 and V3 follow
    ``cfg.sigmoid``. Same weights, ``sigmoid=False``: V1's outputs do not
    move, and match the JAX V1 built with ``sigmoid=False``."""
    _, cfg, _, variables, model, _ = _stacks(1, "dpt_swin2_test_64")
    jcfg_tanh, cfg_tanh = _cfgs(1, "dpt_swin2_test_64", sigmoid=False)
    tanh = load_jax_variables(SOccDPT_V1(cfg_tanh), variables).eval()
    assert isinstance(tanh.seg_net.head, SegHead) and tanh.seg_net.head.sigmoid
    assert not SOccDPT_V2(dataclasses.replace(cfg, version=2, sigmoid=False)).seg_head.sigmoid
    x = np.random.default_rng(8).standard_normal((1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        seg = to_np(tanh(torch.from_numpy(x), return_raw=True)[1])
        np.testing.assert_array_equal(seg, to_np(model(torch.from_numpy(x), return_raw=True)[1]))
    _, want = jax_build_model(jcfg_tanh).apply(variables, jnp.asarray(x), return_raw=True)
    np.testing.assert_allclose(seg, np.asarray(want), atol=1e-4, rtol=1e-4)
    assert 0.0 <= seg.min() and seg.max() <= 1.0


def test_v1_has_two_trunks_with_their_own_biases():
    """Each DPT of V1 has its own backbone, each folds its own attention
    biases; the seg DPT's fusion blocks carry BatchNorm, the depth DPT's
    do not."""
    _, _, _, _, model, _ = _stacks(1, "dpt_swin2_test_64")
    d, s = model.depth_net, model.seg_net
    assert d.backbone is not s.backbone
    attn_d, attn_s = d.backbone.stage0_block0.attn, s.backbone.stage0_block0.attn
    assert attn_d.bias_cache is not None and attn_s.bias_cache is not None
    assert not torch.equal(attn_d.bias_cache, attn_s.bias_cache)
    assert hasattr(s.refinenet1.res_conv_unit2, "bn1")
    assert not hasattr(d.refinenet1.res_conv_unit2, "bn1")


def test_load_jax_variables_rejects_another_versions_tree():
    _, _, _, v1_tree, _, _ = _stacks(1, "dpt_swin2_test_64")
    _, cfg, _, v2_tree, _, _ = _stacks(2, "dpt_swin2_test_64")
    v3 = build_model(dataclasses.replace(cfg, version=3), device="cpu")
    from soccdpt_torch.weights import to_jax_variables

    with pytest.raises(KeyError, match="missing .*seg_net.* unused .*seg_head"):
        load_jax_variables(SOccDPT_V1(dataclasses.replace(cfg, version=1)),
                           to_jax_variables(v3))
    with pytest.raises(KeyError, match="pretrained"):
        load_jax_variables(SOccDPT_V2(cfg), v1_tree)
    load_jax_variables(SOccDPT_V2(cfg), v2_tree)  # its own tree loads


@pytest.mark.parametrize("version", [1, 2])
def test_single_output_adapters(version):
    _, cfg, _, _, model, frames = _stacks(version, "dpt_swin2_test_64")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        inv, seg = model(x, return_raw=True)
        assert torch.equal(depth_net(model)(x, return_raw=True), inv)
        assert torch.equal(seg_net(model)(x, return_raw=True), seg)
    serve = make_serving_fn(cfg, model, device="cpu")
    full = serve(frames)
    assert torch.equal(depth_net(serve)(frames), full[0])
    assert torch.equal(seg_net(serve)(frames), full[1])


@pytest.mark.parametrize("version", [1, 2])
def test_build_model_needs_a_card_unless_told_cpu(monkeypatch, version):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(model_type="dpt_swin2_test_64", version=version, features=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, (SOccDPT_V1, SOccDPT_V2)) and not model.training
    assert next(model.parameters()).device.type == "cpu"
