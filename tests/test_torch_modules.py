"""Port modules against their JAX counterparts, on the CPU.

Inputs and weights come from numpy seeds; weights go from the JAX
package's variables tree into the port through
``soccdpt_torch.weights.load_jax_variables``, so both stacks compute with
one weight set. Both run in f32, the JAX modules with
``deterministic=True`` and the port's in ``eval()`` mode (train mode is
held to flax in tests/test_torch_training.py).

Tolerances: ``ATOL``/``RTOL`` = 1e-4 for whole modules, the bound the
JAX package's own whole-trunk tests use (two f32 stacks summing in
different orders); 1e-5 for resizes, the bound of tests/test_resize.py.
"""
import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.data.transforms import device_preprocess as jax_preprocess
from soccdpt_tpu.models.backbones.swin2 import SWIN2_CONFIGS, SwinV2Backbone
from soccdpt_tpu.models.dpt import DPT as JaxDPT
from soccdpt_tpu.models.heads import DepthHead as JaxDepthHead
from soccdpt_tpu.models.heads import SegHead as JaxSegHead
from soccdpt_tpu.ops.resize import resize_hw as jax_resize_hw
from soccdpt_tpu.ops.resize import resize_nchw as jax_resize_nchw

from soccdpt_torch.data.transforms import device_preprocess
from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.swin2 import SwinV2Backbone as PortBackbone
from soccdpt_torch.models.bias_cache import build_inference_cache, cached_bias
from soccdpt_torch.models.dpt import DPT
from soccdpt_torch.models.heads import DepthHead, SegHead
from soccdpt_torch.ops.resize import resize_hw, resize_nchw
from soccdpt_torch.weights import load_jax_variables

ATOL = RTOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def perturbed_variables(variables, seed):
    """A flax variables tree as numpy, every leaf moved off its init so a
    weight that fails to load cannot agree by accident: params get
    N(0, 0.05) added, BatchNorm variances are drawn from [0.8, 1.2]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


def to_np(t):
    return t.detach().float().numpy()


# --- resize and preprocessing --------------------------------------------

RESIZE_CASES = [
    ((16, 16), (32, 32), "bilinear", True),  # fusion 2x upsample
    ((13, 17), (29, 31), "bilinear", True),
    ((32, 32), (27, 54), "bicubic", False),  # output resize
    ((96, 160), (64, 64), "bicubic", False),  # preprocessing downscale
    ((16, 16), (40, 56), "nearest", False),  # seg upsample
    ((33, 17), (8, 8), "bilinear", False),
]


@pytest.mark.parametrize("in_hw,out_hw,mode,ac", RESIZE_CASES)
def test_resize_matches_jax(in_hw, out_hw, mode, ac):
    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = np.asarray(jax_resize_nchw(x, out_hw, mode, ac))
    got = to_np(resize_nchw(torch.from_numpy(x), out_hw, mode, ac))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x_nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(jax_resize_hw(x_nhwc, out_hw, mode, ac))
    got = to_np(resize_hw(torch.from_numpy(x_nhwc), out_hw, mode, ac))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frame_hw", [(48, 64), (108, 192)])
def test_device_preprocess_matches_jax(frame_hw):
    """Upscale and the non-antialiased bicubic downscale to net size."""
    frames = np.random.default_rng(1).integers(0, 256, (2, *frame_hw, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(frames), (64, 64)))
    got = to_np(device_preprocess(torch.from_numpy(frames), (64, 64)))
    assert got.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --- Swin-V2 trunk ---------------------------------------------------------


def _jax_backbone(seed=0):
    bb = SwinV2Backbone(cfg=SWIN2_CONFIGS["swin2test_64"], hooks=(1, 1, 1, 1))
    x = np.random.default_rng(seed).standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = perturbed_variables(bb.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    return bb, variables, x


def test_swin2_stage_features_match_jax():
    bb, variables, x = _jax_backbone()
    want = bb.apply(variables, jnp.asarray(x))
    factory, chans = make_backbone("swin2test_64")
    port = load_jax_variables(factory(), variables).eval()
    got = port(torch.from_numpy(x))
    assert chans == (16, 32, 64, 128)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_swin2_flagship_geometry():
    """At 256 px stage 3 runs ws=8 (N=64), stage 2 runs unshifted, the
    odd blocks of stages 0-1 carry the -100 shift mask, and the attention
    widths match the kernel table (d = 32, N = 256/64)."""
    bb = PortBackbone(SWIN2_CONFIGS["swin2t16_256"], (1, 1, 5, 1), (256, 256))
    blocks = {i: getattr(bb, f"stage{i}_block1") for i in range(4)}
    assert [b.ws for b in blocks.values()] == [16, 16, 16, 8]
    assert [b.shift for b in blocks.values()] == [8, 8, 0, 0]
    assert bb.stage2_block1.attn_mask is None and bb.stage0_block0.attn_mask is None
    m = bb.stage0_block1.attn_mask
    assert tuple(m.shape) == (16, 256, 256) and set(m.unique().tolist()) == {-100.0, 0.0}
    assert [b.attn.dim // b.attn.num_heads for b in blocks.values()] == [32] * 4


def test_bias_cache_is_never_stale():
    """The folded rel-pos bias is served while the weights are unchanged,
    and recomputed (not served) after a weight load."""
    _, variables, x = _jax_backbone()
    port = load_jax_variables(make_backbone("swin2test_64")[0](), variables).eval()
    attn = port.stage0_block0.attn
    with torch.no_grad():
        assert cached_bias(attn) is attn.bias_cache
        before = port(torch.from_numpy(x))[0].clone()
        attn.cpb_mlp_1.weight.mul_(2.0)  # a later weight load
        assert cached_bias(attn) is not attn.bias_cache
        fresh = attn.compute_bias()
        np.testing.assert_array_equal(to_np(cached_bias(attn)), to_np(fresh))
        after = port(torch.from_numpy(x))[0]
        assert not torch.allclose(before, after)
        build_inference_cache(port)
        assert cached_bias(attn) is attn.bias_cache
        np.testing.assert_array_equal(to_np(port(torch.from_numpy(x))[0]), to_np(after))


def test_load_jax_variables_rejects_unused_and_missing():
    _, variables, _ = _jax_backbone()
    port = make_backbone("swin2test_64")[0]()
    extra = {"params": {**variables["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(port, extra)
    params = dict(variables["params"])
    params.pop("patch_norm")
    with pytest.raises(KeyError, match="patch_norm"):
        load_jax_variables(port, {"params": params})


# --- DPT decoder and heads -------------------------------------------------


def test_dpt_decoder_matches_jax():
    jfactory = functools.partial(
        SwinV2Backbone, cfg=SWIN2_CONFIGS["swin2test_64"], hooks=(1, 1, 1, 1)
    )
    jdpt = JaxDPT(
        backbone=jfactory, in_channels=(16, 32, 64, 128),
        head=functools.partial(JaxDepthHead, head_features_1=64, head_features_2=32),
        features=64, return_features=True,
    )
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    variables = perturbed_variables(jdpt.init(jax.random.PRNGKey(2), jnp.asarray(x)), 2)
    want_out, want_feat = jdpt.apply(variables, jnp.asarray(x))

    factory, chans = make_backbone("swin2test_64")
    port = DPT(
        backbone=factory, in_channels=chans,
        head=functools.partial(DepthHead, 64, 64, 32, True),
        features=64, return_features=True,
    )
    load_jax_variables(port, variables).eval()
    with torch.no_grad():
        got_out, got_feat = port(torch.from_numpy(x))
    assert tuple(got_out.shape) == want_out.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(to_np(got_feat), np.asarray(want_feat), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(to_np(got_out), np.asarray(want_out), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("non_negative", [True, False])
def test_depth_head_matches_jax(non_negative):
    jhead = JaxDepthHead(head_features_1=64, head_features_2=32, non_negative=non_negative)
    x = np.random.default_rng(3).standard_normal((2, 12, 10, 64)).astype(np.float32)
    variables = perturbed_variables(jhead.init(jax.random.PRNGKey(3), jnp.asarray(x)), 3)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(DepthHead(64, 64, 32, non_negative), variables)
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(x)))
    assert got.shape == want.shape == (2, 24, 20, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sigmoid", [True, False])
def test_seg_head_matches_jax(sigmoid):
    jhead = JaxSegHead(num_classes=3, features=64, sigmoid=sigmoid)
    x = np.random.default_rng(4).standard_normal((2, 12, 10, 64)).astype(np.float32)
    variables = perturbed_variables(jhead.init(jax.random.PRNGKey(4), jnp.asarray(x)), 4)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(SegHead(3, 64, sigmoid), variables).eval()
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(x)))
    assert got.shape == want.shape == (2, 24, 20, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# --- package rules ---------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, soccdpt_torch\n"
        "for m in pkgutil.walk_packages(soccdpt_torch.__path__, 'soccdpt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'soccdpt_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True)


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "flax", "soccdpt_tpu")]


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.serving import make_serving_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(model_type="dpt_swin2_test_64", features=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_fn(cfg, model)
    assert next(model.parameters()).device.type == "cpu"


def test_unported_parts_raise():
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.backbones import dpt_extras
    from soccdpt_torch.models.soccdpt import build_model

    # every backbone of the JAX package is ported; a name it does not know
    # raises as the JAX registry does, and only LeViT needs DPT wiring
    with pytest.raises(ValueError, match="not implemented"):
        make_backbone("resnext101_wsl")
    assert dpt_extras("swinl12_384") == dpt_extras("next_vit_large_6m") == {}
    assert set(dpt_extras("levit_384")) == {"size_refinenet3", "stem_transpose"}
    # config/SOccDPT_V4_*.json names a version the JAX package does not have
    with pytest.raises(ValueError, match="V4"):
        build_model(ModelConfig(model_type="dpt_swin2_test_64", version=4), device="cpu")
