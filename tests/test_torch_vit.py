"""The ViT/BEiT slice of the port against the JAX package, on the CPU.

Inputs and weights come from numpy seeds; one weight set goes from the
JAX variables tree into the port through ``load_jax_variables``
(``perturbed_variables`` moves every leaf off its init, so BEiT's
zero-initialised relative-position tables gather a bias that matters).
Both stacks run in f32. On the CPU the port's attention is K6's plain
version; the JAX side runs its einsum path and, once, its Pallas kernel
in interpret mode.

Tolerances: 5e-4 on backbone features, the bound
tests/test_global_attention.py holds the JAX backbone's two attention
paths to; 1e-5 on single layers; the ladder of tests/test_torch_serving.py
on the served path (1e-4 on inv_depth and seg, 5e-3 m on points, under
1 % of the grid's mass mismatched).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import linen as fnn

from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models.backbones import make_backbone as jax_make_backbone
from soccdpt_tpu.models.backbones.vit import Readout as JaxReadout
from soccdpt_tpu.models.backbones.vit import _beit_rel_pos_index as jax_rel_pos_index
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.vit import (
    VIT_CONFIGS,
    VIT_HOOKS,
    Readout,
    _beit_rel_pos_index,
)
from soccdpt_torch.models.bias_cache import build_inference_cache, cached_bias
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.weights import init_random_, load_jax_variables

from test_torch_modules import perturbed_variables, to_np

FEATURE_TOL = 5e-4
JAX_MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))
MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_beittest_64", version=3, features=64)


def _jax_backbone(name, hw=(64, 64), seed=0, use_pallas=None):
    bb = jax_make_backbone(name, use_pallas=use_pallas)[0]()
    x = np.random.default_rng(seed).standard_normal((2, *hw, 3)).astype(np.float32)
    # ViT keeps its pretrain-grid pos-embed whatever the input; BEiT's
    # tables are sized for the grid it is initialised at
    init_x = x if name.startswith("beit") else x[:, :64, :64]
    variables = perturbed_variables(bb.init(jax.random.PRNGKey(seed), jnp.asarray(init_x)), seed)
    return bb, variables, x


# --- backbones ---------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
@pytest.mark.parametrize("name", ["vittest_64", "beittest_64"])
def test_vit_stage_features_match_jax(name, hw):
    """Square input, and a non-square one: ViT resizes its pos-embed,
    BEiT gathers a non-square relative-position index."""
    bb, variables, x = _jax_backbone(name, hw)
    want = bb.apply(variables, jnp.asarray(x))
    factory, chans = make_backbone(name, input_size=hw)
    port = load_jax_variables(factory(), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert chans == (16, 32, 64, 128)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_beit_features_match_the_jax_pallas_path():
    """The JAX side through its flash kernel (interpret mode), as
    tests/test_global_attention.py runs it on the CPU."""
    bb, variables, x = _jax_backbone("beittest_64", use_pallas=True)
    want = bb.apply(variables, jnp.asarray(x), deterministic=True)
    port = load_jax_variables(make_backbone("beittest_64")[0](), variables)
    launches = kernel_ops.launches()["global_attention"]
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert kernel_ops.launches()["global_attention"] == launches  # CPU tensors: the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_vit_takes_another_input_size_than_it_was_built_for():
    bb, variables, _ = _jax_backbone("vittest_64")
    x = np.random.default_rng(3).standard_normal((1, 96, 96, 3)).astype(np.float32)
    want = bb.apply(variables, jnp.asarray(x))
    port = load_jax_variables(make_backbone("vittest_64")[0](), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_beit_at_the_transposed_grid_gathers_inline():
    """A table sized for an 8x12 grid also fits 12x8; the bias folded for
    8x12 does not, so the port gathers the 12x8 one inline, as the JAX
    cache, keyed by grid, misses."""
    bb, variables, x = _jax_backbone("beittest_64", (64, 96))
    xt = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    want = bb.apply(variables, jnp.asarray(xt))
    port = load_jax_variables(make_backbone("beittest_64", input_size=(64, 96))[0](), variables)
    assert tuple(port.block0.bias_cache.shape) == (2, 97, 97)
    with torch.no_grad():
        got = port(torch.from_numpy(xt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_beit_at_another_grid_raises_when_its_table_does_not_fit():
    port = make_backbone("beittest_64")[0]()
    with pytest.raises(ValueError, match="rel_pos_table"):
        port(torch.zeros(1, 96, 96, 3))


@pytest.mark.parametrize("grid", [(8, 8), (4, 6), (1, 3)])
def test_beit_rel_pos_index_equals_jax(grid):
    np.testing.assert_array_equal(_beit_rel_pos_index(*grid), jax_rel_pos_index(*grid))


@pytest.mark.parametrize("mode", ["project", "ignore"])
def test_readout_matches_jax(mode):
    tokens = np.random.default_rng(4).standard_normal((2, 17, 32)).astype(np.float32)
    jmod = JaxReadout(mode=mode, dim=32)
    variables = jmod.init(jax.random.PRNGKey(4), jnp.asarray(tokens))
    variables = perturbed_variables(variables, 4) if mode == "project" else {"params": {}}
    want = np.asarray(jmod.apply(variables, jnp.asarray(tokens)))
    port = load_jax_variables(Readout(mode, 32), variables)
    with torch.no_grad():
        got = to_np(port(torch.from_numpy(tokens)))
    assert got.shape == want.shape == (2, 16, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_loads_flipped(k):
    """flax's ConvTranspose correlates, torch's is the conv gradient: the
    loader must mirror the kernel along both spatial axes. An unflipped
    load keeps every shape and gets every value wrong."""
    x = np.random.default_rng(5).standard_normal((2, 5, 7, 6)).astype(np.float32)
    jmod = fnn.ConvTranspose(4, (k, k), strides=(k, k))
    variables = perturbed_variables(jmod.init(jax.random.PRNGKey(5), jnp.asarray(x)), 5)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))

    def run(mod):
        with torch.no_grad():
            return to_np(mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))

    port = load_jax_variables(nn.ConvTranspose2d(6, 4, k, stride=k), variables)
    np.testing.assert_allclose(run(port), want, atol=1e-5, rtol=1e-5)

    unflipped = nn.ConvTranspose2d(6, 4, k, stride=k)
    with torch.no_grad():
        kernel = np.ascontiguousarray(variables["params"]["kernel"].transpose(2, 3, 0, 1))
        unflipped.weight.copy_(torch.from_numpy(kernel))
        unflipped.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    assert run(unflipped).shape == want.shape
    assert np.abs(run(unflipped) - want).max() > 1e-2


def test_loader_raises_on_unused_and_missing_vit_keys():
    _, variables, _ = _jax_backbone("beittest_64")
    port = make_backbone("beittest_64")[0]()
    params = dict(variables["params"])
    params["pos_embed"] = np.zeros((1, 65, 32), np.float32)  # a ViT key BEiT lacks
    with pytest.raises(KeyError, match="pos_embed"):
        load_jax_variables(port, {"params": params})
    params = dict(variables["params"])
    params["block2"] = {k: v for k, v in params["block2"].items() if k != "rel_pos_table"}
    with pytest.raises(KeyError, match="block2.rel_pos_table"):
        load_jax_variables(port, {"params": params})


# --- the BEiT bias cache -------------------------------------------------------


def test_beit_bias_cache_is_never_stale():
    """The folded bias is served while the table is unchanged, and
    recomputed (not served) after a weight load."""
    _, variables, x = _jax_backbone("beittest_64")
    port = load_jax_variables(make_backbone("beittest_64")[0](), variables)
    blk = port.block1
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert cached_bias(blk) is blk.bias_cache
        assert tuple(blk.bias_cache.shape) == (2, 65, 65)
        before = port(xt)[3].clone()
        blk.rel_pos_table.mul_(2.0)  # a later weight load
        assert cached_bias(blk) is not blk.bias_cache
        np.testing.assert_array_equal(to_np(cached_bias(blk)), to_np(blk.compute_bias()))
        after = port(xt)[3]
        assert not torch.allclose(before, after)
        build_inference_cache(port)
        assert cached_bias(blk) is blk.bias_cache
        np.testing.assert_array_equal(to_np(port(xt)[3]), to_np(after))
    # ViT blocks own no bias and are not folded
    vit = make_backbone("vittest_64")[0]()
    build_inference_cache(vit)
    assert not hasattr(vit.block0, "bias_cache")


def test_bias_cache_dtype_stores_bf16():
    """``cache_dtype=torch.bfloat16``: every folded bias is stored in
    bf16 and the features stay close to the f32-cached forward (atol =
    rtol = 5e-2, the bound of the JAX package's test of the same knob)."""
    _, variables, x = _jax_backbone("beittest_64")
    port = load_jax_variables(make_backbone("beittest_64")[0](), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = [f.clone() for f in port(xt)]
        build_inference_cache(port, cache_dtype=torch.bfloat16)
        blocks = [getattr(port, f"block{i}") for i in range(4)]
        assert all(b.bias_cache.dtype == torch.bfloat16 for b in blocks)
        assert all(cached_bias(b) is b.bias_cache for b in blocks)
        got = port(xt)
    for g, w in zip(got, want):
        assert not torch.equal(g, w)  # the bf16 bias was the one read
        np.testing.assert_allclose(to_np(g), to_np(w), atol=5e-2, rtol=5e-2)


def test_init_random_gives_beit_a_bias_that_matters():
    port = init_random_(make_backbone("beittest_64")[0](), seed=1)
    assert float(port.block0.rel_pos_table.detach().std()) >= 0.45
    assert abs(float(port.block0.gamma_1.detach().mean()) - 0.1) < 0.02
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 64, 64, 3))).float()
    with torch.no_grad():
        want = port(x)[3].clone()
        for i in range(4):
            getattr(port, f"block{i}").rel_pos_table.zero_()
        flat = port(x)[3]
    assert float((want - flat).abs().max()) > 1e-2


# --- the seven names -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(VIT_CONFIGS))
def test_every_vit_name_builds(name):
    """Every config of the family builds (on the meta device: the large
    ones hold 300 M parameters) with the JAX package's widths, depth,
    hooks and table sizes."""
    from soccdpt_tpu.models.backbones.vit import VIT_CONFIGS as JAX_CONFIGS
    from soccdpt_tpu.models.backbones.vit import VIT_HOOKS as JAX_HOOKS

    cfg = VIT_CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_CONFIGS[name])
    assert VIT_HOOKS[name] == JAX_HOOKS[name]
    factory, chans = make_backbone(name)
    assert chans == jax_make_backbone(name)[1]
    with torch.device("meta"):
        bb = factory()
    g = cfg.img_size // cfg.patch_size
    assert bb.grid == (g, g) and bb.hooks == VIT_HOOKS[name]
    last = getattr(bb, f"block{cfg.depth - 1}")
    assert not hasattr(bb, f"block{cfg.depth}")
    assert tuple(last.qkv.weight.shape) == (3 * cfg.embed_dim, cfg.embed_dim)
    if cfg.family == "beit":
        assert tuple(last.rel_pos_table.shape) == ((2 * g - 1) ** 2 + 3, cfg.num_heads)
        assert last.qkv.bias is None and not hasattr(bb, "pos_embed")
    else:
        assert tuple(bb.pos_embed.shape) == (1, 1 + g * g, cfg.embed_dim)
        assert last.qkv.bias is not None and not hasattr(last, "rel_pos_table")


# --- V3 and the served path ------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **TINY)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True)
    variables = perturbed_variables(variables, 0)
    # keep inv_depth near 0.3, where depth = 1 / inv stays well conditioned
    head = variables["params"]["depth_net"]["head"]["conv3"]
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, jmodel, variables, model, frames


def test_v3_raw_outputs_match_jax(stacks):
    _, _, jmodel, variables, model, _ = stacks
    x = np.random.default_rng(7).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want_inv, want_seg = jmodel.apply(variables, jnp.asarray(x), return_raw=True)
    with torch.no_grad():
        inv, seg = model(torch.from_numpy(x), return_raw=True)
    assert tuple(inv.shape) == want_inv.shape and tuple(seg.shape) == want_seg.shape
    np.testing.assert_allclose(to_np(inv), np.asarray(want_inv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(to_np(seg), np.asarray(want_seg), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("compute_occ", [False, True])
def test_beit_serving_matches_jax(stacks, compute_occ):
    jcfg, cfg, _, variables, model, frames = stacks
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


def test_beit_serving_with_a_bf16_bias_cache(stacks):
    """``bias_cache_dtype=torch.bfloat16`` as the JAX package's knob: the
    folded biases are bf16, the outputs stay close to the f32-cached
    ones (a mean absolute difference under 1e-3 on inv_depth and seg)."""
    _, cfg, _, _, model, frames = stacks
    ref = make_serving_fn(cfg, model, device="cpu")(frames)
    got = make_serving_fn(cfg, model, device="cpu", bias_cache_dtype=torch.bfloat16)(frames)
    blk = model.depth_net.backbone.block0
    assert blk.bias_cache.dtype == torch.bfloat16
    for g, r in zip(got[:2], ref[:2]):
        assert torch.isfinite(g).all() and not torch.equal(g, r)
        assert float((g - r).abs().mean()) < 1e-3
    make_serving_fn(cfg, model, device="cpu")  # refold in f32 for the tests that follow
    assert blk.bias_cache.dtype == torch.float32
