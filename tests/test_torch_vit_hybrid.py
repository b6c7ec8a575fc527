"""The ViT-hybrid backbone (``dpt_hybrid_384``'s ResNet50 + ViT-B) of the
port against the JAX package, on the CPU.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``; ``perturbed_variables`` moves every leaf off its
init). Inputs come from numpy seeds. Both stacks run in f32; the port's
attention is K6's plain version on the CPU, the JAX trunk's its einsum.

Tolerances: 1e-4 (atol and rtol) on the backbone's features (weight
standardization, GroupNorm and twelve-block chains in two f32 stacks; the
first run measured 1e-5); the ladder of tests/test_composition_oracle.py
on the served path (1e-4 on inv_depth and seg, 5e-3 m on points, under 1 %
of the grid's mass mismatched); the loss to 1e-4 relative and every leaf's
gradient to 1e-2 of its norm (plus 1e-6 of the largest leaf's norm for
leaves whose gradient all but vanishes) against ``jax.value_and_grad``,
with dropout and stochastic depth off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models.backbones import make_backbone as jax_make_backbone
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn
from soccdpt_tpu.train import patchwise as jpw

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.core.config import TrainConfig
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.kernels.global_attention import global_attention, global_attention_backward
from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.vit_hybrid import HYBRID_CONFIGS, same_pads
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.train.patchwise import encoder_mask, patch_masks, select_trainable
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import load_jax_variables, named_flax_params, to_jax_variables

from test_torch_modules import perturbed_variables, to_np
from test_torch_training import GT_HW, _assert_same_leaves, _jax_loss

FEATURE_TOL = 1e-4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-2, 1e-6
JAX_MODEL_TYPES.setdefault("dpt_hybridtest_64", ("hybridtest_64", 64, 64))
MODEL_TYPES.setdefault("dpt_hybridtest_64", ("hybridtest_64", 64, 64))

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_hybridtest_64", version=3, features=32)


@pytest.mark.parametrize("size", [9, 16, 18, 36, 64, 72, 384])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (3, 2), (3, 1), (1, 2), (1, 1)])
def test_same_padding_is_tf_same(size, kernel, stride):
    """The pads flax's ``padding="SAME"`` takes (more after than before)."""
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("hw", [(64, 64), (72, 72), (64, 96)],
                         ids=["square", "odd-maps", "non-square"])
def test_hybrid_features_match_jax(hw):
    """72x72 puts odd maps (9x9 at /8) under the stride-2 layers, where
    TF-SAME pads only after; 64x96 makes a 4x6 grid at /16, so the 4x4
    position embedding is resized bilinearly."""
    bb = jax_make_backbone("hybridtest_64")[0]()
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    variables = perturbed_variables(
        bb.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :64, :64])), 0)
    want = bb.apply(variables, jnp.asarray(x))
    factory, chans = make_backbone("hybridtest_64")
    port = load_jax_variables(factory(), variables)
    launches = global_attention.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert global_attention.launches == launches  # CPU tensors: the plain version
    assert chans == HYBRID_CONFIGS["hybridtest_64"].post_channels == (128, 256, 32, 32)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FEATURE_TOL, rtol=FEATURE_TOL)


def test_hybrid_hooks_pick_the_vit_blocks_read_out():
    factory, _ = make_backbone("vitb_rn50_384")
    assert factory.keywords["cfg"].vit_hooks == (8, 11)
    factory, _ = make_backbone("vitb_rn50_384", hooks=(0, 1, 4, 7))
    assert factory.keywords["cfg"].vit_hooks == (4, 7)


def test_full_width_tree_is_the_jax_one():
    """``vitb_rn50_384``: the same flax paths as the JAX tree, each with as
    many weights (the layouts differ: ``weights.py``); JAX traces the init
    and computes nothing."""
    cfg = dict(model_type="dpt_hybrid_384", version=3)
    jmodel = jax_build_model(JaxModelConfig(**cfg))
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, return_raw=True),
                            jax.ShapeDtypeStruct((1, 3, 384, 384), jnp.float32))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    port = build_model(ModelConfig(**cfg), device="cpu")
    got = {path.replace(".", "/"): p.numel() for path, p in named_flax_params(port)}
    assert got == {path: int(np.prod(shape)) for path, shape in want.items()}
    assert 120e6 < sum(got.values()) < 125e6


@pytest.fixture(scope="module")
def served():
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **TINY)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    variables = perturbed_variables(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True), 0)
    # keep inv_depth near 0.3, as tests/test_torch_serving.py does
    head = variables["params"]["depth_net"]["head"]["conv3"]
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, variables, model, frames


@pytest.mark.parametrize("compute_occ", [False, True])
def test_dpt_hybrid_served_matches_jax(served, compute_occ):
    jcfg, cfg, variables, model, frames = served
    want = jax_make_serving_fn(jcfg, variables, compute_occ=compute_occ)(jnp.asarray(frames))
    got = make_serving_fn(cfg, model, compute_occ=compute_occ, device="cpu")(frames)
    shapes = [(2, 48, 64), (2, 3, 48, 64), (2, 48, 64, 3)]
    for g, w, shape, atol, name in zip(
        got[:3], want[:3], shapes, (1e-4, 1e-4, 5e-3), ("inv_depth", "seg", "points")
    ):
        assert tuple(g.shape) == shape, name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)
    assert float(got[0].min()) > 0.1
    if not compute_occ:
        assert got[3] is None and want[3] is None
        return
    grid, wgrid = got[3].numpy(), np.asarray(want[3])
    total = wgrid.sum()
    assert grid.sum() > 50.0 and total > 50.0, "degenerate fixture: the grid is empty"
    assert np.abs(grid - wgrid).sum() / total < 0.01


@pytest.fixture(scope="module")
def trained():
    jcfg = JaxModelConfig(**TINY)
    jmodel = jax_build_model(jcfg)
    variables = perturbed_variables(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True), 0)
    # keep the seg probabilities off the ends of f32's sigmoid: from the
    # perturbed tree, 6 % of them lie within 1e-6 of 1, where BCE's
    # 1 / (1 - p) turns f32 rounding of p (one ulp is 6e-8) into gradient
    # noise of both stacks (the seg head's leaves then differed by 1.7 %,
    # with the loss equal to 2e-7 and no probability clipped on one side only)
    seg = variables["params"]["seg_head"]["conv2"]
    seg["kernel"] = seg["kernel"] * 0.1
    trainer = Trainer(ModelConfig(**TINY), TrainConfig(batch_size=2, encoder_percentage=1.0),
                      device="cpu")
    trainer.init_state(0)
    load_jax_variables(trainer.model, variables)
    return jmodel, variables, trainer, make_batch(0, 2, GT_HW, (64, 64))


def test_dpt_hybrid_loss_and_gradients_match_jax(trained):
    jmodel, variables, trainer, batch = trained
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, variables["batch_stats"], batch)
    ))(variables["params"])
    model = trainer.model.eval()  # dropout off; no stochastic depth in this trunk
    select_trainable(model, trainer.masks[0])
    model.zero_grad(set_to_none=True)
    backwards = global_attention_backward.launches
    loss, _ = trainer.loss(trainer.to_device_batch(batch))
    loss.backward()
    assert global_attention_backward.launches == backwards  # CPU: the plain backward
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    assert all(p.grad is not None for _, p in named_flax_params(model))
    got = to_jax_variables(model, grads=True)["params"]
    _assert_same_leaves(got, jax.tree_util.tree_map(np.asarray, want_grads),
                        GRAD_RTOL, GRAD_ATOL, what="gradient")


def test_dpt_hybrid_masks_are_the_jax_partition(trained):
    """The published sweep's encoder 0.5 and patch-wise 0.5: the same
    leaves frozen and the same two patches, in the same leaf order."""
    _, variables, trainer, _ = trained
    jtrainable = jpw.encoder_mask(variables["params"], 0.5)
    got = encoder_mask(trainer.model, 0.5)
    want = {".".join(str(k.key) for k in path): bool(flag)
            for path, flag in jax.tree_util.tree_flatten_with_path(jtrainable)[0]}
    assert list(got) == list(want) and got == want
    patches, jpatches = patch_masks(got, 0.5), jpw.patch_masks(jtrainable, 0.5)
    assert len(patches) == len(jpatches) == 2
    for p, jp in zip(patches, jpatches):
        assert p == {".".join(str(k.key) for k in path): bool(flag)
                     for path, flag in jax.tree_util.tree_flatten_with_path(jp)[0]}
