"""The LeViT backbone (``dpt_levit_224``'s ``levit_384``) and the DPT's
stem transpose of the port against the JAX package, on the CPU.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``). ``perturbed_variables`` moves every leaf off its
init by N(0, 0.05); LeViT's attention biases, zeros at JAX's init, are
then drawn with a standard deviation of 0.5 (``_biased``), so that an
attention that gathered them wrongly could not pass. Inputs come from
numpy seeds; both stacks run in f32. ``levittest_64`` makes token grids
4, 2 and 1 at 64 px, so the subsample attention's ceil grid and strided
queries are exercised.

Tolerances are tests/test_torch_swin1.py's (stated there, with why): 1e-4
on features (in training mode of their largest magnitude); 3e-5 of each
leaf's norm on running statistics; 2e-3 of each leaf's norm (plus 1e-6 of
the largest) on gradients, in training mode 5e-2 leaf by leaf and 2e-3
for the median; 1e-4 on the V3 loss; the composition ladder on the
served path. The stem transpose against flax's
``ConvTranspose(3, stride 2, "SAME")``: 1e-5 (one conv chain). The
weight carrier's round trip is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.models.backbones.levit import BNDense as JaxBNDense
from soccdpt_tpu.models.backbones.levit import StemTranspose as JaxStemTranspose
from soccdpt_tpu.models.backbones.levit import _attn_bias_index
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model

from soccdpt_torch.core.config import MODEL_TYPES, ModelConfig
from soccdpt_torch.models.backbones import dpt_extras, make_backbone
from soccdpt_torch.models.backbones.levit import BNDense, StemTranspose, attn_bias_index
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.weights import load_jax_variables, to_jax_variables

from test_torch_modules import perturbed_variables, to_np
from test_torch_swin1 import (
    BN_STATS_RTOL,
    FEATURE_TOL,
    check_backbone,
    check_full_width_tree,
    check_loss_and_gradients,
    check_served,
    two_pass_variance,
)
from test_torch_training import _assert_same_leaves, _flat

STEM_TOL = 1e-5
# a tiny type at 128 px: token grids 8, 4, 2 (see tests/test_torch_swin1.py)
for _types in (JAX_MODEL_TYPES, MODEL_TYPES):
    _types.setdefault("dpt_levittest_128", ("levittest_64", 128, 128))


def _biased(variables, seed=0):
    """Every ``attn_bias`` drawn anew, std 0.5."""
    rng = np.random.default_rng(seed + 50)

    def leaf(path, x):
        if path[-1].key == "attn_bias":
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.mark.parametrize("case", [(14, 14, 14, 14, 1), (14, 14, 7, 7, 2), (7, 7, 4, 4, 2),
                                  (4, 4, 2, 2, 2), (2, 2, 1, 1, 2)])
def test_attn_bias_index_is_the_jax_one(case):
    np.testing.assert_array_equal(attn_bias_index(*case), _attn_bias_index(*case))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bndense_is_carried_both_ways(train):
    """``BatchNorm1d`` over the flattened tokens: loaded from the flax tree
    and written back exactly, and the same function in eval and training
    mode (batch statistics, then the moved running ones)."""
    x = np.random.default_rng(1).standard_normal((3, 10, 12)).astype(np.float32)
    jmod = JaxBNDense(features=16)
    variables = perturbed_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = load_jax_variables(BNDense(12, 16), variables)
    back = to_jax_variables(port)
    for coll in ("params", "batch_stats"):
        got, want = _flat(back[coll]), _flat(variables[coll])
        assert sorted(got) == sorted(want) == (
            ["bn.bias", "bn.scale", "linear.kernel"] if coll == "params" else ["bn.mean", "bn.var"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    if not train:
        want = jmod.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=FEATURE_TOL, rtol=FEATURE_TOL)
        return
    want, updates = jmod.apply(variables, jnp.asarray(x), deterministic=False,
                               mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=FEATURE_TOL, rtol=FEATURE_TOL)
    _assert_same_leaves(to_jax_variables(port)["batch_stats"],
                        jax.tree_util.tree_map(np.asarray, updates["batch_stats"]),
                        BN_STATS_RTOL, what="batch_stats")


@pytest.mark.parametrize("hw", [(4, 4), (7, 7), (5, 6), (28, 28)],
                         ids=["even", "odd", "mixed", "levit-224"])
def test_stem_transpose_pads_as_flax(hw):
    """flax pads the dilated map 2 before and 1 after; the port's
    ``ConvTranspose2d(padding=0)`` pads 2 and 2 and drops the last row and
    column. Even and odd maps both come out at exactly twice the size."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 16)).astype(np.float32)
    jmod = JaxStemTranspose()
    variables = perturbed_variables(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = jmod.apply(variables, jnp.asarray(x))
    port = load_jax_variables(StemTranspose(16), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 4 * hw[0], 4 * hw[1], 64)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=STEM_TOL, rtol=STEM_TOL)


def test_stem_transpose_batchnorm_stays_in_eval_mode():
    """Pins a JAX-package behaviour the port keeps: the DPT calls its stem
    transpose without ``deterministic``, so in training the stem's
    BatchNorms still read, and never move, their running statistics, where
    the reference's torch module would train them. SOccDPT V1 (two DPTs,
    BatchNorm in the seg decoder), one training-mode forward on both
    sides at 128 px: every running statistic as JAX moves it, the stems'
    unmoved."""
    cfg = dict(model_type="dpt_levittest_128", version=1, features=32)
    jmodel = jax_build_model(JaxModelConfig(**cfg))
    x = np.random.default_rng(3).standard_normal((4, 3, 128, 128)).astype(np.float32)
    variables = _biased(perturbed_variables(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), return_raw=True), 0))
    with two_pass_variance():
        _, updates = jmodel.apply(variables, jnp.asarray(x), deterministic=False,
                                  return_raw=True, mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(1)})
    model = load_jax_variables(build_model(ModelConfig(**cfg), device="cpu"), variables)
    model.train()
    stems = [model.depth_net.stem_transpose, model.seg_net.stem_transpose]
    assert not any(m.training for stem in stems for m in stem.modules())
    model(torch.from_numpy(x), return_raw=True, generator=torch.Generator().manual_seed(0))
    got = to_jax_variables(model)["batch_stats"]
    want = jax.tree_util.tree_map(np.asarray, updates["batch_stats"])
    _assert_same_leaves(got, want, BN_STATS_RTOL, what="batch_stats")
    before, after = _flat(variables["batch_stats"]), _flat(got)
    for k in before:
        moved = np.abs(after[k] - before[k]).max()
        if ".stem_transpose." in k:
            assert moved == 0.0, k
        else:
            assert moved > 1e-4, k
    # and the flag stays off through model.train() and model.eval()
    model.eval().train()
    assert not any(m.training for stem in stems for m in stem.modules())
    assert model.depth_net.backbone.stem0.bn.training


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_levit_features_match_jax(train):
    """Training mode: features, the batch statistics of every BatchNorm
    after the forward, and every parameter's gradient, at 128 px (token
    grids 8, 4, 2: see tests/test_torch_swin1.py)."""
    if not train:
        x = np.random.default_rng(0).standard_normal((3, 64, 64, 3)).astype(np.float32)
        _, port = check_backbone("levittest_64", x, train, tweak=_biased)
        grids = [(4, 4), (2, 2), (1, 1)]
    else:
        x = np.random.default_rng(0).standard_normal((4, 128, 128, 3)).astype(np.float32)
        _, port = check_backbone("levittest_64", x, train, tweak=_biased,
                                 port_kw={"input_size": (128, 128)})
        grids = [(8, 8), (4, 4), (2, 2)]
    assert [port.sequence[h][1] for h in port.hooks] == grids


def test_levit_wiring():
    """The three-level pyramid: hooks, widths, the refinenet3 size at the
    level-2 grid (7 at 224 px) and the stem transpose; the heads read the
    stem's 64 channels."""
    factory, chans = make_backbone("levit_384")
    assert factory.keywords["hooks"] == (3, 11, 21) and chans == (384, 512, 768)
    extras = dpt_extras("levit_384")
    assert extras["size_refinenet3"] == (7, 7) and extras["stem_transpose"] is StemTranspose
    assert dpt_extras("levittest_64")["size_refinenet3"] == (2, 2)
    with torch.device("meta"):
        from soccdpt_torch.models.soccdpt import SOccDPT_versions

        for version in (1, 2, 3):
            m = SOccDPT_versions[version](ModelConfig(model_type="dpt_levit_224", version=version))
            heads = {1: lambda: [m.depth_net.head, m.seg_net.head],
                     2: lambda: [m.depth_head, m.seg_head],
                     3: lambda: [m.depth_net.head, m.seg_head]}[version]()
            assert [h.conv1.in_channels for h in heads] == [64, 64]
            assert heads[0].conv1.out_channels == 32 and heads[0].conv3.in_channels == 8


def test_full_width_tree_is_the_jax_one():
    """``dpt_levit_224`` V3 at 224 px."""
    assert 45e6 < check_full_width_tree("dpt_levit_224") < 60e6


@pytest.mark.parametrize("version", [1, 2, 3])
def test_served_matches_jax(version):
    check_served("dpt_levittest_64", version, tweak=_biased)


def test_loss_and_gradients_match_jax():
    check_loss_and_gradients("dpt_levittest_64", tweak=_biased)
