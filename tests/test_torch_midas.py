"""MiDaS v2.1 and its ResNeXt trunk, the port against the JAX package
(``soccdpt_tpu/models/midas.py``, ``models/backbones/resnext.py``), on the
CPU in f32.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``, which raises on any key left unused on either
side); the images come from a numpy seed.

* ``resnexttest_64`` (four one-block stages, groups of 4): the features
  to 1e-4 in eval and in training mode, and in training mode the
  BatchNorm statistics after the forward and every parameter's gradient
  (``check_backbone`` of tests/test_torch_swin1.py, its bounds).
* ``MidasNetV21`` at full width (ResNeXt-101 32x8d, 104 M weights) on a
  64x64 input: inverse depth to atol 1e-4, the inv_depth rung of the
  ladder of tests/test_composition_oracle.py. Its kernels are moved off
  their init by 5 % of each value (not by an absolute 0.05, which at a
  fan-in of 2,304 is twice a kernel's own spread and grows the 33
  bottlenecks' and the decoder's activations past 1e11), the biases by
  an absolute 0.05, the running variances drawn from [0.8, 1.2]; the last
  conv's bias is set to 6 so that most of the ReLU'd output is not zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.models.backbones.resnext import make_resnext_backbone as jax_make_resnext
from soccdpt_tpu.models.midas import MidasNetV21 as JaxMidas

from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.resnext import RESNEXT_CONFIGS, make_resnext_backbone
from soccdpt_torch.models.midas import LegacyFusionBlock, MidasNetV21
from soccdpt_torch.weights import load_jax_variables, to_jax_variables

from test_torch_modules import to_np
from test_torch_swin1 import check_backbone

INV_DEPTH_ATOL = 1e-4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnext_features_match_jax(train):
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    _, port = check_backbone("resnexttest_64", x, train,
                             makers=(jax_make_resnext, make_resnext_backbone))
    with torch.no_grad():
        feats = port.eval()(torch.from_numpy(x))
    assert [tuple(f.shape) for f in feats] == [
        (2, 16, 16, 64), (2, 8, 8, 128), (2, 4, 4, 256), (2, 2, 2, 512)]


def test_resnext101_shapes_are_the_jax_ones():
    """The full-width trunk's tree, built on the meta device, has the JAX
    one's leaves and shapes: 3, 4, 23 and 3 bottlenecks of 32 groups."""
    jfactory, jchans = jax_make_resnext("resnext101_wsl")
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda xx: jfactory().init(jax.random.PRNGKey(0), xx), x)
    factory, chans = make_resnext_backbone("resnext101_wsl")
    assert chans == jchans == (256, 512, 1024, 2048)
    with torch.device("meta"):
        port = factory()
    got = {k: tuple(v.shape) for k, v in _flat(to_meta_tree(port)).items()}
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    assert got == want
    assert port.stage2_block22.conv2.groups == 32 and port.stage2_block22.conv2.in_channels == 1024
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(s)) for k, s in want.items() if k.startswith("params"))


def to_meta_tree(port):
    """``to_jax_variables`` reads values; on the meta device only shapes
    exist, so the tree's leaves are the shapes in flax layout."""
    from soccdpt_torch.weights import _targets, _to_flax_layout

    out = {"params": {}, "batch_stats": {}}
    for t, coll, path, layout in _targets(port):
        node = out[coll]
        *scopes, leaf = path.split(".")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = np.empty(_to_flax_layout(np.empty(t.shape, np.int8), layout).shape, np.int8)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_make_backbone_keeps_raising_on_resnext():
    """As the JAX registry, the port's builds no ResNeXt: MiDaS makes its
    own trunk."""
    with pytest.raises(ValueError, match="not implemented"):
        make_backbone("resnext101_wsl")
    assert set(RESNEXT_CONFIGS) == {"resnext101_wsl", "resnexttest_64"}


def _midas_variables(x):
    model = JaxMidas()
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(1)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return (a * (1.0 + 0.05 * rng.standard_normal(a.shape))).astype(np.float32)
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, variables)
    variables["params"]["head_conv3"]["bias"] = np.full((1,), 6.0, np.float32)
    return model, variables


def test_midas_v21_matches_jax_at_full_width():
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    jmodel, variables = _midas_variables(x)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(MidasNetV21(), variables).eval()
    assert sum(p.numel() for p in port.parameters()) > 80e6
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 64, 64) and got.dtype == torch.float32
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(to_np(got), want, atol=INV_DEPTH_ATOL, rtol=0)
    # the tree goes back unchanged
    back = to_jax_variables(port)
    for coll in ("params", "batch_stats"):
        flat_back, flat_want = _flat(back[coll]), _flat(variables[coll])
        assert flat_back.keys() == flat_want.keys()
        for k, w in flat_want.items():
            np.testing.assert_array_equal(flat_back[k], w, err_msg=k)


def test_midas_v21_bf16_runs_its_network_in_bf16():
    """``dtype`` is the network's compute dtype, as the JAX module's: the
    trunk's features come out in bf16 (BatchNorm computes in f32 and casts
    back) and the output is bf16."""
    torch.manual_seed(0)
    model = MidasNetV21(dtype=torch.bfloat16).eval()
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        feats = model.backbone(x.permute(0, 2, 3, 1).to(torch.bfloat16))
        out = model(x)
    assert all(f.dtype == torch.bfloat16 for f in feats)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 64, 64)


def test_fusion_blocks_take_a_skip_but_the_deepest():
    """flax makes ``rcu1`` only where the block is called with a skip:
    ``refinenet4`` has none."""
    assert not hasattr(LegacyFusionBlock(8, skip=False), "rcu1")
    assert hasattr(LegacyFusionBlock(8), "rcu1")


def test_loader_maps_grouped_convs_and_raises_on_unused_keys():
    """The grouped conv's flax kernel (3, 3, in / groups, out) loads as the
    torch weight (out, in / groups, 3, 3); a key the model does not have, or
    one it lacks, raises."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jfactory, _ = jax_make_resnext("resnexttest_64")
    variables = jax.tree_util.tree_map(
        np.asarray, jfactory().init(jax.random.PRNGKey(0), jnp.asarray(x)))
    factory, _ = make_resnext_backbone("resnexttest_64")
    port = load_jax_variables(factory(), variables)
    kernel = variables["params"]["stage1_block0"]["conv2"]["kernel"]
    assert kernel.shape == (3, 3, 8, 32) and port.stage1_block0.conv2.groups == 4
    np.testing.assert_array_equal(to_np(port.stage1_block0.conv2.weight),
                                  kernel.transpose(3, 2, 0, 1))
    extra = {"params": {**variables["params"], "head": {"kernel": np.zeros((1, 1))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(factory(), extra)
    params = dict(variables["params"])
    del params["stem_conv"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(factory(), {"params": params, "batch_stats": variables["batch_stats"]})
