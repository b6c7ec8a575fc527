"""The Swin-V1 backbone (``dpt_swin_large_384``'s ``swinl12_384``) of the
port against the JAX package, on the CPU; and the checks the three
backbone families of this file and of tests/test_torch_levit.py and
tests/test_torch_next_vit.py share.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``; ``perturbed_variables`` moves every leaf off its
init). Inputs come from numpy seeds. Both stacks run in f32. The test
config ``swin1test_64`` has a window of 5, so every stage pads (grids 16,
8 to 20, 10), the first two stages shift, and the last two clamp their
window (4, 2) and index the centre of the 5-window table.

Tolerances:

* ``FEATURE_TOL`` = 1e-4 (atol and rtol) on stage features (two f32
  stacks through every block); in training mode the atol is taken of the
  feature's largest magnitude where that exceeds 1 (every BatchNorm
  normalises by its batch's statistics, so f32 rounding grows with depth:
  1.4e-4 at LeViT's last stage at 128 px, whose values reach 2.6);
* ``BN_STATS_RTOL`` = 3e-5 of each leaf's norm on the running statistics
  after a training-mode forward (1e-5 for one module in
  tests/test_torch_training.py; here through a whole trunk);
* ``GRAD_RTOL`` = 2e-3 of each leaf's gradient norm, plus ``GRAD_ATOL`` =
  1e-6 of the largest leaf's norm for leaves whose gradient all but
  vanishes (a bias ahead of a training-mode BatchNorm), against
  ``jax.grad`` of the same weighted sum of the features, or of the V3 loss
  (``LOSS_RTOL`` = 1e-4), as tests/test_torch_training.py holds them.

In training mode the JAX side runs with flax's BatchNorm variance taken in
two passes (``two_pass_variance``), as the port takes it. flax's default,
E[x^2] - E[x]^2, cancels where a channel's mean dwarfs its spread: on
``nextvittest_64`` it moved JAX's own gradients by up to 1.8 % from a
float64 run of the same network. LeViT trains at 128 px (token grids 8,
4, 2): at 64 px its last grid is 1x1, and three tokens make statistics
that turn f32 rounding into 1e-3 of the features.

A backbone's training-mode gradients are held leaf by leaf to
``KINK_GRAD_RTOL`` = 5e-2 of each leaf's norm, and their median to
``GRAD_RTOL``. A pre-activation within rounding of a ReLU's kink may
take the kink's one side in one stack and the other side in the other,
and a training-mode BatchNorm after it spreads that unit's change over
the whole batch: on ``nextvittest_64`` one of features1's MLP units sits
at 4.6e-7, and every leaf before it differs by 0.4-4 % between any two
f32 runs (JAX's and the port's, or either and a float64 run), while the
leaves after it agree to 3e-6. A wrong gradient is off by its own size.
* the served path, SOccDPT V1, V2 and V3, to the ladder of
  tests/test_composition_oracle.py: 1e-4 on inv_depth and seg, 5e-3 m on
  points, under 1 % of the grid's mass mismatched.
"""
import contextlib
import dataclasses

import flax.linen.normalization as flax_norm
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
from soccdpt_tpu.models.backbones.swin import padded_attn_mask
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.core.config import TrainConfig
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.models.backbones import make_backbone
from soccdpt_torch.models.backbones.swin2 import shifted_window_attn_mask
from soccdpt_torch.models.soccdpt import SOccDPT_versions, build_model
from soccdpt_torch.serving import make_serving_fn
from soccdpt_torch.train.patchwise import select_trainable
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import _targets, _to_flax_layout, load_jax_variables
from soccdpt_torch.weights import named_flax_params, to_jax_variables

from test_torch_modules import perturbed_variables, to_np
from test_torch_training import GT_HW, _assert_same_leaves, _flat, _jax_loss

FEATURE_TOL = 1e-4
BN_STATS_RTOL = 3e-5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-3, 1e-6
KINK_GRAD_RTOL = 5e-2
TINY_TYPES = {"dpt_swin1test_64": ("swin1test_64", 64, 64),
              "dpt_levittest_64": ("levittest_64", 64, 64),
              "dpt_nextvittest_64": ("nextvittest_64", 64, 64)}
for _name, _spec in TINY_TYPES.items():
    JAX_MODEL_TYPES.setdefault(_name, _spec)
    MODEL_TYPES.setdefault(_name, _spec)
torch.set_num_threads(2)  # the suite runs several worker processes side by side

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
DEPTH_HEAD = {1: ("depth_net", "head"), 2: ("depth_head",), 3: ("depth_net", "head")}


# --- shared by the three families' files ---------------------------------------------


def _tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def check_backbone(name, x, train, seed=0, tweak=None, port_kw=(), makers=None, **overrides):
    """The port's backbone ``name`` against the JAX one on ``x`` (NHWC),
    under one perturbed weight set (``tweak`` edits it further;
    ``overrides`` replace fields of both factories, such as ``cfg``;
    ``port_kw`` fields of the port's alone, such as ``input_size``;
    ``makers`` the (JAX, port) functions that make the factories, the two
    registries' ``make_backbone`` unless given). In eval mode: the
    features. In training mode: the features, the running statistics after
    the forward, and every parameter's gradient of a weighted sum of the
    features."""
    jax_make, port_make = makers or (jax_make_backbone, make_backbone)
    jfactory, _ = jax_make(name)
    jbb = jfactory(**overrides)
    factory, chans = port_make(name)
    variables = perturbed_variables(jbb.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    if tweak is not None:
        variables = tweak(variables)
    port = load_jax_variables(factory(**overrides, **dict(port_kw)), variables)
    rng = np.random.default_rng(seed + 100)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if not train:
        want = jbb.apply(variables, xj)
        with torch.no_grad():
            got = port.eval()(xt)
        assert [g.shape[-1] for g in got] == list(chans)
        _close_features(got, want)
        return variables, port

    stats = variables.get("batch_stats", {})
    shapes = [w.shape for w in jbb.apply(variables, xj)]
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def loss(params, inputs):
        feats, updates = jbb.apply({"params": params, "batch_stats": stats}, inputs,
                                   deterministic=False, mutable=["batch_stats"])
        return sum(jnp.sum(f * w) for f, w in zip(feats, weights)), (feats, updates)

    with two_pass_variance():
        (_, (want, updates)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"], xj)
    port.train()
    got = port(xt)
    sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, weights)).backward()
    _close_features(got, want, scaled=True)
    if stats:
        _assert_same_leaves(to_jax_variables(port)["batch_stats"], _tree(updates["batch_stats"]),
                            BN_STATS_RTOL, what="batch_stats")
    got_g, want_g = _flat(to_jax_variables(port, grads=True)["params"]), _flat(_tree(grads))
    _assert_same_leaves(got_g, want_g, KINK_GRAD_RTOL, GRAD_ATOL, what="gradient")
    floor = GRAD_ATOL * max(float(np.linalg.norm(w)) for w in want_g.values())
    shares = [np.linalg.norm(got_g[k] - w) / (np.linalg.norm(w) + floor / GRAD_RTOL)
              for k, w in want_g.items()]
    assert np.median(shares) <= GRAD_RTOL, f"median leaf at {np.median(shares):.3g} of its norm"
    return variables, port


@contextlib.contextmanager
def two_pass_variance():
    """flax's training-mode BatchNorm takes its batch variance in two passes,
    E[(x - E[x])^2], as the port does, instead of its default
    E[x^2] - E[x]^2 (``use_fast_variance``): traced inside this block."""
    orig = flax_norm._compute_stats

    def compute_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return orig(*args, **kwargs)

    flax_norm._compute_stats = compute_stats
    try:
        yield
    finally:
        flax_norm._compute_stats = orig


def _close_features(got, want, scaled=False):
    """``scaled``: the atol is ``FEATURE_TOL`` of the feature's largest
    magnitude where that exceeds 1."""
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        atol = FEATURE_TOL * (max(1.0, float(np.abs(w).max())) if scaled else 1.0)
        np.testing.assert_allclose(to_np(g), w, atol=atol, rtol=FEATURE_TOL)


def flax_shapes(model):
    """{"params"/"batch_stats" path: shape} of a port model in the flax
    layouts; the model may live on the meta device."""
    out = {}
    for t, coll, path, layout in _targets(model):
        view = np.broadcast_to(np.zeros((), np.uint8), tuple(t.shape))
        out[f"{coll}:{path.replace('.', '/')}"] = tuple(_to_flax_layout(view, layout).shape)
    return out


def check_full_width_tree(model_type, version=3):
    """The JAX tree of ``model_type`` (``jax.eval_shape`` of its init:
    traced, nothing computed) against the port's parameter and statistic
    names and shapes, the port built on the meta device. Returns the
    number of parameters."""
    jcfg = JaxModelConfig(model_type=model_type, version=version)
    jmodel = jax_build_model(jcfg)
    w, h = jcfg.net_size
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, return_raw=True),
                            jax.ShapeDtypeStruct((1, 3, h, w), jnp.float32))
    want = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(coll, {}))[0]:
            want[f"{coll}:" + "/".join(str(k.key) for k in path)] = tuple(leaf.shape)
    with torch.device("meta"):
        port = SOccDPT_versions[version](ModelConfig(model_type=model_type, version=version))
    got = flax_shapes(port)
    assert sorted(set(got) ^ set(want)) == []
    assert got == want
    return sum(int(np.prod(s)) for k, s in got.items() if k.startswith("params:"))


def served_stacks(model_type, version, seed=0, tweak=None):
    """(JAX config, port config, variables, port model, frames) of a tiny
    model, the depth head's last conv scaled down and biased so inv_depth
    stays near 0.3 (Next-ViT's features are large enough that the 2e-3 of
    tests/test_torch_versions.py lets it reach 0 and below)."""
    kw = dict(model_type=model_type, version=version, features=32)
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **kw)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **kw)
    jmodel = jax_build_model(jcfg)
    init = jax.jit(lambda key, x: jmodel.init(key, x, return_raw=True))
    variables = perturbed_variables(init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 64, 64))),
                                    seed)
    if tweak is not None:
        variables = tweak(variables)
    head = variables["params"]
    for scope in DEPTH_HEAD[version]:
        head = head[scope]
    head["conv3"]["kernel"] = head["conv3"]["kernel"] * 2e-4
    head["conv3"]["bias"] = np.full_like(head["conv3"]["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    frames = np.random.default_rng(seed).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    return jcfg, cfg, variables, model, frames


def check_served(model_type, version, tweak=None):
    """A grid request of SOccDPT ``version`` through both packages'
    serving functions, held to the ladder."""
    jcfg, cfg, variables, model, frames = served_stacks(model_type, version, tweak=tweak)
    want = jax_make_serving_fn(jcfg, variables, compute_occ=True)(jnp.asarray(frames))
    kernels = ("window_attention", "segment_sum")
    counts = [kernel_ops.launches()[k] for k in kernels]
    got = make_serving_fn(cfg, model, compute_occ=True, device="cpu")(frames)
    assert counts == [kernel_ops.launches()[k] for k in kernels]  # CPU: plain versions
    shapes = [(2, 48, 64), (2, 3, 48, 64), (2, 48, 64, 3)]
    for g, w, shape, atol, name in zip(
        got[:3], want[:3], shapes, (1e-4, 1e-4, 5e-3), ("inv_depth", "seg", "points")
    ):
        assert tuple(g.shape) == shape, name
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=name)
    assert float(got[0].min()) > 0.1
    grid, wgrid = got[3].numpy(), np.asarray(want[3])
    assert grid.shape == (2, 16, 16, 8, 3)
    total = wgrid.sum()
    assert grid.sum() > 50.0 and total > 50.0, "degenerate fixture: the grid is empty"
    assert np.abs(grid - wgrid).sum() / total < 0.01


def check_loss_and_gradients(model_type, tweak=None, seg_scale=0.1):
    """The V3 loss of a fixed batch and every leaf's gradient against
    ``jax.value_and_grad``, both models deterministic (BatchNorm on its
    running statistics, no dropout or stochastic depth). The seg head's
    last conv is scaled by ``seg_scale``."""
    cfg = dict(model_type=model_type, version=3, features=32)
    jmodel = jax_build_model(JaxModelConfig(**cfg))
    variables = perturbed_variables(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True), 0)
    if tweak is not None:
        variables = tweak(variables)
    # keep the seg probabilities off the ends of f32's sigmoid, as
    # tests/test_torch_training.py does
    seg = variables["params"]["seg_head"]["conv2"]
    seg["kernel"] = seg["kernel"] * seg_scale
    trainer = Trainer(ModelConfig(**cfg), TrainConfig(batch_size=2, encoder_percentage=1.0),
                      device="cpu")
    trainer.init_state(0)
    load_jax_variables(trainer.model, variables)
    batch = make_batch(0, 2, GT_HW, (64, 64))
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, variables["batch_stats"], batch)))(variables["params"])
    model = trainer.model.eval()
    select_trainable(model, trainer.masks[0])
    model.zero_grad(set_to_none=True)
    loss, _ = trainer.loss(trainer.to_device_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    # the leaves no output reads (LeViT's blocks past its last hook) have no
    # gradient here, and a zero one in JAX
    zero = {k for k, g in _flat(_tree(want_grads)).items() if not np.any(g)}
    assert {p for p, t in named_flax_params(model) if t.grad is None} <= zero
    _assert_same_leaves(to_jax_variables(model, grads=True)["params"], _tree(want_grads),
                        GRAD_RTOL, GRAD_ATOL, what="gradient")


# --- Swin-V1 -------------------------------------------------------------------------

# (stage grid, window, shift) of every block of swinl12_384 at 256 px and of
# swin1test_64 at 64 px
MASK_SHAPES = [(64, 12, 0), (64, 12, 6), (32, 12, 0), (32, 12, 6), (16, 12, 0), (16, 12, 6),
               (8, 8, 0), (16, 5, 0), (16, 5, 2), (8, 5, 0), (8, 5, 2), (4, 4, 0), (2, 2, 0)]


@pytest.mark.parametrize("grid,ws,shift", MASK_SHAPES)
def test_mask_is_the_jax_one(grid, ws, shift):
    """Note the argument orders differ."""
    pad = -(-grid // ws) * ws
    got = shifted_window_attn_mask(grid, grid, ws, ws, shift, shift, pad, pad)
    want = padded_attn_mask(grid, grid, pad, pad, ws, ws, shift, shift)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid,queries", [(64, 1792), (32, 156), (16, 256)])
def test_shifted_blocks_let_real_queries_see_padding(grid, queries):
    """Pins a property of the JAX package's mask, which the port keeps:
    padding is marked at rows and columns past the grid in the *rolled*
    frame, so in a shifted block of swinl12_384 at 256 px real queries
    attend to padded keys that the roll moved into their region: 1,792 of
    4,096 at stage 0, 156 of 1,024 at stage 1, all 256 at stage 2."""
    ws, shift = 12, 6
    pad = -(-grid // ws) * ws
    mask = shifted_window_attn_mask(grid, grid, ws, ws, shift, shift, pad, pad)
    # the token at rolled position (i, j) is the one at ((i + s) % pad, (j + s) % pad)
    i, j = np.meshgrid(np.arange(pad), np.arange(pad), indexing="ij")
    real = (((i + shift) % pad) < grid) & (((j + shift) % pad) < grid)
    win = real.reshape(pad // ws, ws, pad // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    sees_pad = ((mask == 0) & ~win[:, None, :]).any(-1) & win
    assert int(win.sum()) == grid * grid
    assert int(sees_pad.sum()) == queries


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_swin1_features_match_jax(train):
    """Training mode with the stochastic depth at 0 on both sides (the two
    stacks cannot draw the same masks): features and every gradient."""
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    from soccdpt_tpu.models.backbones.swin import SWIN1_CONFIGS as JAX_CFGS

    from soccdpt_torch.models.backbones.swin import SWIN1_CONFIGS

    overrides = {}
    if train:
        cfg = dataclasses.replace(SWIN1_CONFIGS["swin1test_64"], drop_path_rate=0.0)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            dataclasses.replace(JAX_CFGS["swin1test_64"], drop_path_rate=0.0))
        overrides = {"cfg": cfg}
    check_backbone("swin1test_64", x, train, **overrides)


def test_swin1_table_is_sized_by_the_configured_window():
    """A clamped window reads the centre of the 12-window table, as in JAX."""
    factory, chans = make_backbone("swinl12_384", input_size=(256, 256))
    assert chans == (192, 384, 768, 1536)
    with torch.device("meta"):
        bb = factory()
    last = bb.stage3_block1
    assert (last.ws, last.shift, last.padded) == (8, 0, (8, 8))
    assert tuple(last.attn.rel_pos_table.shape) == (23 * 23, 48)
    assert bb.stage0_block1.padded == (72, 72) and bb.stage0_block1.shift == 6
    assert bb.stage2_block17.padded == (24, 24)
    idx = last.attn.position_index.reshape(64, 64)
    assert int(idx[0, 0]) == 11 * 23 + 11  # offset (0, 0): the table's centre


def test_drop_path_draws_from_the_generator():
    factory, _ = make_backbone("swin1test_64")
    bb = factory().train()
    np.testing.assert_allclose(bb.drop_path_rates, np.linspace(0, 0.1, 8))
    img = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        f1 = bb(img, generator=torch.Generator().manual_seed(2))
        f2 = bb(img, generator=torch.Generator().manual_seed(2))
        f3 = bb(img, generator=torch.Generator().manual_seed(3))
        assert torch.equal(f1[3], f2[3]) and not torch.equal(f1[3], f3[3])
        bb.eval()
        assert torch.equal(bb(img)[3], bb(img)[3])


def test_full_width_tree_is_the_jax_one():
    """``dpt_swin_large_384`` V3 at 256 px."""
    assert 200e6 < check_full_width_tree("dpt_swin_large_384") < 215e6


@pytest.mark.parametrize("version", [1, 2, 3])
def test_served_matches_jax(version):
    check_served("dpt_swin1test_64", version)


def test_loss_and_gradients_match_jax():
    check_loss_and_gradients("dpt_swin1test_64")
