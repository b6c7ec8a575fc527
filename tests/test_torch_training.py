"""Training with the port against the JAX package, on the CPU.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``) and gradients, updated parameters and running
statistics come back under the flax paths (``to_jax_variables``), so the
two stacks are compared leaf by leaf; a leaf present on one side only
fails the comparison. Inputs come from numpy seeds. Both stacks run in
f32; the JAX BEiT trunk runs its Pallas attention, forward and backward,
in interpret mode, as the JAX package's own tests do on the CPU.

Tolerances:

* ``BN_TOL`` = 1e-4 on train-mode module outputs and 1e-5 on the updated
  running statistics (flax takes the variance as E[x^2] - E[x]^2, the port
  as E[(x - E[x])^2]);
* ``LOSS_RTOL`` = 1e-4 on the V3 loss;
* ``GRAD_RTOL`` = 2e-3 of each leaf's gradient norm, plus ``GRAD_ATOL`` =
  1e-6 of the largest leaf norm for leaves whose gradient all but
  vanishes: two f32 stacks through a whole model and a resize inside the
  loss. The leaves behind an attention bias are the worst: softmax ignores
  a shift of a row's bias, so their gradients are sums of terms that
  cancel;
* ``ADAM_TOL`` = 1e-6 (atol and rtol) on parameters after three optimizer
  steps: the same arithmetic in f32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccdpt_tpu.core.config import MODEL_TYPES as JAX_MODEL_TYPES
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import TrainConfig as JaxTrainConfig
from soccdpt_tpu.models.dpt import ResidualConvUnit as JaxRCU
from soccdpt_tpu.models.heads import SegHead as JaxSegHead
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.ops.resize import resize_nchw as jax_resize_nchw
from soccdpt_tpu.train import losses as jl
from soccdpt_tpu.train import patchwise as jpw
from soccdpt_tpu.train.trainer import PlateauScheduler as JaxPlateau
from soccdpt_tpu.train.trainer import make_optimizer as jax_make_optimizer

from soccdpt_torch.core.config import MODEL_TYPES, ModelConfig, TrainConfig
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.models.dpt import ResidualConvUnit
from soccdpt_torch.models.heads import SegHead
from soccdpt_torch.train.patchwise import (
    encoder_mask,
    mask_fraction,
    patch_masks,
    select_trainable,
)
from soccdpt_torch.train.trainer import PlateauScheduler, Trainer, TrainState, make_optimizer
from soccdpt_torch.weights import load_jax_variables, named_flax_params, to_jax_variables

from test_torch_modules import perturbed_variables, to_np

BN_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-6
ADAM_TOL = 1e-6

JAX_MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))
MODEL_TYPES.setdefault("dpt_beittest_64", ("beittest_64", 64, 64))
torch.set_num_threads(2)  # the suite runs several worker processes side by side
FAMILIES = {"beit": "dpt_beittest_64", "swin2": "dpt_swin2_test_64"}
TINY = dict(version=3, features=32)
GT_HW = (48, 80)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _assert_same_leaves(got_tree, want_tree, rtol, atol_of_max=0.0, what=""):
    """Leaf by leaf in 2-norm; a leaf on one side only fails."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    floor = atol_of_max * max(float(np.linalg.norm(w)) for w in want.values())
    worst = ("", 0.0)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = float(np.linalg.norm(got[path] - w))
        bound = rtol * float(np.linalg.norm(w)) + floor
        assert err <= bound, f"{what} {path}: |diff| {err:.3g} over {bound:.3g}"
        worst = max(worst, (path, err / max(bound, 1e-30)), key=lambda t: t[1])
    return worst


# --- train-mode BatchNorm --------------------------------------------------------


def _train_mode_case(jmod, port, x, seed):
    variables = perturbed_variables(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    want, updates = jmod.apply(
        variables, jnp.asarray(x), deterministic=False, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)},
    )
    load_jax_variables(port, variables).train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=BN_TOL, rtol=BN_TOL)
    stats = to_jax_variables(port)["batch_stats"]
    _assert_same_leaves(stats, jax.tree_util.tree_map(np.asarray, updates["batch_stats"]),
                        rtol=1e-5, what="batch_stats")
    # and they moved: the statistics before the step are not the ones after
    before = _flat(variables["batch_stats"])
    assert all(np.abs(_flat(stats)[k] - before[k]).max() > 1e-3 for k in before)
    return variables, port


def test_seg_head_train_mode_matches_flax():
    """Batch statistics in the forward, updated running statistics after
    it; dropout at rate 0, where the two stacks draw nothing."""
    x = np.random.default_rng(1).standard_normal((3, 10, 12, 32)).astype(np.float32)
    jmod = JaxSegHead(num_classes=3, features=32, dropout_rate=0.0)
    _train_mode_case(jmod, SegHead(3, 32, dropout_rate=0.0), x, seed=1)


def test_rcu_with_batchnorm_train_mode_matches_flax():
    x = np.random.default_rng(2).standard_normal((2, 9, 7, 16)).astype(np.float32)
    _train_mode_case(JaxRCU(features=16, use_bn=True), ResidualConvUnit(16, use_bn=True), x, seed=2)


def test_running_variance_is_the_biased_one():
    """flax stores the biased batch variance; ``nn.BatchNorm2d`` would store
    the unbiased one. The port is held to flax."""
    head = SegHead(3, 8, dropout_rate=0.0).train()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 4, 8)).astype(np.float32))
    with torch.no_grad():
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), head.conv1.weight, padding=1)
    head(x)
    n = y.numel() // 8
    biased = y.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(
        to_np(head.bn.running_var), to_np(0.9 * torch.ones(8) + 0.1 * biased), rtol=1e-5
    )
    assert float((head.bn.running_var - (0.9 + 0.1 * biased * n / (n - 1))).abs().max()) > 1e-4
    mean = y.mean(dim=(0, 2, 3))
    np.testing.assert_allclose(to_np(head.bn.running_mean), to_np(0.1 * mean), rtol=1e-4, atol=1e-6)


def test_eval_mode_leaves_the_running_statistics_alone():
    head = SegHead(3, 8).eval()
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    head(x)
    assert float(head.bn.running_mean.abs().max()) == 0.0
    np.testing.assert_array_equal(to_np(head(x)), to_np(head(x)))  # and no dropout


def test_dropout_and_drop_path_draw_from_the_generator():
    head = SegHead(3, 8).train()
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    a = head(x, torch.Generator().manual_seed(5))
    b = head(x, torch.Generator().manual_seed(5))
    c = head(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    trainer = Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), TrainConfig(), device="cpu")
    trainer.init_state(0)
    backbone = trainer.model.depth_net.backbone
    rates = backbone.drop_path_rates
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 8))  # the JAX package's linspace
    img = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        f1 = backbone(img, generator=torch.Generator().manual_seed(2))
        f2 = backbone(img, generator=torch.Generator().manual_seed(2))
        f3 = backbone(img, generator=torch.Generator().manual_seed(3))
        assert torch.equal(f1[3], f2[3]) and not torch.equal(f1[3], f3[3])
        backbone.eval()
        assert torch.equal(backbone(img)[3], backbone(img)[3])


# --- V3 loss and gradients ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_side(family, seed=0):
    """The JAX model and one perturbed weight set. The seg head's last conv
    is scaled down so its probabilities stay off 0 and 1: the BCE's
    gradient there is 1 / (1 - p), and a saturated pixel would turn one ulp
    of p into the whole gradient."""
    jmodel = jax_build_model(JaxModelConfig(model_type=FAMILIES[family], **TINY))
    init = jax.jit(lambda key, x: jmodel.init(key, x, return_raw=True))
    variables = perturbed_variables(init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 64, 64))), seed)
    conv2 = variables["params"]["seg_head"]["conv2"]
    conv2["kernel"] = conv2["kernel"] * 0.1
    return jmodel, variables


def _stacks(family, seed=0):
    """(JAX model, variables, port trainer with those weights, batch)."""
    model_type = FAMILIES[family]
    jmodel, variables = _jax_side(family, seed)
    trainer = Trainer(
        ModelConfig(model_type=model_type, **TINY),
        TrainConfig(batch_size=2, encoder_percentage=1.0), device="cpu",
    )
    trainer.init_state(seed)
    load_jax_variables(trainer.model, variables)
    return jmodel, variables, trainer, make_batch(seed, 2, GT_HW, (64, 64))


def _jax_loss(jmodel, params, batch_stats, batch):
    """The loss of soccdpt_tpu/train/trainer.py's ``loss_fn``, with the
    model deterministic (dropout cannot be matched across stacks)."""
    inv_depth, seg = jmodel.apply(
        {"params": params, "batch_stats": batch_stats}, jnp.asarray(batch["image"]),
        deterministic=True, return_raw=True,
    )
    l_disp = jl.ssi_loss_from_net(
        inv_depth.astype(jnp.float32), jnp.asarray(batch["disparity"]),
        jnp.asarray(batch["mask_disp"], jnp.float32),
    )
    seg_pred = jax_resize_nchw(seg.astype(jnp.float32), GT_HW, "nearest")
    l_seg = jl.masked_bce_loss(
        seg_pred, jnp.asarray(batch["seg"]), jnp.asarray(batch["mask_seg"], jnp.float32)
    )
    return 0.5 * l_disp + 0.5 * l_seg


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_v3_loss_and_gradients_match_jax(family):
    jmodel, variables, trainer, batch = _stacks(family)
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, variables["batch_stats"], batch)
    ))(variables["params"])

    model = trainer.model.eval()
    select_trainable(model, trainer.masks[0])
    backwards = kernel_ops.launches()["global_attention_backward"]
    loss, aux = trainer.loss(trainer.to_device_batch(batch))
    loss.backward()
    assert kernel_ops.launches()["global_attention_backward"] == backwards  # CPU: plain
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    assert set(aux) == {"loss_disp", "loss_seg"}
    assert all(p.grad is not None for _, p in named_flax_params(model))
    got = to_jax_variables(model, grads=True)["params"]
    want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    path, share = _assert_same_leaves(got, want_grads, GRAD_RTOL, GRAD_ATOL, what="gradient")
    print(f"{family}: worst leaf {path} at {share:.2f} of its bound")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_to_jax_variables_round_trips(family):
    _, variables, trainer, _ = _stacks(family)
    back = to_jax_variables(trainer.model)
    assert sorted(back) == ["batch_stats", "params"]
    for coll in back:
        got, want = _flat(back[coll]), _flat(variables[coll])
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)


# --- masks ---------------------------------------------------------------------------


def _jax_mask_dict(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): bool(flag) for path, flag in leaves}


def _version_stacks(family, version):
    """(the JAX params tree's shapes, a port trainer) of SOccDPT V1 or V2:
    a partition needs the tree's paths only, so JAX traces the init and
    computes nothing."""
    cfg = dict(model_type=FAMILIES[family], version=version, features=32)
    jmodel = jax_build_model(JaxModelConfig(**cfg))
    variables = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, return_raw=True),
                               jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32))
    trainer = Trainer(ModelConfig(**cfg), TrainConfig(batch_size=2, encoder_percentage=1.0),
                      device="cpu")
    trainer.init_state(0)
    return variables, trainer


@pytest.mark.parametrize("family,version", [("beit", 3), ("swin2", 3), ("swin2", 1), ("swin2", 2)],
                         ids=["beit", "swin2", "swin2-v1", "swin2-v2"])
def test_masks_are_the_jax_partition(family, version):
    """``encoder_percentage`` 0.5 and ``patchwise_percentage`` 0.34: the
    same leaves frozen, the same three patches, in the same leaf order.
    V1 has two encoders (``depth_net.backbone``, ``seg_net.backbone``);
    V2's whole trunk, decoder included, lies under ``pretrained`` and so
    counts as encoder, as it does in the JAX package."""
    if version == 3:
        _, variables, trainer, _ = _stacks(family)
    else:
        variables, trainer = _version_stacks(family, version)
    params = variables["params"]
    if version == 2:
        frozen = {p for p, flag in encoder_mask(trainer.model, 0.0).items() if not flag}
        assert "pretrained.refinenet1.out_conv.kernel" in frozen
        assert frozen == {p for p, _ in named_flax_params(trainer.model)
                          if p.startswith("pretrained.")}
    jtrainable = jpw.encoder_mask(params, 0.5)
    want = _jax_mask_dict(jtrainable)
    got = encoder_mask(trainer.model, 0.5)
    assert list(got) == list(want)  # the enumeration order itself
    assert got == want
    assert 0 < sum(got.values()) < len(got)
    jpatches = jpw.patch_masks(jtrainable, 0.34)
    patches = patch_masks(got, 0.34)
    assert len(patches) == len(jpatches) == 3
    for p, jp in zip(patches, jpatches):
        assert p == _jax_mask_dict(jp)
        assert mask_fraction(p) == pytest.approx(jpw.mask_fraction(jp))
    # disjoint, and together the trainable set
    assert [sum(col) for col in zip(*(p.values() for p in patches))] == [int(f) for f in got.values()]
    assert named_flax_params(trainer.model)[0][0] == list(want)[0]
    assert [n for n, _ in trainer.model.named_parameters()] != [
        n for n, _ in named_flax_params(trainer.model)
    ]  # which is why the order is taken from the flax paths


def test_select_trainable_sets_requires_grad():
    trainer = Trainer(
        ModelConfig(model_type=FAMILIES["swin2"], **TINY),
        TrainConfig(encoder_percentage=0.5, patchwise_percentage=0.34), device="cpu",
    )
    trainer.init_state(0)
    assert len(trainer.masks) == 3
    select_trainable(trainer.model, trainer.masks[1])
    flags = {path: p.requires_grad for path, p in named_flax_params(trainer.model)}
    assert flags == trainer.masks[1]
    with pytest.raises(ValueError):
        patch_masks({path: False for path in flags}, 0.5)
    with pytest.raises(ValueError):
        encoder_mask(trainer.model, 1.5)


# --- the optimizer ---------------------------------------------------------------------


def test_masked_adamw_matches_optax_under_two_patch_masks():
    """Three steps, each with two patch masks, weight decay on, one leaf
    frozen throughout: the JAX step's ``zero_frozen_grads`` -> ``adamw`` ->
    ``zero_frozen_grads`` -> ``apply_updates`` against the port's update.
    ``torch.optim.AdamW``, which skips a leaf without a gradient and counts
    steps per leaf, leaves the JAX result from the second patch on."""
    rng = np.random.default_rng(0)
    shapes = {"a.kernel": (4, 3), "a.bias": (3,), "b.kernel": (3, 5), "c.scale": (5,), "frozen.w": (2, 2)}
    start = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    masks = [
        {"a.kernel": True, "a.bias": True, "b.kernel": False, "c.scale": False, "frozen.w": False},
        {"a.kernel": False, "a.bias": False, "b.kernel": True, "c.scale": True, "frozen.w": False},
    ]
    grads = [[{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
              for _ in masks] for _ in range(3)]
    lr, wd = 1e-2, 0.1

    tx = jax_make_optimizer(JaxTrainConfig(learning_rate=lr, weight_decay=wd))
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    opt_state = tx.init(jparams)
    for step in grads:
        for mask, g in zip(masks, step):
            g = jpw.zero_frozen_grads({k: jnp.asarray(v) for k, v in g.items()}, mask)
            updates, opt_state = tx.update(g, opt_state, jparams)
            jparams = optax.apply_updates(jparams, jpw.zero_frozen_grads(updates, mask))

    params = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in start.items()]
    reference = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in start.values()]
    torch_adamw = torch.optim.AdamW(reference, lr=lr, weight_decay=wd, eps=1e-8)
    state = TrainState(step=0, learning_rate=lr, count=0,
                       mu={k: torch.zeros_like(p) for k, p in params},
                       nu={k: torch.zeros_like(p) for k, p in params})
    opt = make_optimizer(TrainConfig(learning_rate=lr, weight_decay=wd))
    for step in grads:
        for mask, g in zip(masks, step):
            for (k, p), r in zip(params, reference):
                p.grad = torch.from_numpy(g[k].copy()) if mask[k] else None
                r.grad = None if p.grad is None else p.grad.clone()
            opt.update(state, params, mask)
            torch_adamw.step()
    assert state.count == 6
    for k, p in params:
        np.testing.assert_allclose(
            to_np(p), np.asarray(jparams[k]), atol=ADAM_TOL, rtol=ADAM_TOL, err_msg=k
        )
    np.testing.assert_array_equal(to_np(dict(params)["frozen.w"]), start["frozen.w"])
    # the moments of a leaf frozen in the last patch step still decayed
    mu = opt_state.inner_state[0].mu
    np.testing.assert_allclose(to_np(state.mu["a.kernel"]), np.asarray(mu["a.kernel"]),
                               atol=ADAM_TOL, rtol=1e-5)
    off = max(float((r.detach() - p.detach()).abs().max()) for (_, p), r in zip(params, reference))
    assert off > 1e-4, "torch.optim.AdamW computes something else under patch masks"


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 1.2, 0.5, 0.6, 0.7, 0.8, 0.9]
    want, got = JaxPlateau(1e-3), PlateauScheduler(1e-3)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]
    assert got.lr == pytest.approx(1e-5)
    trainer = Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), TrainConfig(), device="cpu")
    state = trainer.init_state(0)
    for m in (1.0, 2.0, 2.0, 2.0):
        state = trainer.on_plateau_metric(state, m)
    assert state.learning_rate == pytest.approx(1e-6)  # the default 1e-5, cut once


# --- steps ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mode", ["inplace", "snapshot"])
def test_steps_lower_the_loss_on_a_fixed_batch(mode, family):
    tcfg = TrainConfig(batch_size=2, learning_rate=1e-3, patchwise_percentage=0.34,
                       patchwise_mode=mode, weight_decay=0.01)
    trainer = Trainer(ModelConfig(model_type=FAMILIES[family], **TINY), tcfg, device="cpu")
    state = trainer.init_state(0)
    assert len(trainer.masks) == 3
    batch = make_batch(0, 2, GT_HW, (64, 64))
    frozen = {path: p.detach().clone() for path, p in named_flax_params(trainer.model)
              if not trainer.trainable_mask[path]}
    assert frozen
    stats_before = trainer.model.seg_head.bn.running_mean.clone()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, metrics = trainer.train_step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    assert set(metrics) == {"loss", "loss_disp", "loss_seg"}
    assert np.isfinite(losses).all() and losses[-1] < 0.8 * losses[0], losses
    assert state.step == state.count == 12  # one optimizer step per patch
    assert trainer.model.training
    for path, p in named_flax_params(trainer.model):
        if path in frozen:
            assert torch.equal(p, frozen[path]), path  # freeze means freeze
    assert not torch.equal(trainer.model.seg_head.bn.running_mean, stats_before)


def test_snapshot_patches_all_start_from_the_same_weights():
    """In snapshot mode every patch's gradient is taken at the start
    weights; in inplace mode the second patch sees the first one's update.
    With one step and no randomness the two differ, and the snapshot step
    equals patch steps taken one by one from restored weights."""
    def run(mode):
        tcfg = TrainConfig(batch_size=2, learning_rate=1e-2, patchwise_percentage=0.5,
                           patchwise_mode=mode, encoder_percentage=1.0)
        trainer = Trainer(ModelConfig(model_type=FAMILIES["beit"], **TINY), tcfg, device="cpu")
        state = trainer.init_state(0)
        trainer.model.seg_head.dropout_rate = 0.0
        trainer.train_step(state, make_batch(0, 2, GT_HW, (64, 64)))
        return trainer, {path: p.detach().clone() for path, p in named_flax_params(trainer.model)}

    trainer, snap = run("snapshot")
    _, inplace = run("inplace")
    first, second = trainer.masks
    for path in snap:  # the first patch's leaves saw the same weights in both modes
        if first[path]:
            np.testing.assert_allclose(to_np(snap[path]), to_np(inplace[path]), atol=1e-6)
    assert any(second[p] and not torch.allclose(snap[p], inplace[p], atol=1e-5) for p in snap)


def test_to_device_batch_downscales_the_gt_and_narrows_the_masks():
    tcfg = TrainConfig(batch_size=2, gt_downscale=2)
    trainer = Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), tcfg, device="cpu")
    trainer.init_state(0)
    batch = make_batch(0, 2, GT_HW, (64, 64))
    dev = trainer.to_device_batch(batch)
    assert tuple(dev["image"].shape) == (2, 3, 64, 64) and dev["image"].dtype == torch.float32
    assert tuple(dev["disparity"].shape) == (2, 24, 40) and dev["disparity"].dtype == torch.float32
    for key, shape in (("mask_disp", (2, 24, 40)), ("seg", (2, 3, 24, 40)), ("mask_seg", (2, 3, 24, 40))):
        assert tuple(dev[key].shape) == shape and dev[key].dtype == torch.uint8, key
    np.testing.assert_array_equal(dev["disparity"].numpy(), batch["disparity"][..., ::2, ::2])
    assert trainer.to_device_batch(dev)["seg"] is dev["seg"]  # already there: untouched
    trainer.model.eval()
    with torch.no_grad():
        small = float(trainer.loss(dev)[0])
        full_trainer = dataclasses.replace(tcfg, gt_downscale=1)
        trainer.tcfg = full_trainer
        full = float(trainer.loss(trainer.to_device_batch(batch))[0])
    # the statistics hold on the subsampled pixels: the two losses are close
    assert np.isfinite(small) and abs(small - full) < 0.1 * abs(full)


def test_remat_gives_the_same_gradients():
    def grads(remat):
        tcfg = TrainConfig(batch_size=2, remat_backbone=remat, encoder_percentage=1.0)
        trainer = Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), tcfg, device="cpu")
        trainer.init_state(0)
        assert trainer.model.depth_net.backbone.remat is remat
        select_trainable(trainer.model, trainer.masks[0])
        batch = trainer.to_device_batch(make_batch(0, 2, GT_HW, (64, 64)))
        # train mode: the stochastic-depth factors are drawn outside the
        # recomputed block, so both runs see the same ones
        loss, _ = trainer.loss(batch, torch.Generator().manual_seed(3))
        loss.backward()
        return float(loss.detach()), to_jax_variables(trainer.model, grads=True)["params"]

    loss_a, plain = grads(False)
    loss_b, remat = grads(True)
    assert loss_a == loss_b
    _assert_same_leaves(remat, plain, rtol=1e-6, what="remat gradient")


def test_train_config_has_the_jax_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    # read by neither package: the mesh comes from tp and the world size
    for unread in ("mesh_shape", "mesh_axes"):
        want.pop(unread)
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == want


def test_trainer_needs_a_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), TrainConfig())
    trainer = Trainer(ModelConfig(model_type=FAMILIES["swin2"], **TINY), TrainConfig(amp=True),
                      device="cpu")
    assert trainer.mcfg.compute_dtype == "bfloat16"  # amp: bf16 compute, f32 weights
    with pytest.raises(RuntimeError, match="init_state"):
        trainer.train_step(None, {})
    trainer.init_state(0)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
