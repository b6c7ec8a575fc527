"""Occupancy training with the port against the JAX package, on the CPU:
the step of ``soccdpt_torch/cli/train_occupancy.py`` against a JAX step
built from the JAX package's parts as its ``cli/train_occupancy.py``
builds it (``model.apply(compute_occ=True)``, ``masked_bce_loss``,
``optax.masked(optax.adam)``), the CLI's smaller functions against the
JAX CLI's formulas, the CLI end to end, checkpoints and the
self-consistent fixture.

One weight set goes from the JAX variables tree into the port
(``load_jax_variables``). Dropout and stochastic depth are off on both
sides (the stacks draw different numbers); BatchNorm runs on batch
statistics, as the step's train mode has it.

Tolerances:
* f32: ``F32_LOSS_RTOL`` = 1e-4 on each of three losses and
  ``F32_PARAM_ATOL`` = 1e-6 on the ``occupancy_conv`` parameters' updates
  over the three Adam steps (lr 1e-3: the steps move a weight by about
  3e-3; measured worst 1.6e-7): the voxelizer sums the seg probabilities
  in another order and the 3-D convs run another algorithm;
* bf16: ``BF16_LOSS_RTOL`` = 2e-2 on the losses (measured 1.4e-2), and on
  the updates ``|u_port - u_jax| / |u_jax|`` (2-norms) at most
  ``BF16_LEAF_UPDATE_RTOL`` = 0.8 for a leaf (measured 0.60, ``conv1``'s
  kernel) and ``BF16_UPDATE_RTOL`` = 0.4 over all the head's weights: two
  bf16 networks round apart, and Adam's first steps move a weight by about
  the learning rate whatever its gradient's size, so a small gradient
  whose sign the rounding flips moves its weight the other way. The
  bound still fails an update that ignores its gradient (its error is
  the size of the update, 1.0 or more).
* the seg head's BatchNorm running statistics after the steps: 1e-5 in
  f32 (tests/test_torch_training.py's bound on running statistics), 5e-2
  in bf16 (rtol and atol; measured 3.0e-2: statistics of bf16 features
  that two networks rounded apart);
* ``in_bounds_frac`` and the calibration: 1e-6 (a float32 product in
  another order).
"""
import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soccdpt_tpu.core import checkpoint as jckpt
from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import GT_OCCUPANCY as JAX_GT_OCCUPANCY
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.models import soccdpt as jsoccdpt
from soccdpt_tpu.models.backbones import swin2 as jswin2
from soccdpt_tpu.models.heads import SegHead as JaxSegHead
from soccdpt_tpu.ops.geometry import rotate_points as jax_rotate_points
from soccdpt_tpu.train.losses import masked_bce_loss as jax_masked_bce_loss
from soccdpt_tpu.train.patchwise import select_trainable as jax_select_trainable

from soccdpt_torch.cli import train_occupancy as tocc
from soccdpt_torch.core.checkpoint import load_params_lenient, restore_checkpoint, save_checkpoint
from soccdpt_torch.core.config import GT_OCCUPANCY, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.data.synthetic import make_bdd_fixture, make_selfconsistent_bdd_fixture
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.train.patchwise import select_trainable
from soccdpt_torch.weights import load_jax_variables, to_jax_variables

from test_torch_modules import perturbed_variables, to_np

F32_LOSS_RTOL, F32_PARAM_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL, BF16_LEAF_UPDATE_RTOL, BF16_UPDATE_RTOL = 2e-2, 0.8, 0.4
BN_F32_TOL, BN_BF16_TOL = 1e-5, 5e-2
LR, POS_WEIGHT, STEPS = 1e-3, 20.0, 3
CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(32, 32, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(4.0, 4.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_swin2_test_64", version=3, features=32, compute_occ=True,
            occupancy_head=True)
torch.set_num_threads(2)  # the suite runs several worker processes side by side


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    grid = (rng.random((B, 32, 32, 8, 3)) < 0.05).astype(np.float32)
    return {"image": rng.standard_normal((B, 3, 64, 64)).astype(np.float32),
            "occupancy_grid": grid, "mask_occ": np.ones_like(grid, bool)}


def _jax_model(dtype):
    return jsoccdpt.build_model(JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC),
                                               compute_dtype=dtype, **TINY))


@pytest.fixture(scope="module")
def jax_variables():
    """One weight set for both dtypes (the parameters are f32 in either)."""
    init = jax.jit(functools.partial(_jax_model("float32").init, compute_occ=True))
    variables = perturbed_variables(init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64))), 0)
    head = variables["params"]["depth_net"]["head"]["conv3"]  # depths of a few meters
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    return variables


def _stacks(dtype, variables):
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC),
                      compute_dtype=dtype, **TINY)
    jmodel = _jax_model(dtype)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    model.seg_head.dropout_rate = 0.0
    backbone = model.depth_net.backbone
    backbone.drop_path_rates = [0.0] * len(backbone.drop_path_rates)
    return jmodel, model


def _jax_steps(monkeypatch, jmodel, variables, batches):
    """The JAX CLI's ``train_step`` (cli/train_occupancy.py:275-300), with
    the seg head's dropout and the trunk's stochastic depth off."""
    monkeypatch.setattr(jsoccdpt, "SegHead", functools.partial(JaxSegHead, dropout_rate=0.0))
    monkeypatch.setattr(jswin2, "drop_path", lambda x, rate, deterministic, rng: x)
    params, batch_stats = variables["params"], variables["batch_stats"]

    def occ_only(p):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: any("occupancy_conv" in str(getattr(k, "key", "")) for k in path), p
        )

    occ_mask = occ_only(params)
    tx = optax.masked(optax.adam(LR), occ_only)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, batch_stats, image, grid, mask):
        def loss_fn(p):
            p = jax_select_trainable(p, occ_mask)
            out, updates = jmodel.apply(
                {"params": p, "batch_stats": batch_stats}, image, deterministic=False,
                compute_occ=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)},
            )
            pred = out[3]
            B = pred.shape[0]
            loss = jax_masked_bce_loss(jnp.clip(pred.reshape(B, -1), 1e-6, 1 - 1e-6),
                                       grid.reshape(B, -1), mask.reshape(B, -1),
                                       pos_weight=POS_WEIGHT)
            return loss, updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, new_stats, loss

    losses = []
    for b in batches:
        params, opt_state, batch_stats, loss = train_step(
            params, opt_state, batch_stats, jnp.asarray(b["image"]),
            jnp.asarray(b["occupancy_grid"]), jnp.asarray(b["mask_occ"], jnp.float32),
        )
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(
        np.asarray, batch_stats)


def _port_steps(model, batches):
    select_trainable(model, tocc.occupancy_mask(model))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    optimizer = torch.optim.Adam(model.occupancy_conv.parameters(), lr=LR)
    losses = []
    for b in batches:
        loss = tocc.occupancy_step(model, optimizer, torch.from_numpy(b["image"]),
                                   torch.from_numpy(b["occupancy_grid"]),
                                   torch.from_numpy(b["mask_occ"]), POS_WEIGHT)
        losses.append(float(loss))
    for name, p in model.named_parameters():
        if name in frozen:
            assert p.grad is None and torch.equal(p, frozen[name]), name  # freeze means freeze
    return losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_occupancy_step_matches_the_jax_cli_step(monkeypatch, jax_variables, dtype):
    jmodel, model = _stacks(dtype, jax_variables)
    batches = [_batch(s) for s in range(STEPS)]
    want_losses, want_params, want_stats = _jax_steps(monkeypatch, jmodel, jax_variables, batches)
    got_losses = _port_steps(model, batches)
    got = to_jax_variables(model)["params"]["occupancy_conv"]
    start = jax_variables["params"]["occupancy_conv"]
    # each leaf's update over the steps, the port's against the JAX step's
    updates = {f"{name}.{leaf}": (got[name][leaf] - start[name][leaf],
                                  want_params["occupancy_conv"][name][leaf] - start[name][leaf])
               for name in start for leaf in ("kernel", "bias")}
    assert min(np.abs(w).max() for _, w in updates.values()) > 0.5 * STEPS * LR  # they moved
    if dtype == "float32":
        np.testing.assert_allclose(got_losses, want_losses, rtol=F32_LOSS_RTOL)
        for path, (g, w) in updates.items():
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_PARAM_ATOL, err_msg=path)
    else:
        np.testing.assert_allclose(got_losses, want_losses, rtol=BF16_LOSS_RTOL)
        rel = {path: np.linalg.norm(g - w) / np.linalg.norm(w) for path, (g, w) in updates.items()}
        assert max(rel.values()) <= BF16_LEAF_UPDATE_RTOL, rel
        total = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in updates.values())
                        / sum(np.sum(w ** 2) for _, w in updates.values()))
        assert total <= BF16_UPDATE_RTOL, total
    # the seg head's running statistics, updated by the steps' train mode
    stats_tol = BN_F32_TOL if dtype == "float32" else BN_BF16_TOL
    for key in ("mean", "var"):
        np.testing.assert_allclose(to_jax_variables(model)["batch_stats"]["seg_head"]["bn"][key],
                                   want_stats["seg_head"]["bn"][key], rtol=stats_tol,
                                   atol=stats_tol, err_msg=key)


def _tie_rich_head_case():
    """A 16x16x8 grid of 40 filled cells, a target, and the JAX head's
    perturbed variables with the JAX gradients of the masked BCE with
    respect to them and to the grid."""
    from soccdpt_tpu.models.heads import OccupancyHead as JaxOccupancyHead

    rng = np.random.default_rng(0)
    g = np.zeros((1, 16, 16, 8, 3), np.float32)
    cells = rng.integers(0, [16, 16, 8], (40, 3))
    g[0, cells[:, 0], cells[:, 1], cells[:, 2]] = rng.uniform(0.5, 3.0, (40, 3))
    target = (rng.random(g.shape) < 0.1).astype(np.float32)
    jhead = JaxOccupancyHead(num_classes=3, identity=False)
    variables = perturbed_variables(jhead.init(jax.random.PRNGKey(0), jnp.asarray(g)), 0)
    want, want_dg = jax.grad(lambda p, x: jax_masked_bce_loss(
        jhead.apply({"params": p}, x), jnp.asarray(target), jnp.ones_like(target),
        pos_weight=POS_WEIGHT), argnums=(0, 1))(variables["params"], jnp.asarray(g))
    return g, target, variables, want, np.asarray(want_dg)


def _port_head_gradients(g, target, variables, grid_grad):
    from soccdpt_torch.models.heads import OccupancyHead
    from soccdpt_torch.train.losses import masked_bce_loss

    head = OccupancyHead(3, identity=False)
    load_jax_variables(head, variables)
    grid = torch.from_numpy(g).requires_grad_(grid_grad)
    masked_bce_loss(head(grid), torch.from_numpy(target),
                    torch.ones(target.shape), pos_weight=POS_WEIGHT).backward()
    return grid.grad, to_jax_variables(head, grads=True)["params"]


def _assert_head_weight_gradients(got, want):
    for name in want:
        for leaf in ("kernel", "bias"):
            w = np.asarray(want[name][leaf])
            np.testing.assert_allclose(got[name][leaf], w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name}.{leaf}")


def test_head_gradient_splits_pool_ties_as_jax():
    """An accumulated grid is mostly empty cells, whose first conv outputs
    tie in every pool window. The head's gradients, of its weights and of
    the grid it reads (the one that flows on to the voxelizer's K2
    backward), are the JAX package's: each pairwise maximum splits a tie
    in two, where ``max_pool3d`` would route it to one cell."""
    g, target, variables, want, want_dg = _tie_rich_head_case()
    grid_grad, got = _port_head_gradients(g, target, variables, grid_grad=True)
    np.testing.assert_allclose(grid_grad.numpy(), want_dg, rtol=1e-4,
                               atol=1e-6 * np.abs(want_dg).max())
    _assert_head_weight_gradients(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_pools_give_the_same_values(dtype):
    """``max_pool3d`` and the pairwise maxima, on windows that tie (half
    the cells) and on windows that do not, in both compute dtypes."""
    from soccdpt_torch.models import heads

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 8, 6, 4), np.float32))
    x[..., :4, :] = 0.5
    x = x.to(dtype)
    pooled = heads._max_pool_222(x, split_ties=False)
    assert pooled.shape == (2, 3, 4, 3, 2) and pooled.dtype == dtype
    assert torch.equal(pooled, heads._max_pool_222(x, split_ties=True))


def test_head_weight_gradients_are_jax_s_when_the_grid_takes_none():
    """Where the grid takes no gradient (the occupancy trainer) the head
    pools with ``max_pool3d``; on the tie-rich grid its weight gradients
    are the JAX package's all the same, since a tie's cells read equal
    patches."""
    g, target, variables, want, _ = _tie_rich_head_case()
    grid_grad, got = _port_head_gradients(g, target, variables, grid_grad=False)
    assert grid_grad is None
    _assert_head_weight_gradients(got, want)


# --- the CLI's smaller functions -------------------------------------------------


def _jax_grid_override(occ, new_grid):
    """cli/train_occupancy.py:117-129."""
    factors = [n / o for n, o in zip(new_grid, occ.grid_size)]
    return dataclasses.replace(occ, grid_size=tuple(new_grid),
                               scale=tuple(s * f for s, f in zip(occ.scale, factors)))


def _jax_in_bounds_frac(pts_np, occ):
    """cli/train_occupancy.py:175-186."""
    q = pts_np * np.asarray(occ.pc_scale, np.float32) + np.asarray(occ.pc_shift, np.float32)
    q = np.asarray(jax_rotate_points(jnp.asarray(q[None]), occ.correction_angle))[0]
    shape_m = np.asarray(occ.occupancy_shape, np.float32)
    return float((np.isfinite(q).all(-1) & (q >= 0).all(-1) & (q < shape_m).all(-1)).mean())


def _jax_calibration(cloud, occ):
    """cli/train_occupancy.py:218-229."""
    shape_m = np.asarray(occ.occupancy_shape, np.float32)
    lo = np.percentile(cloud, 2.0, axis=0).astype(np.float32)
    hi = np.percentile(cloud, 98.0, axis=0).astype(np.float32)
    span = np.maximum(hi - lo, 1e-6)
    pc_scale = 0.9 * shape_m / span
    return pc_scale, 0.05 * shape_m - lo * pc_scale


@pytest.mark.parametrize("grid", [(32, 32, 8), (64, 64, 16), (256, 256, 32)])
def test_grid_override_keeps_the_volume(grid):
    got = tocc.grid_override(GT_OCCUPANCY, grid)
    want = _jax_grid_override(JAX_GT_OCCUPANCY, grid)
    assert got.grid_size == want.grid_size and got.scale == want.scale
    np.testing.assert_allclose(got.occupancy_shape, GT_OCCUPANCY.occupancy_shape, rtol=1e-12)


def test_calibration_matches_the_jax_formulas():
    rng = np.random.default_rng(0)
    cloud = (rng.standard_normal((20000, 3)) * [0.02, 0.01, 0.3] + [0.0, 0.005, 1.0]).astype(
        np.float32)
    occ = OccupancyConfig()
    before = _jax_in_bounds_frac(cloud, JaxOcc())
    new, info = tocc.calibrate_grid(cloud, occ, "auto")
    assert before < 0.05 and abs(info["in_bounds_before"] - before) <= 1e-6
    pc_scale, pc_shift = _jax_calibration(cloud, JaxOcc())
    np.testing.assert_allclose(new.pc_scale, pc_scale, rtol=1e-6)
    np.testing.assert_allclose(new.pc_shift, pc_shift, rtol=1e-6, atol=1e-6)
    jnew = dataclasses.replace(JaxOcc(), pc_scale=tuple(map(float, pc_scale)),
                               pc_shift=tuple(map(float, pc_shift)))
    assert abs(info["in_bounds_after"] - _jax_in_bounds_frac(cloud, jnew)) <= 1e-6
    assert info["in_bounds_after"] > 0.85
    # already in bounds: auto keeps the constants, on recalibrates, off never does
    assert tocc.calibrate_grid(cloud, new, "auto")[0] is new
    assert tocc.calibrate_grid(cloud, new, "on")[0] is not new
    assert tocc.calibrate_grid(cloud, occ, "off")[0] is occ
    assert tocc.calibrate_grid(cloud[:50], occ, "on")[0] is occ  # too few points


def test_auto_pos_weight_matches_the_jax_formula():
    g = np.zeros((16, 16, 8, 3), np.float32)
    g.reshape(-1)[:37] = 1.0
    weight, n_pos = tocc.auto_pos_weight(g)
    assert n_pos == 37 and weight == pytest.approx((g.size - 37) / 37)
    assert tocc.auto_pos_weight(np.zeros((64, 64, 64, 3), np.float32)) == (1e5, 0)


# --- the CLI end to end ---------------------------------------------------------------


@pytest.fixture(scope="module")
def bdd_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("bdd")
    make_bdd_fixture(str(base), frames_per_seq=3)
    return str(base)


def test_train_occupancy_cli(bdd_tree, tmp_path, monkeypatch):
    """tests/test_cli.py:134-153, on the CPU: a checkpoint appears, the
    loss and the IoU are finite, and the bench rows keep the JAX keys."""
    monkeypatch.chdir(tmp_path)
    bench = tmp_path / "bench.jsonl"
    iou = tocc.main([
        "-t", "dpt_swin2_test_64", "-b", bdd_tree, "--epochs", "1", "--max_steps", "2",
        "--val_percent", "0.34", "--grid", "32", "32", "8", "-c", str(tmp_path / "ckpts"),
        "--pos_weight", "auto", "--iou_every", "2", "--bench_jsonl", str(bench),
        "--device", "cpu",
    ])
    assert np.isfinite(iou)
    ckpts = glob.glob(str(tmp_path / "ckpts" / "SOccDPT_Occupancy" / "run" / "*"))
    assert len(ckpts) == 1
    state = restore_checkpoint(ckpts[0])["params"]
    assert "occupancy_conv.conv1.weight" in state
    rows = [json.loads(line) for line in bench.read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 2]
    assert set(rows[0]) == {"tag", "model_type", "grid", "step", "loss", "val_iou"}
    assert rows[0]["grid"] == [32, 32, 8] and rows[1]["loss"] is None
    logged = [json.loads(line) for line in (tmp_path / "logs" / "metrics_occupancy.jsonl")
              .read_text().splitlines()]
    assert [r["step"] for r in logged] == [0, 1] and all(np.isfinite(r["loss"]) for r in logged)
    # --load carries the weights back (the head's too)
    iou2 = tocc.main([
        "-t", "dpt_swin2_test_64", "-b", bdd_tree, "--epochs", "1", "--max_steps", "1",
        "--val_percent", "0.34", "--grid", "32", "32", "8", "-c", str(tmp_path / "ckpts2"),
        "-l", ckpts[0], "--calibrate_grid", "off", "--device", "cpu",
    ])
    assert np.isfinite(iou2)


def test_the_cli_defaults_to_the_card(bdd_tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tocc.main(["-t", "dpt_swin2_test_64", "-b", bdd_tree, "--max_steps", "1"])


# --- the metric log ------------------------------------------------------------------------


def test_metric_writer_logs_as_the_jax_writer(tmp_path, capsys):
    """Console lines and JSONL records (but their ``time``) equal the JAX
    package's ``MetricWriter``'s; values that are no scalars are left out."""
    from soccdpt_tpu.utils.logging import MetricWriter as JaxMetricWriter
    from soccdpt_torch.utils.logging import MetricWriter

    rows = [({"loss": torch.tensor(0.25), "epoch": 1, "tag": "x", "grid": [1, 2]}, 0),
            ({"loss": np.float32(1.5), "val_iou": 0.125, "time": 3.0}, 1), ({}, None)]
    records, console = {}, {}
    for name, cls in (("jax", JaxMetricWriter), ("port", MetricWriter)):
        writer = cls(log_dir=str(tmp_path / name), run_id="r")
        for metrics, step in rows:
            writer.log(metrics, step)
        writer.close()
        console[name] = capsys.readouterr().out
        lines = (tmp_path / name / "metrics_r.jsonl").read_text().splitlines()
        records[name] = [json.loads(line) for line in lines]
    assert console["port"] == console["jax"]
    assert console["port"].splitlines()[0] == "[step 0] loss=0.25 epoch=1"
    for rec in records.values():
        for r in rec:
            assert np.isfinite(r.pop("time"))
    assert records["port"] == records["jax"] == [
        {"step": 0, "loss": 0.25, "epoch": 1.0}, {"step": 1, "loss": 1.5, "val_iou": 0.125},
        {"step": None}]


# --- evaluation ---------------------------------------------------------------------------


def test_evaluation_matches_jax_on_the_same_predictions():
    """``train/evaluate.py``'s protocol (bicubic to GT size, per-image
    scale and shift, seg IoU, occupancy IoU) against the JAX package's on
    the same network outputs; 1e-5 (float32 resizes and sums in another
    order)."""
    from soccdpt_tpu.train import evaluate as jeval

    from soccdpt_torch.train import evaluate as peval

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        disp = rng.uniform(1.0, 50.0, (2, 24, 40)).astype(np.float32)
        batches.append({"image": rng.standard_normal((2, 3, 8, 8)).astype(np.float32),
                        "disparity": disp, "mask_disp": disp > 5.0,
                        "seg": (rng.random((2, 3, 24, 40)) < 0.3).astype(np.float32),
                        "occupancy_grid": (rng.random((2, 8, 8, 4, 3)) < 0.2).astype(np.float32)})
    preds = [(rng.uniform(0.02, 1.0, (2, 12, 20)).astype(np.float32),
              rng.random((2, 3, 12, 20)).astype(np.float32),
              rng.random((2, 8, 8, 4, 3)).astype(np.float32)) for _ in batches]
    calls = iter(range(10))

    def forward(framework):
        def run(image):
            inv, seg, _ = preds[next(calls) % 2]
            return (jnp.asarray(inv), jnp.asarray(seg)) if framework == "jax" else (
                torch.from_numpy(inv), torch.from_numpy(seg))
        return run

    want = jeval.evaluate_depth_seg(forward("jax"), batches)
    calls = iter(range(10))
    got = peval.evaluate_depth_seg(forward("torch"), batches)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key
    occ = iter(preds)
    want = jeval.evaluate_occupancy(lambda image: jnp.asarray(next(occ)[2]), batches)
    occ = iter(preds)
    got = peval.evaluate_occupancy(lambda image: torch.from_numpy(next(occ)[2]), batches)
    assert got == want and set(got) == {"iou_3D"}


# --- checkpoints and the self-consistent fixture -----------------------------------------


def test_checkpoint_round_trip(tmp_path):
    model = build_model(ModelConfig(**TINY), device="cpu")
    path = str(tmp_path / "a" / "b" / "checkpoint_epoch_1.pt")
    save_checkpoint(path, {"params": model.state_dict(), "step": 7})
    restored = restore_checkpoint(path)
    assert restored["step"] == 7 and not glob.glob(str(tmp_path / "a" / "b" / "*.tmp"))
    state = model.state_dict()
    assert set(restored["params"]) == set(state)
    for name, t in state.items():
        assert torch.equal(restored["params"][name], t), name


def test_load_params_lenient_has_the_jax_semantics(capsys):
    """Copy what matches by name and shape, keep the target otherwise,
    report what was kept; the JAX function on the same trees agrees."""
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    restored = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(5)}
    merged = load_params_lenient(restored, target)
    assert set(merged) == set(target)
    assert torch.equal(merged["a"], torch.ones(2)) and merged["b"] is target["b"]
    assert merged["c"] is target["c"]
    out = capsys.readouterr().out
    assert "kept 2" in out and "b" in out and "c" in out
    want = jckpt.load_params_lenient({k: v.numpy() for k, v in restored.items()},
                                     {k: v.numpy() for k, v in target.items()}, verbose=False)
    for k in target:
        np.testing.assert_array_equal(to_np(merged[k]), np.asarray(want[k]), err_msg=k)


def test_selfconsistent_fixture_writes_the_models_depth(tmp_path):
    from soccdpt_torch.data import image_io as io
    from soccdpt_torch.data.bdd import BDDOccupancy, get_bdd_dataset
    from soccdpt_torch.data.transforms import load_transforms

    calib = make_selfconsistent_bdd_fixture(str(tmp_path), model_type="dpt_swin2_test_64",
                                            frames_per_seq=2, width=256, height=192, device="cpu")
    assert os.path.isfile(calib)
    depth_files = sorted(glob.glob(str(tmp_path / "*" / "depth_img" / "*.png")))
    assert len(depth_files) == 4
    disp = io.imread(depth_files[0], io.IMREAD_UNCHANGED)
    assert disp.shape == (192, 256) and disp.dtype == np.uint16  # its range passes 255
    bf = 1.0e-2 * 0.9 * 256
    assert disp.min() >= int(bf / 0.144) and disp.max() <= int(np.ceil(bf / 0.0046))
    assert len(np.unique(disp)) > 10  # the model's depth, not the ramp
    transform, _, _ = load_transforms("dpt_swin2_test_64")
    ds = get_bdd_dataset(BDDOccupancy, transform, str(tmp_path))
    for d in ds.datasets:
        d.target_size = (256, 192)
    assert ds[0]["occupancy_grid"].any()
