"""Data and tensor parallelism of the port (``soccdpt_torch/parallel/``,
``train/trainer.py`` on a mesh, ``cli/train.py --tp``) on the CPU: gloo
ranks spawned from ``tests/torch_parallel_worker.py``, each on one thread,
held to one process on the same global batch.

Tiny V3 and V1 (both train BatchNorm: the seg head, and V1's seg decoder)
at global batch 4, with masks whose counts differ between the halves of
the batch, so a loss averaged over the ranks would differ from the global
batch's (checked here too). Dropout and stochastic depth are off on both
sides: they draw other numbers on other ranks.

Tolerances:

* one step (two patch steps) on a 2-rank mesh, (2, 1) or (1, 2), against
  one process, at the config's learning rate of 1e-5: the loss to
  ``LOSS_RTOL`` = 1e-5 relative; every leaf, both Adam moments and every
  running statistic to ``LEAF_RTOL`` = 1e-5 of its 2-norm, plus
  ``LEAF_ATOL_OF_MAX`` = 1e-6 of the largest such norm of its kind, as
  tests/test_torch_training.py adds it (sums over the ranks in another
  order than one process's, in f32; the SSI loss ignores a shift of the
  prediction, so the depth head's last conv has a gradient that vanishes
  in exact arithmetic and is rounding noise in f32);
* three steps on a 4-rank (2, 2) mesh: the JAX package's own bounds for
  its tensor-parallel run against data parallelism
  (tests/test_training.py::test_tp_product_training_matches_dp): losses to
  rtol 5e-5, leaves to atol 3e-3; and the bounds above. At the JAX test's
  learning rate of 1e-3 the losses part by about 1e-4 after one step:
  Adam's first steps move a leaf by about the learning rate whatever the
  size of its gradient, so rounding that flips a tiny gradient's sign
  moves it by twice that, and this SSI loss is steep;
* a checkpoint across meshes: bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

from soccdpt_torch.cli import eval as peval
from soccdpt_torch.core.checkpoint import restore_checkpoint
from soccdpt_torch.core.config import ModelConfig, TrainConfig
from soccdpt_torch.data import synthetic
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.parallel import comm
from soccdpt_torch.parallel import mesh as mesh_lib
from soccdpt_torch.parallel.sharding import param_sharding_rules
from soccdpt_torch.train import losses
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import flax_param_layouts, flax_shape

import torch_parallel_worker as worker

LOSS_RTOL = 1e-5
LEAF_RTOL, LEAF_ATOL_OF_MAX = 1e-5, 1e-6
TP_LOSS_RTOL, TP_LEAF_ATOL = 5e-5, 3e-3
GT_HW = (48, 80)
MODEL = {3: dict(model_type="dpt_swin2_test_64", version=3, features=32),
         1: dict(model_type="dpt_swin2_test_64", version=1, features=32)}
TRAIN = dict(batch_size=4, learning_rate=1e-5, encoder_percentage=1.0,
             patchwise_percentage=0.5, tp_min_size=2**8)
MESHES = [(2, 1), (1, 2)]
MODES = ["inplace", "snapshot"]
CASES = [(v, m, mode) for v in (3, 1) for m in MESHES for mode in MODES]
CONFIG = os.path.join(os.path.dirname(__file__), "..", "config")

torch.set_num_threads(2)


def _batch():
    return worker.uneven_masks(make_batch(0, 4, GT_HW, (64, 64)))


def _case(tmp, version, mode, mesh, **kw):
    return dict(model=MODEL[version], train=dict(TRAIN, patchwise_mode=mode), mesh=mesh,
                batch=os.path.join(tmp, "batch.npz"), **kw)


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    got = {k: torch.as_tensor(v).double().numpy() for k, v in got.items()}
    want = {k: torch.as_tensor(v).double().numpy() for k, v in want.items()}
    floor = LEAF_ATOL_OF_MAX * max(float(np.linalg.norm(w)) for w in want.values())
    for path, w in want.items():
        err, ref = float(np.linalg.norm(got[path] - w)), float(np.linalg.norm(w))
        assert err <= LEAF_RTOL * ref + floor, f"{what} {path}: |diff| {err:.3g} of |{ref:.3g}|"


def _same_state(got, want):
    assert got["losses"] == pytest.approx(want["losses"], rel=LOSS_RTOL)
    for key in ("params", "stats", "mu", "nu"):
        _close(got[key], want[key], key)
    assert (got["count"], got["step"]) == (want["count"], want["step"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank case in one spawn, and the same cases on one process;
    then a checkpoint written at (1, 2) and resumed at (2, 1)."""
    tmp = str(tmp_path_factory.mktemp("parallel2"))
    worker.save_batch(os.path.join(tmp, "batch.npz"), _batch())
    cases = [_case(tmp, v, mode, m) for v, m, mode in CASES]
    ckpt = os.path.join(tmp, "ckpt_1x2")
    resume = [_case(tmp, 3, "inplace", (1, 2), save=ckpt),
              _case(tmp, 3, "inplace", (2, 1), restore=ckpt)]
    ranks = worker.spawn(2, tmp, "cases", cases + resume)
    single = {(v, mode): worker.single(_case(tmp, v, mode, None)) for v in (3, 1) for mode in MODES}
    resumed_single = worker.single(resume[1])
    return {"tmp": tmp, "ranks": ranks, "single": single, "ckpt": ckpt,
            "resumed_single": resumed_single, "n": len(cases)}


@pytest.mark.parametrize("version,mesh,mode", CASES,
                         ids=[f"v{v}-{m[0]}x{m[1]}-{mode}" for v, m, mode in CASES])
def test_two_rank_step_is_the_single_process_step(two_ranks, version, mesh, mode):
    i = CASES.index((version, mesh, mode))
    want = two_ranks["single"][(version, mode)]
    for rank in two_ranks["ranks"]:
        got = rank[i]
        assert got["mesh"] == dict(zip(("data", "model"), mesh))
        _same_state(got, want)
    # the ranks agree with each other on every weight: one model everywhere
    a, b = (r[i]["params"] for r in two_ranks["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_moments_on_a_tp_rank_are_slices_of_their_leaves(two_ranks):
    i = CASES.index((3, (1, 2), "inplace"))
    rank0, rank1 = (r[i] for r in two_ranks["ranks"])
    sharded = rank0["sharded"]
    assert len(sharded) >= 10 and sharded == rank1["sharded"]
    for r, got in enumerate((rank0, rank1)):
        for path, m in got["local_mu"].items():
            full = got["mu"][path]
            dim = sharded.get(path)
            if dim is None:
                assert torch.equal(m, full), path
                continue
            size = full.shape[dim] // 2
            assert m.shape[dim] == size, path
            assert torch.equal(m, full.narrow(dim, r * size, size)), path
    # the (2, 1) mesh shards nothing
    assert two_ranks["ranks"][0][CASES.index((3, (2, 1), "inplace"))]["sharded"] == {}
    local = sum(m.numel() for m in rank0["local_mu"].values())
    full = sum(m.numel() for m in rank0["mu"].values())
    assert local < 0.8 * full


def test_averaged_rank_losses_would_differ(two_ranks):
    """The port's loss is the global batch's; the mean of the two halves'
    own losses is another number on these masks."""
    with np.load(os.path.join(two_ranks["tmp"], "batch.npz")) as npz:
        batch = {k: torch.from_numpy(npz[k]) for k in npz.files}
    rng = np.random.default_rng(3)
    pred = torch.from_numpy(rng.random((4, 1, 16, 20)).astype(np.float32))
    seg = torch.from_numpy(rng.random((4, 3, *GT_HW)).astype(np.float32) * 0.8 + 0.1)

    def loss(rows, global_sum=None):
        d = losses.ssi_loss_from_net(pred[rows][:, 0], batch["disparity"][rows],
                                     batch["mask_disp"][rows].float(), global_sum=global_sum)
        s = losses.masked_bce_loss(seg[rows], batch["seg"][rows], batch["mask_seg"][rows].float(),
                                   global_sum=global_sum)
        return 0.5 * d + 0.5 * s

    halves = (slice(0, 2), slice(2, 4))
    whole = float(loss(slice(0, 4)))
    averaged = float(sum(loss(h) for h in halves)) / 2

    def divisors(rows):  # each reduction's divisor, in call order
        seen = []
        loss(rows, lambda t: seen.append(t) or t)
        return seen

    def plus(other):  # the global divisor: this half's and the other's
        it = iter(other)
        return lambda t: t + next(it)

    first, second = divisors(halves[0]), divisors(halves[1])
    assert any(float(a) != float(b) for a, b in zip(first, second))  # uneven masks
    shares = float(loss(halves[0], plus(second))) + float(loss(halves[1], plus(first)))
    assert shares == pytest.approx(whole, rel=1e-6)
    assert abs(averaged - whole) > 1e-3 * abs(whole), (averaged, whole)


def test_checkpoint_restores_across_meshes_bit_for_bit(two_ranks):
    saved = restore_checkpoint(two_ranks["ckpt"])
    n = two_ranks["n"]
    writer = two_ranks["ranks"][0][n]
    for got in [r[n + 1] for r in two_ranks["ranks"]] + [two_ranks["resumed_single"]]:
        restored = got["restored"]
        assert restored["count"] == saved["opt_state"]["count"] == writer["count"]
        assert restored["step"] == saved["step"] == writer["step"]
        for key in ("params", "stats"):
            for path, value in writer[key].items():
                assert np.array_equal(restored[key][path], value), path
        for key in ("mu", "nu"):
            for path, value in writer[key].items():
                assert torch.equal(restored[key][path], value), path
                assert torch.equal(saved["opt_state"][key][path], value), path
    # the next step from the checkpoint: (2, 1) against one process
    ranks = [r[n + 1] for r in two_ranks["ranks"]]
    want = two_ranks["resumed_single"]
    for got in ranks:
        _same_state(got, want)


def test_four_rank_2x2_mesh_trains_as_one_process(tmp_path):
    """Three steps (six patch steps) on a (2, 2) mesh: the JAX package's
    bounds for its tensor-parallel run, and the 2-rank cases' own bounds on
    every leaf, moment and running statistic."""
    worker.save_batch(str(tmp_path / "batch.npz"), _batch())
    case = _case(str(tmp_path), 3, "inplace", (2, 2), steps=3)
    ranks = worker.spawn(4, tmp_path, "cases", [case])
    want = worker.single(case)
    for rank in ranks:
        got = rank[0]
        assert got["mesh"] == {"data": 2, "model": 2} and got["sharded"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TP_LOSS_RTOL)
        for path, value in want["params"].items():
            np.testing.assert_allclose(got["params"][path], value, atol=TP_LEAF_ATOL,
                                       err_msg=path)
        _same_state(got, want)
    assert len(set(tuple(r[0]["losses"]) for r in ranks)) == 1


@pytest.fixture(scope="module")
def bdd_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("bdd_parallel")
    synthetic.make_bdd_fixture(str(base), frames_per_seq=3)
    return str(base)


def test_train_cli_tp2_on_two_ranks_writes_one_checkpoint(bdd_tree, tmp_path):
    with open(os.path.join(CONFIG, "test_tiny.json")) as fh:
        raw = json.load(fh)
    raw["parameters"]["save_checkpoint"] = {"values": [True]}
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps(raw))

    def args(out, *extra):
        return ["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_test_64", "-b", bdd_tree,
                "--sweep_json", str(sweep), "--device", "cpu", "--max_steps", "2",
                "--host_prefetch", "0", "-c", str(tmp_path / out / "ck"),
                "--log_dir", str(tmp_path / out / "logs"), *extra]

    ranks = worker.spawn(2, tmp_path, "cli", [args("tp2", "--tp", "2"), args("tp3", "--tp", "3"),
                                              args("dp2")], str(tmp_path))
    for rank in ranks:
        assert isinstance(rank[0], list) and len(rank[0]) == 1
        assert rank[1] == "ValueError: --tp 3 does not divide the world size 2"
        assert isinstance(rank[2], list) and len(rank[2]) == 1
    project = "SOccDPT_V3_dpt_swin2_test_64_bdd"
    # the (2,) mesh: each rank read its share of the batch
    assert sorted(os.listdir(tmp_path / "dp2" / "ck" / project / "trial000")) == [
        "checkpoint_epoch_1"]
    assert len(list((tmp_path / "dp2" / "logs").glob("*.jsonl"))) == 1
    assert not (tmp_path / "tp3").exists()
    run = tmp_path / "tp2" / "ck" / project / "trial000"
    assert sorted(os.listdir(run)) == ["checkpoint_epoch_1"]
    assert len(list((tmp_path / "tp2" / "logs").glob("*.jsonl"))) == 1
    ckpt = restore_checkpoint(str(run / "checkpoint_epoch_1"))
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
    # full moments, whatever the mesh that wrote them
    trainer = Trainer(ModelConfig(model_type="dpt_swin2_test_64"), TrainConfig(), device="cpu")
    trainer.init_state(0)
    for path, p in trainer.params:
        assert tuple(ckpt["opt_state"]["mu"][path].shape) == tuple(p.shape), path
    metrics = peval.main(["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_test_64", "-b", bdd_tree,
                          "-l", str(run / "checkpoint_epoch_1"), "--num_samples", "2",
                          "--skip_fps", "--media_dir", str(tmp_path / "media"),
                          "--device", "cpu"])
    assert all(np.isfinite(v) for v in metrics.values())


def test_train_cli_rank_outside_the_mesh_skips_every_trial(bdd_tree, tmp_path):
    """Three ranks at batch 2: the data axis shrinks to 2 and rank 2 lies
    outside the mesh. Every rank builds the mesh once, before the first of
    the two trials, so the idle rank never waits in a later trial's groups
    while the others train; both trials write their checkpoint."""
    with open(os.path.join(CONFIG, "test_tiny.json")) as fh:
        raw = json.load(fh)
    raw["parameters"]["save_checkpoint"] = {"values": [True]}
    raw["parameters"]["learning_rate"] = {"values": [1e-3, 1e-4]}
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps(raw))
    argv = ["-v", "3", "-dt", "bdd", "-t", "dpt_swin2_test_64", "-b", bdd_tree,
            "--sweep_json", str(sweep), "--device", "cpu", "--max_steps", "1",
            "--host_prefetch", "0", "-n", "2", "-c", str(tmp_path / "ck"),
            "--log_dir", str(tmp_path / "logs")]
    ranks = worker.spawn(3, tmp_path, "cli", [argv], str(tmp_path))
    assert [rank["meshes"][0] for rank in ranks] == [1, 1, 1]
    assert ranks[2][0] == [{}, {}]
    for rank in ranks[:2]:
        assert isinstance(rank[0], list) and len(rank[0]) == 2
    project = tmp_path / "ck" / "SOccDPT_V3_dpt_swin2_test_64_bdd"
    for trial in ("trial000", "trial001"):
        assert sorted(os.listdir(project / trial)) == ["checkpoint_epoch_1"]
        ckpt = restore_checkpoint(str(project / trial / "checkpoint_epoch_1"))
        assert ckpt["step"] == 1


def test_mesh_without_a_process_group_is_one_process():
    mesh = mesh_lib.make_mesh()
    assert dict(mesh.shape) == {"data": 1} and not mesh.distributed and mesh.active
    assert mesh_lib.init_distributed("cpu").world_size == 1
    trainer = Trainer(ModelConfig(**MODEL[3]), TrainConfig(batch_size=4), device="cpu")
    assert dict(trainer.mesh.shape) == {"data": 1} and not trainer.mesh.distributed
    with pytest.raises(ValueError, match="tp=2 does not divide the world size 1"):
        Trainer(ModelConfig(**MODEL[3]), TrainConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh((1, 2), (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS))


def test_a_rank_without_a_card_raises(monkeypatch):
    """Under torchrun a rank's device is cuda:LOCAL_RANK; with no card that
    raises before any group is made, as core/device.py does."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed()
    assert not torch.distributed.is_initialized()


def test_local_batch_size_and_shard_batch():
    mesh = mesh_lib.Mesh({"data": 2, "model": 2}, rank=3)
    assert (mesh.data_index, mesh.model_index) == (1, 1)
    assert mesh_lib.local_batch_size(6, mesh) == 3
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        mesh_lib.local_batch_size(5, mesh)
    batch = {"image": np.arange(6), "seg": torch.arange(6)}
    rows = mesh_lib.shard_batch(batch, mesh, 6)
    assert rows["image"].tolist() == [3, 4, 5] and rows["seg"].tolist() == [3, 4, 5]
    assert mesh_lib.shard_batch(rows, mesh, 6)["image"].tolist() == [3, 4, 5]  # a share passes
    with pytest.raises(ValueError, match="neither the global batch"):
        mesh_lib.shard_batch({"image": np.arange(4)}, mesh, 6)
    assert not mesh_lib.Mesh({"data": 2, "model": 2}, rank=5).active


def test_sharding_rule_picks_the_largest_dim_in_flax_order():
    """A dense kernel is (out, in) in torch and (in, out) in flax: at a tie
    the rule takes flax's first dim, which is torch's last."""
    model = torch.nn.Module()
    model.square = torch.nn.Linear(64, 64)  # flax (64, 64): dim 0 -> torch dim 1
    model.wide = torch.nn.Linear(32, 128)  # flax (32, 128): dim 1 -> torch dim 0
    model.conv = torch.nn.Conv2d(16, 48, 3)  # flax (3, 3, 16, 48): dim 3 -> torch dim 0
    model.odd = torch.nn.Linear(63, 63)  # no dim divisible by 2
    rules = param_sharding_rules(model, mesh_lib.Mesh({"data": 1, "model": 2}), min_size=2**10)
    assert rules == {"square.kernel": 1, "square.bias": None, "wide.kernel": 0,
                     "wide.bias": None, "conv.kernel": 0, "conv.bias": None,
                     "odd.kernel": None, "odd.bias": None}
    layouts = flax_param_layouts(model)
    assert flax_shape(layouts["conv.kernel"][0].shape, "conv") == (3, 3, 16, 48)
    assert set(param_sharding_rules(model, mesh_lib.Mesh({"data": 2}))) == set(rules)
    assert not any(param_sharding_rules(model, mesh_lib.Mesh({"data": 2})).values())


def test_all_reduce_sum_backward_sums_over_the_group(tmp_path):
    """On one process the collectives are identities; their wiring across
    ranks is what the spawned tests check."""
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        group = torch.distributed.new_group([0])
        x = torch.arange(6.0, requires_grad=True)
        y = comm.all_reduce_sum(x * 2, group)
        y.sum().backward()
        assert torch.equal(y, torch.arange(6.0) * 2) and torch.equal(x.grad, torch.full((6,), 2.0))
        ts = [torch.ones(3), torch.ones(2, 2)]
        comm.all_reduce_buckets_(ts, group, bucket_bytes=8)
        assert all(torch.equal(t, torch.ones_like(t)) for t in ts)
        assert torch.equal(comm.all_gather_dim(torch.ones(2, 3), 1, group), torch.ones(2, 3))
    finally:
        torch.distributed.destroy_process_group()
