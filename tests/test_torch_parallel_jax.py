"""Data and tensor parallelism of the port against the JAX package, on the
CPU.

* The port's sharding rule (``parallel/sharding.py``) at the flagship's
  shapes against the JAX rule on ``jax.eval_shape`` of the flagship, on a
  (4, 2) mesh of the 8 CPU devices.
* A step of tiny V3 and V1 (BatchNorm in the seg head, and in V1's seg
  decoder) on 2-rank gloo meshes, (2, 1) and (1, 2), spawned from the
  jax-free ``tests/torch_parallel_worker.py``, against the JAX ``Trainer``'s
  step on one device, from one weight set, at global batch 4 with masks
  whose counts differ between the halves of the batch.
* A JAX ``Trainer`` checkpoint (orbax, two steps) converted by
  ``scripts/orbax_to_npz.py``: the port resumes from it to JAX's third
  step, and ``cli/eval.py -l`` reads it.

JAX runs without dropout and stochastic depth (the two stacks draw other
numbers) and with flax's BatchNorm variance in two passes, as the port
takes it (tests/test_torch_swin1.py). Tolerances are the ladder of
tests/test_composition_oracle.py:34-45 and tests/test_torch_training.py:
the loss to ``LOSS_RTOL`` = 1e-4 relative; Adam's first moment (a tenth of
the gradient after one step) to ``GRAD_RTOL`` = 2e-3 of each leaf's norm
plus ``GRAD_ATOL`` = 1e-6 of the largest; the running statistics to 1e-5
of their norm; every weight to the ladder's 1e-4 (an Adam step moves a
leaf by about the learning rate of 1e-5).

The ranks' moments add ``SPREAD_FACTOR`` = 4 times the port's own spread
to each leaf's bound, as chip_smoke.py does for its ill-conditioned
trunks: one process of the port on one CPU thread against two, which sum
in other orders. In V1's depth trunk at these weights that spread alone
reaches 2e-3 of a leaf's norm (the ranks run one thread each and agree bit
for bit with one process on one thread), where V3 stays within the plain
bound.

The resumed third step is held to JAX's on the loss, the running
statistics and the weights, not on the moments: at JAX's second step's
weights the SSI loss's per-image alignment is close to singular (the loss
fell from 877 to 627 in two steps of 1e-5), and the two f32 stacks'
gradients part there by a few 1e-2 of some leaves' norms (the port's own
spread stays near 1e-6; the same gap shows when the port trains the three
steps itself, so it is not the restore's).
"""
import contextlib
import os
import sys

import flax.linen as flax_nn
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import TrainConfig as JaxTrainConfig
from soccdpt_tpu.models.backbones import swin2 as jax_swin2
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.parallel import mesh as jax_mesh
from soccdpt_tpu.parallel.sharding import param_sharding_rules as jax_sharding_rules
from soccdpt_tpu.train.trainer import Trainer as JaxTrainer

from soccdpt_torch.cli import eval as peval
from soccdpt_torch.core.checkpoint import restore_jax_export
from soccdpt_torch.core.config import ModelConfig, TrainConfig
from soccdpt_torch.data import synthetic
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.models.soccdpt import SOccDPT_versions
from soccdpt_torch.parallel.mesh import Mesh
from soccdpt_torch.parallel.sharding import param_sharding_rules
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import _to_flax_layout, flax_param_layouts, to_jax_variables
from soccdpt_torch.weights import torch_dim

from test_torch_modules import perturbed_variables

import torch_parallel_worker as worker

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import orbax_to_npz  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-6
STATS_RTOL = 1e-5
LEAF_ATOL = 1e-4
SPREAD_FACTOR = 4.0
GT_HW = (48, 80)
MODEL_TYPE = "dpt_swin2_test_64"
# V3 at the CLI's default width, so that cli/eval.py reads its checkpoint;
# V1 at the width of tests/test_torch_versions_training.py
FEATURES = {3: 256, 1: 32}
TRAIN = dict(batch_size=4, learning_rate=1e-5, encoder_percentage=1.0)
MESHES = [(2, 1), (1, 2)]
CASES = [(v, m) for v in (3, 1) for m in MESHES]
# the last conv of each seg head, scaled down so its probabilities stay off
# 0 and 1 (the BCE's gradient there is 1 / (1 - p))
SEG_CONV2 = {3: ("seg_head", "conv2"), 1: ("seg_net", "head", "conv2")}

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.array(val, np.float64)
    return out


def _close(got, want, rtol, atol_of_max=0.0, what="", spread=None):
    """Leaf by leaf in 2-norm; ``spread`` adds ``SPREAD_FACTOR`` times the
    port's own spread of each leaf to its bound."""
    got = {k: np.asarray(torch.as_tensor(v).double()) for k, v in got.items()}
    assert sorted(got) == sorted(want), what
    floor = atol_of_max * max(float(np.linalg.norm(w)) for w in want.values())
    for path, w in want.items():
        err, ref = float(np.linalg.norm(got[path] - w)), float(np.linalg.norm(w))
        bound = rtol * ref + floor + SPREAD_FACTOR * (spread or {}).get(path, 0.0)
        assert err <= bound, f"{what} {path}: |diff| {err:.3g} of |{ref:.3g}|"


@contextlib.contextmanager
def jax_as_the_port():
    """The JAX step without dropout and stochastic depth, and with
    BatchNorm's batch variance in two passes, traced inside this block."""
    orig_stats, orig_drop, orig_dropout = (flax_norm._compute_stats, jax_swin2.drop_path,
                                           flax_nn.Dropout.__call__)

    def compute_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return orig_stats(*args, **kwargs)

    flax_norm._compute_stats = compute_stats
    jax_swin2.drop_path = lambda x, rate, deterministic, rng: x
    flax_nn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        yield
    finally:
        flax_norm._compute_stats = orig_stats
        jax_swin2.drop_path = orig_drop
        flax_nn.Dropout.__call__ = orig_dropout


def _jax_state(state):
    opt = state.opt_state.inner_state[0]
    return {"params": _flat(jax.device_get(state.params)),
            "stats": _flat(jax.device_get(state.batch_stats)),
            "mu": _flat(jax.device_get(opt.mu)), "count": int(opt.count),
            "step": int(state.step)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX on one device: V3 three steps (a checkpoint after the second), V1
    one step; the port on 2-rank meshes from the same weights, one step."""
    tmp = str(tmp_path_factory.mktemp("parallel_jax"))
    batch = worker.uneven_masks(make_batch(0, 4, GT_HW, (64, 64)))
    worker.save_batch(os.path.join(tmp, "batch.npz"), batch)
    out = {"tmp": tmp, "batch": batch, "jax": {}}
    single = jax_mesh.make_mesh(shape=(1,), devices=jax.devices()[:1])
    with jax_as_the_port():
        for version in (3, 1):
            jt = JaxTrainer(JaxModelConfig(model_type=MODEL_TYPE, version=version,
                                           features=FEATURES[version]),
                            JaxTrainConfig(**TRAIN), single)
            state = jt.init_state(jax.random.PRNGKey(0), batch["image"][:1])
            variables = perturbed_variables({"params": state.params,
                                             "batch_stats": state.batch_stats}, version)
            conv2 = variables["params"]
            for scope in SEG_CONV2[version]:
                conv2 = conv2[scope]
            conv2["kernel"] = conv2["kernel"] * 0.1
            worker.save_variables(os.path.join(tmp, f"v{version}.npz"), variables)
            state = jt.reshard_state(state.replace(params=variables["params"],
                                                   batch_stats=variables["batch_stats"]))
            runs_v = []
            for step in range(3 if version == 3 else 1):
                state, metrics = jt.train_step(state, batch, jax.random.PRNGKey(1 + step))
                runs_v.append(dict(_jax_state(state), loss=float(metrics["loss"])))
                if version == 3 and step == 1:
                    ckpt = os.path.join(tmp, "orbax_step2")
                    jax_save_checkpoint(ckpt, {"params": state.params,
                                               "batch_stats": state.batch_stats,
                                               "opt_state": state.opt_state,
                                               "step": np.asarray(state.step)})
            out["jax"][version] = runs_v
    cases = [dict(model=dict(model_type=MODEL_TYPE, version=v, features=FEATURES[v]),
                  train=TRAIN, mesh=m,
                  batch=os.path.join(tmp, "batch.npz"), variables=os.path.join(tmp, f"v{v}.npz"))
             for v, m in CASES]
    out["ranks"] = worker.spawn(2, tmp, "cases", cases)
    # the port's own rounding spread: one process on one thread and on two
    out["spread"] = {}
    for case in cases[::2]:
        threads = torch.get_num_threads()
        runs_t = []
        for n in (1, 2):
            torch.set_num_threads(n)
            runs_t.append(worker.single(case)["mu"])
        torch.set_num_threads(threads)
        out["spread"][case["model"]["version"]] = {
            path: float((runs_t[0][path] - runs_t[1][path]).double().norm()) for path in runs_t[0]}
    out["npz"] = os.path.join(tmp, "jax_step2.npz")
    orbax_to_npz.convert(os.path.join(tmp, "orbax_step2"), out["npz"])
    return out


def test_sharding_rule_is_the_jax_rule_at_flagship_shapes():
    jmodel = jax_build_model(JaxModelConfig(model_type="dpt_swin2_tiny_256", version=3))
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x, return_raw=True),
                            jax.ShapeDtypeStruct((1, 3, 256, 256), jnp.float32))
    mesh = jax_mesh.make_mesh(shape=(4, 2), axes=(jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS),
                              devices=jax.devices()[:8])
    rules = jax_sharding_rules(shapes["params"], mesh, min_size=2**16)
    want = set()
    for path, sharding in jax.tree_util.tree_leaves_with_path(rules):
        spec = tuple(sharding.spec)
        if jax_mesh.MODEL_AXIS in spec:
            want.add((".".join(str(k.key) for k in path), spec.index(jax_mesh.MODEL_AXIS)))

    with torch.device("meta"):
        port = SOccDPT_versions[3](ModelConfig(model_type="dpt_swin2_tiny_256"))
    layouts = flax_param_layouts(port)
    got = param_sharding_rules(port, Mesh({"data": 4, "model": 2}), min_size=2**16)
    assert len(got) == len(jax.tree_util.tree_leaves(shapes["params"]))
    got_set = {(path, dim) for path, dim in got.items() if dim is not None}
    assert got_set == {(path, torch_dim(d, layouts[path][1])) for path, d in want}
    assert len(got_set) >= 20
    names = " ".join(path for path, _ in got_set)
    assert "qkv" in names and "mlp_fc1" in names
    for path, dim in got_set:
        assert layouts[path][0].shape[dim] % 2 == 0, path
    assert not any(param_sharding_rules(port, Mesh({"data": 8}), min_size=2**16).values())


@pytest.mark.parametrize("version,mesh", CASES, ids=[f"v{v}-{m[0]}x{m[1]}" for v, m in CASES])
def test_two_rank_step_is_the_jax_single_device_step(runs, version, mesh):
    i = CASES.index((version, mesh))
    want = runs["jax"][version][0]
    for rank in runs["ranks"]:
        got = rank[i]
        assert got["mesh"] == dict(zip(("data", "model"), mesh))
        assert (got["count"], got["step"]) == (want["count"], want["step"]) == (1, 1)
        np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=LOSS_RTOL)
        _close(got["stats"], want["stats"], STATS_RTOL, what="batch_stats")
        # the port's moments are in torch layout: compared in flax layout
        _close(_to_flax(_port_trainer(version), got["mu"]), want["mu"], GRAD_RTOL, GRAD_ATOL,
               what="mu", spread=runs["spread"][version])
        for path, w in want["params"].items():
            np.testing.assert_allclose(got["params"][path], w, atol=LEAF_ATOL, rtol=0,
                                       err_msg=path)


_TRAINERS = {}


def _port_trainer(version):
    if version not in _TRAINERS:
        trainer = Trainer(ModelConfig(model_type=MODEL_TYPE, version=version,
                                      features=FEATURES[version]),
                          TrainConfig(**TRAIN), device="cpu")
        trainer.init_state(0)
        _TRAINERS[version] = trainer
    return _TRAINERS[version]


def _to_flax(trainer, moments):
    """Torch-layout moments by flax path, in flax layout."""
    layouts = flax_param_layouts(trainer.model)
    return {path: _to_flax_layout(np.asarray(torch.as_tensor(m)), layouts[path][1])
            for path, m in moments.items()}


def test_orbax_checkpoint_resumes_in_the_port_to_jax_s_next_step(runs, tmp_path):
    exported = restore_jax_export(runs["npz"])
    step2, step3 = runs["jax"][3][1], runs["jax"][3][2]
    assert exported["step"] == step2["step"] == 2 and exported["opt_state"]["count"] == 2
    assert exported["opt_state"]["learning_rate"] == pytest.approx(TRAIN["learning_rate"])
    trainer = Trainer(ModelConfig(model_type=MODEL_TYPE, version=3), TrainConfig(**TRAIN),
                      device="cpu")
    trainer.init_state(0)
    worker.no_dropout(trainer.model)
    state = trainer.restore_state(exported)
    # the restore is exact: JAX's weights and moments after its second step
    restored = to_jax_variables(trainer.model)
    for path, w in step2["params"].items():
        np.testing.assert_array_equal(_flat(restored["params"])[path], w, err_msg=path)
    _close(_to_flax(trainer, state.mu), step2["mu"], 0.0, what="restored mu")
    assert (state.count, state.step) == (2, 2)

    state, metrics = trainer.train_step(state, runs["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), step3["loss"], rtol=LOSS_RTOL)
    assert (state.count, state.step) == (step3["count"], step3["step"]) == (3, 3)
    after = to_jax_variables(trainer.model)
    _close(_flat(after["batch_stats"]), step3["stats"], STATS_RTOL, what="batch_stats")
    for path, w in step3["params"].items():
        np.testing.assert_allclose(_flat(after["params"])[path], w, atol=LEAF_ATOL, rtol=0,
                                   err_msg=path)

    # the eval CLI serves those weights
    tree = str(tmp_path / "bdd")
    synthetic.make_bdd_fixture(tree, frames_per_seq=3)
    metrics = peval.main(["-v", "3", "-dt", "bdd", "-t", MODEL_TYPE, "-b", tree,
                          "-l", runs["npz"], "--num_samples", "1", "--skip_fps",
                          "--media_dir", str(tmp_path / "media"), "--device", "cpu"])
    assert all(np.isfinite(v) for v in metrics.values())


def test_the_converter_names_the_optax_leaves_it_reads(runs):
    with np.load(runs["npz"]) as npz:
        keys = set(npz.files)
    trainer = _port_trainer(3)
    paths = {p.replace(".", "/") for p in flax_param_layouts(trainer.model)}
    assert {k[len("params/"):] for k in keys if k.startswith("params/")} == paths
    assert {k[len("opt_state/mu/"):] for k in keys if k.startswith("opt_state/mu/")} == paths
    assert {k[len("opt_state/nu/"):] for k in keys if k.startswith("opt_state/nu/")} == paths
    assert {"opt_state/count", "opt_state/learning_rate", "step"} <= keys
    assert any(k.startswith("batch_stats/seg_head/bn/") for k in keys)
