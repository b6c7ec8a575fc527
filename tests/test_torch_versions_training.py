"""Training SOccDPT V1 and V2 with the port against the JAX package, on
the CPU: the loss and every leaf's gradient against ``jax.value_and_grad``.

The weight flow and the tolerances are those of tests/test_torch_training.py
(``LOSS_RTOL`` on the loss; ``GRAD_RTOL`` of each leaf's norm plus
``GRAD_ATOL`` of the largest leaf norm on the gradients). V1 is the first
trained decoder with BatchNorm in its fusion blocks (its seg DPT); V2
trains one trunk under two heads. This file holds two whole-model
``jax.jit(value_and_grad)`` compiles, so it stands alone and the suite's
workers take it beside tests/test_torch_training.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model

from soccdpt_torch.core.config import ModelConfig, TrainConfig
from soccdpt_torch.data.synthetic import make_batch
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.train.patchwise import select_trainable
from soccdpt_torch.train.trainer import Trainer
from soccdpt_torch.weights import load_jax_variables, named_flax_params, to_jax_variables

from test_torch_modules import perturbed_variables
from test_torch_training import (
    GRAD_ATOL,
    GRAD_RTOL,
    GT_HW,
    LOSS_RTOL,
    _assert_same_leaves,
    _jax_loss,
)

MODEL_TYPE = "dpt_swin2_test_64"
# the last conv of each seg head, scaled down so its probabilities stay off
# 0 and 1 (the BCE's gradient there is 1 / (1 - p))
SEG_CONV2 = {1: ("seg_net", "head", "conv2"), 2: ("seg_head", "conv2")}


@functools.lru_cache(maxsize=None)
def _jax_side(version, seed=0):
    jmodel = jax_build_model(JaxModelConfig(model_type=MODEL_TYPE, version=version, features=32))
    init = jax.jit(lambda key, x: jmodel.init(key, x, return_raw=True))
    variables = perturbed_variables(init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 64, 64))), seed)
    conv2 = variables["params"]
    for scope in SEG_CONV2[version]:
        conv2 = conv2[scope]
    conv2["kernel"] = conv2["kernel"] * 0.1
    return jmodel, variables


@pytest.mark.parametrize("version", [1, 2])
def test_loss_and_gradients_match_jax(version):
    jmodel, variables = _jax_side(version)
    batch = make_batch(0, 2, GT_HW, (64, 64))
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, variables["batch_stats"], batch)
    ))(variables["params"])

    trainer = Trainer(
        ModelConfig(model_type=MODEL_TYPE, version=version, features=32),
        TrainConfig(batch_size=2, encoder_percentage=1.0), device="cpu",
    )
    trainer.init_state(0)
    model = load_jax_variables(trainer.model, variables).eval()
    select_trainable(model, trainer.masks[0])
    launches = kernel_ops.launches()["window_attention"]
    loss, aux = trainer.loss(trainer.to_device_batch(batch))
    loss.backward()
    assert kernel_ops.launches()["window_attention"] == launches  # CPU: the plain versions
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    assert set(aux) == {"loss_disp", "loss_seg"}
    assert all(p.grad is not None for _, p in named_flax_params(model))
    got = to_jax_variables(model, grads=True)["params"]
    want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    path, share = _assert_same_leaves(got, want_grads, GRAD_RTOL, GRAD_ATOL, what="gradient")
    print(f"V{version}: worst leaf {path} at {share:.2f} of its bound")
