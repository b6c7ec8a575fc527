"""K3, K4 and K5 (the decoder convolutions) of the port against the JAX
package, on the CPU.

Every case of tests/test_fused_rcu.py, tests/test_fused_fusion.py and
tests/test_fused_head.py: the same numpy-seeded inputs go through the JAX
Pallas kernel in interpret mode (as those files run it), through its XLA
reference, and through the port's wrapper, which on CPU tensors runs its
plain version and launches nothing. Then each plain version against the
port's own module: K3 against ``ResidualConvUnit(use_bn=False)``, K4
against the tail of ``FeatureFusionBlock`` (``res_conv_unit2``,
``out_conv``, the 2x upsample), K5 against ``DepthHead`` after ``conv1``,
with the modules' torch-layout weights taken to the wrappers' HWIO
through ``_conv.conv_weights``.

Tolerances: the JAX tests' own, 2e-4 (K3), 3e-4 (K4) and atol = rtol =
2e-5 (K5) in f32, rtol 1e-5 in the all-ones border cases; 1e-5 against the
port's modules, which run the same f32 operations in another grouping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.models.heads import DepthHead as JaxDepthHead
from soccdpt_tpu.ops.fused_fusion import fused_rcu_tail as jax_fused_rcu_tail
from soccdpt_tpu.ops.fused_fusion import xla_fusion_tail
from soccdpt_tpu.ops.fused_head import fused_head_tail as jax_fused_head_tail
from soccdpt_tpu.ops.fused_head import xla_head_tail
from soccdpt_tpu.ops.fused_rcu import fused_rcu as jax_fused_rcu
from soccdpt_tpu.ops.fused_rcu import xla_rcu

from soccdpt_torch.kernels import _conv
from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.kernels.fused_fusion import fused_rcu_tail
from soccdpt_torch.kernels.fused_head import fused_head_tail
from soccdpt_torch.kernels.fused_rcu import fused_rcu
from soccdpt_torch.models.dpt import FeatureFusionBlock, ResidualConvUnit
from soccdpt_torch.models.heads import DepthHead
from soccdpt_torch.models.layers import conv_nhwc
from soccdpt_torch.weights import init_random_, load_jax_variables

from test_torch_modules import to_np

MODULE_TOL = 1e-5


def _decoder_inputs(B=1, H=16, W=16, C=32, seed=0):
    """tests/test_fused_fusion.py's ``_inputs`` (its first five arrays are
    tests/test_fused_rcu.py's): s, w1, b1, w2, b2, wo, bo."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    b1 = rng.standard_normal(C).astype(np.float32) * 0.1
    b2 = rng.standard_normal(C).astype(np.float32) * 0.1
    wo = (rng.standard_normal((C, C)) * 0.05).astype(np.float32)
    bo = rng.standard_normal(C).astype(np.float32) * 0.1
    return s, w1, b1, w2, b2, wo, bo


def _head_inputs(B, H, W, Ci, Cm, seed=0):
    """tests/test_fused_head.py's ``_mk``: x, w2, b2, w3, b3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, Ci))
    w2 = rng.standard_normal((3, 3, Ci, Cm)) * 0.1
    b2 = rng.standard_normal((Cm,)) * 0.1
    w3 = rng.standard_normal((Cm,)) * 0.1
    b3 = rng.standard_normal(())
    return [np.asarray(a, np.float32) for a in (x, w2, b2, w3, b3)]


def _port(fn, arrays):
    """The port's wrapper on CPU tensors: the plain version, no launch."""
    before = kernel_ops.launches()[fn.__name__]
    with torch.no_grad():
        out = fn(*[torch.from_numpy(np.array(a)) for a in arrays])
    assert kernel_ops.launches()[fn.__name__] == before
    return to_np(out)


def _three_way(jax_kernel, jax_reference, got, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(got, np.asarray(jax_kernel), atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, np.asarray(jax_reference), atol=atol, rtol=rtol)


# --- K3: tests/test_fused_rcu.py ----------------------------------------------------


@pytest.mark.parametrize("B,H,W,C,seed,tile", [(1, 16, 16, 32, 0, (8, 8)),
                                               (2, 24, 16, 16, 1, (8, 16))])
def test_fused_rcu_matches_jax(B, H, W, C, seed, tile):
    x, w1, b1, w2, b2, _, _ = _decoder_inputs(B, H, W, C, seed)
    args = (x, w1, b1, w2, b2)
    jargs = [jnp.asarray(a) for a in args]
    _three_way(jax_fused_rcu(*jargs, tile=tile, interpret=True), xla_rcu(*jargs),
               _port(fused_rcu, args), atol=2e-4)


def test_fused_rcu_border_zero_padding_matches_jax():
    C = 8
    x = np.ones((1, 8, 8, C), np.float32)
    w = np.full((3, 3, C, C), 0.01, np.float32)
    b = np.zeros(C, np.float32)
    args = (x, w, b, w, b)
    jargs = [jnp.asarray(a) for a in args]
    _three_way(jax_fused_rcu(*jargs, tile=(8, 8), interpret=True), xla_rcu(*jargs),
               _port(fused_rcu, args), rtol=1e-5)


# --- K4: tests/test_fused_fusion.py ---------------------------------------------------


@pytest.mark.parametrize("B,H,W,C,seed,tile", [(1, 16, 16, 32, 0, (8, 8)),
                                               (2, 24, 16, 16, 1, (8, 16))])
def test_fused_rcu_tail_matches_jax(B, H, W, C, seed, tile):
    args = _decoder_inputs(B, H, W, C, seed)
    jargs = [jnp.asarray(a) for a in args]
    got = _port(fused_rcu_tail, args)
    assert got.shape == (B, 2 * H, 2 * W, C)
    _three_way(jax_fused_rcu_tail(*jargs, tile=tile, interpret=True), xla_fusion_tail(*jargs),
               got, atol=3e-4)


def test_fused_rcu_tail_border_matches_jax():
    C = 8
    s = np.ones((1, 8, 8, C), np.float32)
    w = np.full((3, 3, C, C), 0.01, np.float32)
    wo = np.eye(C, dtype=np.float32) * 0.5
    b = np.zeros(C, np.float32)
    args = (s, w, b, w, b, wo, b)
    jargs = [jnp.asarray(a) for a in args]
    _three_way(jax_fused_rcu_tail(*jargs, tile=(8, 8), interpret=True), xla_fusion_tail(*jargs),
               _port(fused_rcu_tail, args), rtol=1e-5)


def test_fused_rcu_tail_takes_both_out_conv_layouts():
    s, w1, b1, w2, b2, wo, bo = _decoder_inputs(1, 5, 7, 16, 2)
    flat = _port(fused_rcu_tail, (s, w1, b1, w2, b2, wo, bo))
    hwio = _port(fused_rcu_tail, (s, w1, b1, w2, b2, wo.reshape(1, 1, 16, 16), bo))
    np.testing.assert_array_equal(flat, hwio)
    want = xla_fusion_tail(*[jnp.asarray(a) for a in (s, w1, b1, w2, b2, wo, bo)])
    np.testing.assert_allclose(flat, np.asarray(want), atol=3e-4)  # ragged: 5 x 7


# --- K5: tests/test_fused_head.py -----------------------------------------------------


@pytest.mark.parametrize("B,H,W,Ci,Cm,tile", [(1, 16, 16, 8, 8, None),
                                              (2, 16, 32, 16, 8, (8, 16)),
                                              (1, 8, 8, 8, 16, (4, 8))])
def test_fused_head_tail_matches_jax(B, H, W, Ci, Cm, tile):
    args = _head_inputs(B, H, W, Ci, Cm)
    jargs = [jnp.asarray(a) for a in args]
    got = _port(fused_head_tail, args)
    assert got.shape == (B, 2 * H, 2 * W)
    _three_way(jax_fused_head_tail(*jargs, tile=tile, interpret=True), xla_head_tail(*jargs),
               got, atol=2e-5, rtol=2e-5)


def test_fused_head_tail_matches_the_jax_depth_head_module():
    """The JAX test's DepthHead case: its conv1 in JAX, its tail through the
    port, held to the whole JAX head."""
    B, H, W, F = 1, 16, 16, 16
    head = JaxDepthHead(head_features_1=F, head_features_2=8)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((B, H, W, F)), jnp.float32)
    variables = head.init(jax.random.PRNGKey(0), x)
    want = head.apply(variables, x)
    p = variables["params"]
    mid = jax.lax.conv_general_dilated(
        x, p["conv1"]["kernel"], (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + p["conv1"]["bias"]
    args = (mid, p["conv2"]["kernel"], p["conv2"]["bias"], p["conv3"]["kernel"],
            p["conv3"]["bias"])
    got = _port(fused_head_tail, [np.asarray(a, np.float32) for a in args])
    np.testing.assert_allclose(got, np.asarray(want[..., 0]), atol=2e-5, rtol=2e-5)


def test_fused_head_tail_gradients_match_jax():
    """The port's ``autograd.Function`` (the plain forward on the CPU, the
    recompute backward) against ``jax.grad`` of the Pallas kernel's custom
    VJP in interpret mode, every input."""
    args = _head_inputs(1, 8, 8, 8, 8)

    def loss_pallas(*a):
        return jax_fused_head_tail(*a, tile=(4, 8), interpret=True).sum()

    want = jax.grad(loss_pallas, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = kernel_ops.launches()["fused_head_tail"]
    fused_head_tail(*leaves).sum().backward()
    assert kernel_ops.launches()["fused_head_tail"] == before
    for name, t, w in zip(("x", "w2", "b2", "w3", "b3"), leaves, want):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(to_np(t.grad), np.asarray(w), atol=2e-5, rtol=2e-5,
                                   err_msg=name)


# --- the plain versions against the port's own modules -------------------------------


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_fused_rcu_is_the_ports_residual_conv_unit():
    rcu = init_random_(ResidualConvUnit(32, use_bn=False), seed=5).eval()
    x = _x((2, 9, 7, 32), 5)
    w1, b1 = _conv.conv_weights(rcu.conv1)
    w2, b2 = _conv.conv_weights(rcu.conv2)
    with torch.no_grad():
        got, want = fused_rcu(x, w1, b1, w2, b2), rcu(x)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_fused_rcu_tail_is_the_ports_fusion_block_tail():
    """``FeatureFusionBlock`` without a skip and without a size is exactly
    the tail: ``res_conv_unit2``, ``out_conv``, the 2x upsample."""
    block = init_random_(FeatureFusionBlock(16, with_skip=False), seed=6).eval()
    s = _x((2, 6, 11, 16), 6)
    rcu = block.res_conv_unit2
    args = (*_conv.conv_weights(rcu.conv1), *_conv.conv_weights(rcu.conv2),
            *_conv.conv_weights(block.out_conv))
    with torch.no_grad():
        got, want = fused_rcu_tail(s, *args), block(s)
    assert tuple(got.shape) == (2, 12, 22, 16)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_fused_head_tail_is_the_ports_depth_head_after_conv1():
    head = init_random_(DepthHead(32, 32, 8, non_negative=True), seed=7).eval()
    x = _x((2, 10, 12, 32), 7)
    with torch.no_grad():
        mid = conv_nhwc(head.conv1, x)
        got = fused_head_tail(mid, *_conv.conv_weights(head.conv2),
                              *_conv.conv_weights(head.conv3))
        want = head(x)[..., 0]
    assert tuple(got.shape) == (2, 20, 24)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=MODULE_TOL, rtol=MODULE_TOL)


def test_conv_weights_loads_as_the_jax_layout():
    """A JAX DepthHead's kernels through ``load_jax_variables`` into the
    port, then back out through ``conv_weights``: the HWIO arrays again."""
    jhead = JaxDepthHead(head_features_1=16, head_features_2=8)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 4, 16)))
    port = load_jax_variables(DepthHead(16, 16, 8), variables)
    for name in ("conv1", "conv2", "conv3"):
        kernel, bias = _conv.conv_weights(getattr(port, name))
        np.testing.assert_array_equal(to_np(kernel), np.asarray(variables["params"][name]["kernel"]))
        np.testing.assert_array_equal(to_np(bias), np.asarray(variables["params"][name]["bias"]))


def test_wrappers_check_their_arguments():
    s, w1, b1, w2, b2, wo, bo = [torch.from_numpy(a) for a in _decoder_inputs(1, 4, 4, 12)]
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_rcu(s, w1, b1, w2, b2)
    s, w1, b1, w2, b2, wo, bo = [torch.from_numpy(a) for a in _decoder_inputs(1, 4, 4, 16)]
    with pytest.raises(ValueError, match="w2"):
        fused_rcu(s, w1, b1, w2[:, :, :8], b2)
    with pytest.raises(ValueError, match="out_w"):
        fused_rcu_tail(s, w1, b1, w2, b2, wo[:8], bo)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_rcu(s.half(), w1, b1, w2, b2)
    x, hw2, hb2, hw3, hb3 = [torch.from_numpy(a) for a in _head_inputs(1, 4, 4, 8, 6)]
    with pytest.raises(ValueError, match="Cm must be a multiple of 4"):
        fused_head_tail(x, hw2, hb2, hw3, hb3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_rcu(s.to("meta"), w1, b1, w2, b2)
