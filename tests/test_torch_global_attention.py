"""K6's plain version against the JAX package, on the CPU.

``global_attention_plain`` is what the CUDA kernel is held to on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py); here it is held to the
JAX package's ``xla_reference`` and to its Pallas kernel in interpret
mode (``flash_mha(..., interpret=True)``), on the forward cases of
tests/test_global_attention.py, with that file's tolerances: atol = rtol
= 2e-5 in f32 (the same math, f32 sums in another order), 2e-2 in bf16
(both round the probabilities to bf16 before P.V and round the output).
Inputs come from a numpy seed and go to both stacks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.ops.global_attention import flash_mha, xla_reference

from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.kernels.global_attention import global_attention, global_attention_plain

CASES = [
    (1, 2, 128, 32, True, "float32"),  # aligned, with bias
    (1, 2, 128, 32, False, "float32"),  # aligned, no bias (plain ViT)
    (2, 2, 65, 16, True, "float32"),  # cls token -> odd T
    (1, 3, 257, 64, True, "float32"),  # several query blocks
    (1, 2, 130, 32, True, "bfloat16"),  # the bf16 case
]


def _inputs(B, H, T, d, bias, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(3))
    b = rng.standard_normal((H, T, T)).astype(np.float32) if bias else None
    return q, k, v, b


def _both(B, H, T, d, bias, dtype, bias_dtype="float32"):
    q, k, v, b = _inputs(B, H, T, d, bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    jb = tb = None
    if bias:
        jb = jnp.asarray(b, getattr(jnp, bias_dtype))
        tb = torch.from_numpy(b).to(getattr(torch, bias_dtype))
    return jargs, jb, targs, tb, d**-0.5


@pytest.mark.parametrize("reference", ["xla_reference", "flash_mha_interpret"])
@pytest.mark.parametrize("B,H,T,d,bias,dtype", CASES)
def test_plain_version_matches_jax(B, H, T, d, bias, dtype, reference):
    jargs, jb, targs, tb, scale = _both(B, H, T, d, bias, dtype)
    if reference == "xla_reference":
        want = xla_reference(*jargs, jb, scale)
    else:
        want = flash_mha(*jargs, jb, scale=scale, interpret=True)
    got = global_attention_plain(*targs, tb, scale)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (B, H, T, d)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_bias_is_read_in_its_own_dtype(dtype):
    """A bf16-stored bias (the bf16 bias cache) widens to f32 inside, as
    the Pallas kernel widens it in VMEM."""
    jargs, jb, targs, tb, scale = _both(1, 2, 130, 32, True, dtype, bias_dtype="bfloat16")
    want = flash_mha(*jargs, jb, scale=scale, interpret=True)
    got = global_attention_plain(*targs, tb, scale)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    _, _, targs, tb, scale = _both(2, 2, 65, 16, True, "float32")
    launches = kernel_ops.launches()["global_attention"]
    got = global_attention(*targs, tb, scale)
    assert kernel_ops.launches()["global_attention"] == launches  # no kernel on the CPU
    np.testing.assert_array_equal(
        got.numpy(), global_attention_plain(*targs, tb, scale).numpy()
    )


def test_bias_changes_the_output():
    """The comparison cases would catch a dropped bias: it moves the output
    far beyond the tolerance."""
    _, _, targs, tb, scale = _both(1, 2, 128, 32, True, "float32")
    with_bias = global_attention_plain(*targs, tb, scale)
    without = global_attention_plain(*targs, None, scale)
    assert float((with_bias - without).abs().max()) > 0.1


BAD_ARGS = {
    "head dim": lambda q, k, v, b: (q[..., :12], k[..., :12], v[..., :12], b),
    "f32 or bf16": lambda q, k, v, b: (q.half(), k.half(), v.half(), b),
    "share shape and dtype": lambda q, k, v, b: (q, k[:, :, :8], v, b),
    "bias must be": lambda q, k, v, b: (q, k, v, b[:, :8]),
    "bias must be f32 or bf16": lambda q, k, v, b: (q, k, v, b.double()),
    r"\(B, H, T, d\)": lambda q, k, v, b: (q[0], k[0], v[0], b),
}


@pytest.mark.parametrize("match", list(BAD_ARGS))
def test_wrapper_rejects_what_the_kernel_does_not_take(match):
    """The checks run before the device is looked at, so they hold here
    as they do on the card."""
    q, k, v, b = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 16, True))
    with pytest.raises(ValueError, match=match):
        global_attention(*BAD_ARGS[match](q, k, v, b))
