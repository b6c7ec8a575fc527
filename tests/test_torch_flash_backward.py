"""The attention gradients of the port against the JAX package, on the CPU.

* K7's plain version (``global_attention_backward_plain``) and the
  ``autograd.Function`` behind ``global_attention`` (whose CPU backward is
  that plain version) against ``jax.vjp`` of ``xla_reference`` and against
  the Pallas backward ``_flash_backward(..., interpret=True)``, on the
  backward cases of tests/test_global_attention.py plus a bf16 one;
* K1's ``autograd.Function`` (forward the plain version here, backward a
  recompute through it) against ``jax.vjp`` of the window attention's
  ``xla_reference``: dq, dk, dv, dtau and dB, with and without a mask.
(K2's gradient is in tests/test_torch_segment_sum_grad.py.)

Inputs come from a numpy seed and go to both stacks. Tolerances:
``F32_TOL`` = 3e-5 (atol = rtol), the bound tests/test_global_attention.py
holds the Pallas backward to against the XLA one: the same math with f32
sums in another order. ``BF16_TOL`` = 2e-2: dq, dk and dv are rounded to
bf16, and the port keeps P in f32 in all products where the XLA VJP uses
the bf16-rounded P in dv (2^-9 of each weight).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.ops import window_attention as jax_wa
from soccdpt_tpu.ops.global_attention import _flash_backward, xla_reference

from soccdpt_torch.kernels import ops as kernel_ops
from soccdpt_torch.kernels.global_attention import (
    global_attention,
    global_attention_backward,
    global_attention_backward_plain,
    global_attention_with_lse,
)
from soccdpt_torch.kernels.window_attention import window_attention

torch.set_num_threads(2)  # the suite runs several worker processes side by side
F32_TOL, BF16_TOL = 3e-5, 2e-2

# (B, H, T, d, bias, dtype)
CASES = [
    (1, 2, 128, 32, True, "float32"),  # whole tiles
    (1, 2, 128, 32, False, "float32"),  # no bias (plain ViT)
    (2, 2, 65, 16, True, "float32"),  # T = 65, batch 2: dbias sums over the images
    (1, 3, 257, 64, True, "float32"),  # T no multiple of any tile
    (3, 2, 260, 32, False, "float32"),  # several blocks and images, no bias
    (2, 2, 130, 32, True, "bfloat16"),  # the bf16 case
]


def _inputs(B, H, T, d, bias, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4))
    b = rng.standard_normal((H, T, T)).astype(np.float32) if bias else None
    return q, k, v, b, g


def _both(B, H, T, d, bias, dtype):
    q, k, v, b, g = _inputs(B, H, T, d, bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    return jargs, jb, jnp.asarray(g, jdt), targs, tb, torch.from_numpy(g).to(tdt), d**-0.5


def _jax_grads(reference, jargs, jb, jg, scale):
    if reference == "pallas_interpret":
        return _flash_backward(*jargs, jb, jg, scale, interpret=True)
    if jb is None:
        _, vjp = jax.vjp(lambda q, k, v: xla_reference(q, k, v, None, scale), *jargs)
        return (*vjp(jg), None)
    _, vjp = jax.vjp(lambda q, k, v, b: xla_reference(q, k, v, b, scale), *jargs, jb)
    return vjp(jg)


def _assert_grads(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(
            a.detach().float().numpy(), np.asarray(w, np.float32), atol=tol, rtol=tol,
            err_msg=name,
        )


@pytest.mark.parametrize("reference", ["xla_vjp", "pallas_interpret"])
@pytest.mark.parametrize("B,H,T,d,bias,dtype", CASES)
def test_plain_backward_matches_jax(B, H, T, d, bias, dtype, reference):
    jargs, jb, jg, targs, tb, tg, scale = _both(B, H, T, d, bias, dtype)
    want = _jax_grads(reference, jargs, jb, jg, scale)
    got = global_attention_backward_plain(*targs, tb, scale, tg)
    assert all(a.dtype == t.dtype for a, t in zip(got[:3], targs))
    _assert_grads(got, want, dtype)


@pytest.mark.parametrize("B,H,T,d,bias,dtype", CASES)
def test_function_backward_matches_jax_vjp(B, H, T, d, bias, dtype):
    """``loss.backward()`` through ``global_attention`` on CPU tensors."""
    jargs, jb, jg, targs, tb, tg, scale = _both(B, H, T, d, bias, dtype)
    want = _jax_grads("xla_vjp", jargs, jb, jg, scale)
    leaves = [t.requires_grad_() for t in targs] + ([tb.requires_grad_()] if bias else [])
    kernels = ("global_attention", "global_attention_backward")
    launches = [kernel_ops.launches()[k] for k in kernels]
    out = global_attention(*targs, tb, scale)
    out.backward(tg)
    assert launches == [kernel_ops.launches()[k] for k in kernels]
    got = [t.grad for t in leaves] + ([] if bias else [None])
    _assert_grads(got, want, dtype)


def test_a_frozen_bias_gets_no_gradient():
    """``dbias`` is returned only when the bias needs a gradient: under the
    default ``encoder_percentage`` half the tables are frozen."""
    _, _, _, (q, k, v), b, g, scale = _both(2, 2, 65, 16, True, "float32")
    q.requires_grad_()
    global_attention(q, k, v, b, scale).backward(g)
    assert b.grad is None and q.grad is not None and k.grad is None
    want = global_attention_backward_plain(q.detach(), k, v, b, scale, g)
    np.testing.assert_array_equal(q.grad.numpy(), want[0].numpy())
    assert global_attention_backward(q.detach(), k, v, b, scale, g, want_dbias=False)[3] is None


def test_without_gradients_the_call_is_the_bare_forward():
    _, _, _, (q, k, v), b, _, scale = _both(1, 2, 65, 16, True, "float32")
    assert global_attention(q, k, v, b, scale).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert global_attention(q, k, v, b, scale).grad_fn is None
    assert global_attention(q, k, v, b, scale).grad_fn is not None


def test_lse_is_the_log_sum_exp_of_the_scores():
    jargs, jb, _, targs, tb, _, scale = _both(2, 2, 65, 16, True, "float32")
    s = jnp.einsum("bhnd,bhmd->bhnm", jargs[0], jargs[1]) * scale + jb[None]
    out, lse = global_attention_with_lse(*targs, tb, scale)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(s, axis=-1)), atol=1e-5, rtol=1e-5
    )
    np.testing.assert_allclose(
        out.numpy(), np.asarray(xla_reference(*jargs, jb, scale)), atol=2e-5, rtol=2e-5
    )


# --- K1 -------------------------------------------------------------------------


def _window_inputs(Bw, H, N, d, nW, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((Bw, H, N, d)).astype(np.float32) for _ in range(4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    tau = np.exp(0.3 * rng.standard_normal((H, 1, 1))).astype(np.float32)
    bias = (16 / (1 + np.exp(-rng.standard_normal((H, N, N))))).astype(np.float32)
    mask = None
    if nW is not None:
        mask = np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
    return (q, k, v, tau, bias), mask, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nW", [None, 4])
def test_window_attention_function_matches_jax_vjp(nW, dtype):
    """dq, dk, dv, dtau and dB; the mask gets no gradient."""
    args, mask, g = _window_inputs(8, 2, 16, 16, nW)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args[:3]] + [jnp.asarray(a) for a in args[3:]]
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jax_wa.xla_reference(*a, jmask), *jargs)
    want = vjp(jnp.asarray(g, jdt))

    targs = [torch.from_numpy(a).to(tdt) for a in args[:3]] + [torch.from_numpy(a) for a in args[3:]]
    targs = [t.requires_grad_() for t in targs]
    tmask = None if mask is None else torch.from_numpy(mask)
    launches = kernel_ops.launches()["window_attention"]
    out = window_attention(*targs, tmask)
    assert type(out.grad_fn).__name__ == "_WindowAttentionBackward"
    out.backward(torch.from_numpy(g).to(tdt))
    assert kernel_ops.launches()["window_attention"] == launches  # CPU tensors: no kernel
    _assert_grads([t.grad for t in targs], want, dtype)


def test_window_attention_without_gradients_is_the_bare_forward():
    args, _, _ = _window_inputs(4, 2, 16, 16, None)
    targs = [torch.from_numpy(a) for a in args]
    assert window_attention(*targs).grad_fn is None
    targs[3].requires_grad_()  # tau alone
    out = window_attention(*targs)
    out.sum().backward()
    assert targs[3].grad is not None and targs[0].grad is None
