"""K1, window attention: the port's plain version against the JAX
package's Pallas kernels (interpret mode) and ``xla_reference``, on the
CPU. The CUDA kernel is held to the plain version on the card in
tests/test_torch_kernels_gpu.py.

Tolerances, with their reasons:
* f32: atol 2e-5, the bound tests/test_window_attention.py holds the
  Pallas kernels to (same math, f32 sums in another order);
* bf16 IO: atol 5e-2, the bound that file uses for bf16: both sides round
  the probabilities and the output to bf16 (half an ulp is 7.8e-3 at
  |out| near 4) after f32 sums taken in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.ops.window_attention import (
    cosine_window_attention,
    cosine_window_attention_batched,
    xla_reference,
)

from soccdpt_torch.kernels.window_attention import (
    check_kernel_shape,
    window_attention,
    window_attention_plain,
)

F32_ATOL = 2e-5
BF16_ATOL = 5e-2


def _inputs(Bw=8, H=3, N=64, d=32, seed=0, with_mask=False, nW=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bw, H, N, d)).astype(np.float32)
    k = rng.standard_normal((Bw, H, N, d)).astype(np.float32)
    v = rng.standard_normal((Bw, H, N, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    scale = np.exp(rng.standard_normal((H, 1, 1))).astype(np.float32)
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
    return (q, k, v, scale, bias), mask


def _port(arrays, mask, dtype=torch.float32):
    q, k, v, scale, bias = (torch.from_numpy(a) for a in arrays)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    m = None if mask is None else torch.from_numpy(mask)
    return window_attention(q, k, v, scale, bias, m)


@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_matches_pallas_kernel(with_mask):
    arrays, mask = _inputs(with_mask=with_mask)
    want = cosine_window_attention(
        *map(jnp.asarray, arrays), None if mask is None else jnp.asarray(mask),
        interpret=True,
    )
    got = _port(arrays, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_matches_batched_kernel(with_mask):
    arrays, mask = _inputs(Bw=16, H=2, N=64, d=32, with_mask=with_mask, nW=8)
    want = cosine_window_attention_batched(
        *map(jnp.asarray, arrays), None if mask is None else jnp.asarray(mask),
        interpret=True,
    )
    np.testing.assert_allclose(_port(arrays, mask).numpy(), np.asarray(want), atol=F32_ATOL)


def test_plain_matches_group_fallback():
    """Window counts that defeat the batched kernel's grouping."""
    arrays, mask = _inputs(Bw=6, H=2, N=64, d=32, with_mask=True, nW=3)
    want = cosine_window_attention_batched(
        *map(jnp.asarray, arrays), jnp.asarray(mask), interpret=True
    )
    np.testing.assert_allclose(_port(arrays, mask).numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize(
    "Bw,H,N,d,nW",
    [(16, 3, 256, 32, 16), (1, 24, 64, 32, None), (8, 2, 16, 16, 4), (2, 8, 4, 16, None)],
)
def test_plain_matches_xla_reference_at_swin2_shapes(Bw, H, N, d, nW):
    """Flagship stage 0 (masked) and stage 3, and the tiny config's N=16
    and N=4 with d=16."""
    arrays, mask = _inputs(Bw=Bw, H=H, N=N, d=d, with_mask=nW is not None, nW=nW or 1)
    want = xla_reference(*map(jnp.asarray, arrays), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(_port(arrays, mask).numpy(), np.asarray(want), atol=F32_ATOL)


def test_plain_bf16_io():
    arrays, _ = _inputs(Bw=4, N=64)
    q, k, v, scale, bias = arrays
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = xla_reference(jq, jk, jv, jnp.asarray(scale), jnp.asarray(bias))
    got = _port(arrays, None, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=BF16_ATOL
    )


def test_cpu_tensors_take_the_plain_version():
    arrays, mask = _inputs(with_mask=True)
    before = window_attention.launches
    got = _port(arrays, mask)
    want = window_attention_plain(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(mask))
    assert window_attention.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_shape_limits():
    for N, d in [(4, 16), (16, 16), (64, 32), (256, 32), (576, 32)]:
        check_kernel_shape(N, d)  # every Swin-V2 config's shape
    with pytest.raises(ValueError, match="head dim"):
        check_kernel_shape(64, 48)
    with pytest.raises(ValueError, match="shared memory"):
        check_kernel_shape(1024, 64)

