"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a card: the
kernels have no CPU mode. This file imports no JAX, so it runs on a
machine that has only PyTorch (``--noconftest`` skips tests/conftest.py,
which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances, with their reasons:
* K1 f32: atol 2e-5, the bound tests/test_window_attention.py holds the
  Pallas kernels to (same math, f32 sums in another order);
* K1 bf16: atol 5e-2, that file's bf16 bound: the plain version rounds the
  probabilities to bf16 before P.V and both round the output;
* K2: rtol/atol 1e-5, the bound of tests/test_sorted_segment_sum.py (f32
  adds in an order the atomics choose); rtol 1e-4 where every row lands
  in one cell, since thousands of adds into one accumulator drift by a
  few ulps of the total.
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.kernels.segment_sum import segment_sum
from soccdpt_torch.kernels.window_attention import window_attention, window_attention_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(Bw, H, N, d, nW, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((Bw, H, N, d)).astype(np.float32) for _ in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    scale = np.exp(rng.standard_normal((H, 1, 1))).astype(np.float32)
    bias = (16 / (1 + np.exp(-rng.standard_normal((H, N, N))))).astype(np.float32)
    out = [torch.from_numpy(a).to(dev) for a in (q, k, v, scale, bias)]
    out[:3] = [t.to(dtype) for t in out[:3]]
    mask = None
    if nW is not None:
        mask = np.where(rng.random((nW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
        mask = torch.from_numpy(mask).to(dev)
    return (*out, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "Bw,H,N,d,nW",
    [
        (16, 3, 256, 32, 16),  # flagship stage 0, shifted block
        (4, 6, 256, 32, 4),  # stage 1, shifted block
        (1, 12, 256, 32, None),  # stage 2
        (1, 24, 64, 32, None),  # stage 3
        (32, 3, 256, 32, 16),  # stage 0 at batch 2: window i takes mask[i % 16]
        (8, 2, 16, 16, 4),  # swin2test_64
        (9, 4, 576, 32, 9),  # 24-px windows of the 384-px configs
    ],
)
def test_window_attention_kernel_matches_plain(card, dtype, Bw, H, N, d, nW):
    q, k, v, scale, bias, mask = _attn_inputs(Bw, H, N, d, nW, dtype, card)
    before = window_attention.launches
    got = window_attention(q, k, v, scale, bias, mask)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = window_attention_plain(q, k, v, scale, bias, mask)
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)


def test_window_attention_kernel_rejects_what_it_does_not_take(card):
    q, k, v, scale, bias, _ = _attn_inputs(2, 2, 16, 48, None, torch.float32, card)
    with pytest.raises(ValueError, match="head dim"):
        window_attention(q, k, v, scale, bias)
    q, k, v, scale, bias, _ = _attn_inputs(2, 2, 16, 16, None, torch.float16, card)
    with pytest.raises(ValueError, match="f32 or bf16"):
        window_attention(q, k, v, scale, bias)


def _oracle(lin, vals, S):
    out = np.zeros((S, vals.shape[1]), np.float32)
    keep = (lin >= 0) & (lin < S)
    np.add.at(out, lin[keep], vals[keep])
    return out


@pytest.mark.parametrize("case", ["random", "one_cell", "dropped", "empty"])
def test_segment_sum_kernel_matches_oracle(card, case):
    rng = np.random.default_rng(11)
    N, S, C = {"random": (200_000, 50_000, 3), "one_cell": (4096, 64, 3),
               "dropped": (1000, 64, 2), "empty": (0, 64, 3)}[case]
    lin = rng.integers(-100, S + 100, size=(N,)).astype(np.int32)
    vals = rng.uniform(size=(N, C)).astype(np.float32)
    if case == "one_cell":
        lin[:] = 7
    if case == "dropped":
        lin[:] = S + 3
        vals[::2] = np.nan  # a dropped row's values are never read
    before = segment_sum.launches
    got = segment_sum(torch.from_numpy(lin).to(card), torch.from_numpy(vals).to(card), S)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    rtol = 1e-4 if case == "one_cell" else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), _oracle(lin, vals, S), rtol=rtol, atol=1e-5)
