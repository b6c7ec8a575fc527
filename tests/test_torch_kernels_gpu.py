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
  probabilities to bf16 before P.V and both round the output; the
  tensor-core route rounds the un-normalised weights of each 64-key tile
  instead, off by 2^-9 of each weight either way
  (kernels/window_attention.py, "Rounding");
* K6 f32: atol = rtol = 2e-5, K6 bf16: atol = rtol = 2e-2, the bounds
  tests/test_global_attention.py holds the Pallas kernel to. The kernel
  rounds the un-normalised weight of each key tile to bf16 where the plain
  version rounds the normalised one; either is off by 2^-9 of itself
  (kernels/global_attention.py, "Rounding");
* K7 f32: atol = rtol = 3e-5, the bound tests/test_global_attention.py
  holds the Pallas backward to; K7 bf16: atol = rtol = 2e-2, the forward's
  bound: dq, dk and dv are rounded to bf16 once, the tensor-core route
  rounds P and dS to bf16 as operands (2^-9 of each term), and K7 takes
  delta from the bf16 output where the plain version sums dP * P in f32.
  No atomics: two runs give the same bits, forward and backward;
* the finite-difference checks of the two ``autograd.Function``s, f32:
  a directional derivative by central differences with a step of 1e-2
  against the inner product of the gradients with the direction, to 2 %
  of its size: f32 outputs of size 1 carry 1e-7 of rounding, so a
  difference over 2e-2 is good to 1e-5 of the output and the derivative
  to a percent;
* K2: rtol/atol 1e-5, the bound of tests/test_sorted_segment_sum.py (f32
  adds in an order the atomics choose); rtol 1e-4 where every row lands
  in one cell, since thousands of adds into one accumulator drift by a
  few ulps of the total. Its backward is a gather: the same bits;
* K3, K4, K5 f32: atol 2e-4, 3e-4 and atol = rtol = 2e-5, the bounds
  tests/test_fused_{rcu,fusion,head}.py hold the Pallas kernels to, with
  TF32 off for the plain version's cuDNN convolutions; bf16: atol = rtol =
  2e-2: the kernel rounds each intermediate once where the plain version
  may round twice (a conv's output, then the residual sum), one bf16 step
  (2^-8 of the value) on values of size 1 to 10. K3 and K4 run f32 on CUDA
  cores (``tile`` 8 or 4) and bf16 on the tensor cores (planned launches,
  no ``tile``); at C = 256 the bf16 cases take atol as 2e-2 of the
  output's largest value, as chip_smoke.py does: the rounding step of the
  intermediate carries into outputs where the conv and the residual cancel;
* the ``soccdpt::`` custom ops (K1, K6 as an exported program calls them):
  ``torch.library.opcheck`` of their CUDA implementations, which runs each
  twice and asks for equal outputs; the flagship exported on the card and
  loaded: bit for bit its eager model's outputs, K1 launched 12 times a
  forward.
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.kernels import _conv
from soccdpt_torch.kernels.global_attention import (
    global_attention,
    global_attention_backward,
    global_attention_backward_plain,
    global_attention_plain,
)
from soccdpt_torch.kernels.fused_fusion import fused_rcu_tail, fused_rcu_tail_plain
from soccdpt_torch.kernels.fused_head import fused_head_tail, fused_head_tail_plain
from soccdpt_torch.kernels.fused_rcu import fused_rcu, fused_rcu_plain
from soccdpt_torch.kernels.segment_sum import (
    segment_sum,
    segment_sum_backward,
    segment_sum_backward_plain,
)
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


K1_SHAPES = [
    (16, 3, 256, 32, 16),  # flagship stage 0, shifted block
    (4, 6, 256, 32, 4),  # stage 1, shifted block
    (1, 12, 256, 32, None),  # stage 2
    (1, 24, 64, 32, None),  # stage 3
    (32, 3, 256, 32, 16),  # stage 0 at batch 2: window i takes mask[i % 16]
    (8, 2, 16, 16, 4),  # swin2test_64
    (9, 4, 576, 32, 9),  # 24-px windows of the 384-px configs
    (4, 2, 49, 32, 2),  # 7x7 windows: an odd N, scalar bias and mask loads in bf16
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bw,H,N,d,nW", K1_SHAPES)
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


def _launches(fn):
    """The CUDA launches of one call of ``fn`` (kernels, memsets, copies):
    the nodes of a CUDA graph that captures it, counted by `cuGraphGetNodes`."""
    import ctypes

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert rc == 0, rc
    return n.value


def _block_views(Bw, H, N, d, nW, dev, seed=0):
    """K1's inputs as the Swin block hands them over in bf16: q and k
    normalised, q, k, v strided views of one qkv tensor, a bf16 tau (H, 1,
    1), the f32 bias and mask on the card."""
    _, _, _, scale, bias, mask = _attn_inputs(Bw, H, N, d, nW, torch.float32, dev, seed)
    rng = np.random.default_rng(seed + 1)
    qkv = rng.standard_normal((Bw, N, 3, H, d)).astype(np.float32)
    qkv[:, :, :2] /= np.linalg.norm(qkv[:, :, :2], axis=-1, keepdims=True)
    qkv = torch.from_numpy(qkv).to(dev).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    return q, k, v, scale.bfloat16(), bias, mask


@pytest.mark.parametrize("Bw,H,N,d,nW", K1_SHAPES)
def test_window_attention_bf16_reads_strided_views_in_place(card, Bw, H, N, d, nW):
    """The tensor-core route on the block's views: within the bf16 bound,
    the same bits on a second call, and one CUDA launch a call (no copy of
    q, k, v, no cast of tau, bias or mask). Launches are counted as the
    nodes of a captured CUDA graph: no profiler."""
    q, k, v, scale, bias, mask = _block_views(Bw, H, N, d, nW, card)
    assert not q.is_contiguous()
    got = window_attention(q, k, v, scale, bias, mask)
    torch.cuda.synchronize()
    want = window_attention_plain(q, k, v, scale, bias, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=5e-2)
    assert torch.equal(got, window_attention(q, k, v, scale, bias, mask))
    assert _launches(lambda: window_attention(q, k, v, scale, bias, mask)) == 1


def _oracle(lin, vals, S):
    out = np.zeros((S, vals.shape[1]), np.float32)
    keep = (lin >= 0) & (lin < S)
    np.add.at(out, lin[keep], vals[keep])
    return out


def _segment_problem(case, card):
    """(lin, vals on the card in the case's layout, vals as numpy (B*N, C), S)."""
    rng = np.random.default_rng(11)
    B, N, S, C = {"random": (1, 200_000, 50_000, 3), "one_cell": (1, 4096, 64, 3),
                  "dropped": (1, 1000, 64, 2), "empty": (1, 0, 64, 3),
                  "channel_major": (2, 100_000, 100_000, 3), "strided": (1, 50_001, 5_000, 5),
                  "batch_folded": (2, 65_537, 2 * 4_096, 3),
                  "long_runs": (2, 100_000, 2 * 50_000, 3)}[case]
    lin = rng.integers(-100, S + 100, size=(B * N,)).astype(np.int32)
    if case == "batch_folded":  # b * cells + cell, a ragged last tile in each image
        lin = (rng.integers(0, S // B, (B, N)) + np.arange(B)[:, None] * (S // B)).reshape(-1)
        lin[::7] = S + 1
    if case == "long_runs":  # image order: runs of equal slots up to 2,000 rows
        lin = np.repeat(rng.integers(0, S, 500), rng.integers(1, 2000, 500))[:B * N]
        lin[rng.random(B * N) < 0.05] = -1
    lin = lin.astype(np.int32)
    vals = rng.uniform(size=(B * N, C)).astype(np.float32)
    if case == "one_cell":
        lin[:] = 7
    if case == "dropped":
        lin[:] = S + 3
    vals[(lin < 0) | (lin >= S)] = np.nan  # a dropped row's values are never read
    dev = torch.from_numpy(vals).to(card)
    if case in ("channel_major", "long_runs"):  # the served voxelizer's (B, N, C) view
        dev = dev.reshape(B, N, C).transpose(1, 2).contiguous().transpose(1, 2)
    if case == "strided":  # every other row of a larger tensor
        dev = torch.stack([dev, torch.zeros_like(dev)], 1).reshape(2 * N, C)[::2]
    return torch.from_numpy(lin).to(card), dev, vals, S


SEGMENT_CASES = ["random", "one_cell", "dropped", "empty", "channel_major", "strided",
                 "batch_folded", "long_runs"]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_sum_kernel_matches_oracle(card, case):
    lin, vals, host, S = _segment_problem(case, card)
    before = segment_sum.launches
    got = segment_sum(lin, vals, S)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    rtol = 1e-4 if case == "one_cell" else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), _oracle(lin.cpu().numpy(), host, S),
                               rtol=rtol, atol=1e-5)
    # CUDA launches a call: the memset and the kernel
    if case == "random":
        assert _launches(lambda: segment_sum(lin, vals, S)) == 2


def _global_inputs(B, H, T, d, bias_dtype, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    bias = None
    if bias_dtype is not None:  # randn, so a dropped bias cannot pass
        bias = torch.from_numpy(rng.standard_normal((H, T, T)).astype(np.float32))
        bias = bias.to(dev, bias_dtype)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize(
    "B,H,T,d",
    [
        (1, 16, 1025, 64),  # beitl16_512
        (2, 12, 577, 64),  # beitb16_384 / vitb16_384 at batch 2
        (2, 2, 65, 16),  # beittest_64: ragged last tiles
        (1, 2, 128, 32),  # whole tiles
        (1, 3, 257, 64),  # one live key in the last tile
        (3, 2, 70, 128),  # d = 128
        (1, 1, 1, 16),  # a single token
        (2, 16, 1025, 64),  # beitl16_512 at batch 2, the training step's
        (1, 12, 704, 64),  # 11 tiles of 64 rows x 12 heads: one wave of 132 CTAs
        (1, 12, 705, 64),  # one row more: 144 CTAs
        (1, 2, 64, 32),  # T one key tile exactly
    ],
)
def test_global_attention_kernel_matches_plain(card, dtype, bias_dtype, B, H, T, d):
    q, k, v, bias = _global_inputs(B, H, T, d, bias_dtype, dtype, card)
    scale = d**-0.5
    want = global_attention_plain(q, k, v, bias, scale).float().cpu().numpy()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    before = global_attention.launches
    got = global_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert global_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_attention_kernel_gives_the_same_bits_twice(card, dtype):
    q, k, v, bias = _global_inputs(2, 16, 1025, 64, torch.float32, dtype, card)
    first = global_attention(q, k, v, bias, 0.125)
    assert torch.equal(first, global_attention(q, k, v, bias, 0.125))


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages() if "global_attention" in ev.key]


def test_bf16_calls_run_on_the_tensor_core_kernels(card):
    """A bf16 call launches the wgmma kernels only, never the CUDA-core ones
    (the f32 route)."""
    q, k, v, bias = _global_inputs(2, 4, 130, 64, torch.float32, torch.bfloat16, card)
    g = torch.ones_like(q)
    fwd = _kernel_names(lambda: global_attention(q, k, v, bias, 0.125))
    bwd = _kernel_names(lambda: global_attention_backward(q, k, v, bias, 0.125, g))
    assert fwd and all("wgmma" in name for name in fwd), fwd
    assert any("bwd_dq_wgmma" in n for n in bwd) and any("bwd_dkv_wgmma" in n for n in bwd), bwd
    assert all("wgmma" in name for name in bwd), bwd
    f32 = _kernel_names(lambda: global_attention(q.float(), k.float(), v.float(), bias, 0.125))
    assert f32 and not any("wgmma" in name for name in f32), f32


def test_global_attention_kernel_takes_strided_views(card):
    """q, k and v as the backbone hands them over: views of one qkv tensor."""
    B, H, T, d = 2, 4, 65, 16
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, d)).astype(np.float32)).to(card)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = global_attention(q, k, v, None, 0.25)
    want = global_attention_plain(q, k, v, None, 0.25)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=2e-5)
    # contiguous, but starting 4 bytes into a buffer: the kernel's 16-byte
    # loads need the wrapper to realign it
    flat = torch.from_numpy(rng.standard_normal(3 * B * H * T * d + 1).astype(np.float32)).to(card)
    q, k, v = flat[1:].view(3, B, H, T, d)
    assert q.data_ptr() % 16 != 0
    got = global_attention(q, k, v, None, 0.25)
    want = global_attention_plain(q, k, v, None, 0.25)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,T,d", [(1, 16, 1025, 64), (2, 4, 65, 16), (2, 2, 70, 128)])
def test_global_attention_bf16_reads_strided_views_in_place(card, B, H, T, d):
    """The bf16 route reads q, k and v as the backbone hands them over (views
    of one (B, T, 3, H, d) qkv tensor) through tensor maps of their strides,
    with no copy, forward and backward."""
    from soccdpt_torch.kernels.global_attention import _launch

    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, d)).astype(np.float32)).to(
        card, torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    bias = torch.from_numpy(rng.standard_normal((H, T, T)).astype(np.float32)).to(card)
    read = _launch(q, k, v, bias, d**-0.5)[2]
    assert [t.data_ptr() for t in read[:3]] == [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    got = global_attention(q, k, v, bias, d**-0.5)
    want = global_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), bias, d**-0.5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    g = torch.from_numpy(rng.standard_normal((B, H, T, d)).astype(np.float32)).to(card, q.dtype)
    got = global_attention_backward(q, k, v, bias, d**-0.5, g)
    want = global_attention_backward_plain(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                           d**-0.5, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.float().cpu().numpy(), w.float().cpu().numpy(),
                                   atol=K7_BF16_TOL, rtol=K7_BF16_TOL, err_msg=name)


def test_global_attention_kernel_rejects_what_it_does_not_take(card):
    q, k, v, bias = _global_inputs(1, 2, 16, 48, torch.float32, torch.float32, card)
    with pytest.raises(ValueError, match="head dim"):
        global_attention(q, k, v, bias)
    q, k, v, bias = _global_inputs(1, 2, 16, 16, torch.float32, torch.float16, card)
    with pytest.raises(ValueError, match="f32 or bf16"):
        global_attention(q, k, v, bias)
    q, k, v, bias = _global_inputs(1, 2, 16, 16, torch.float32, torch.float32, card)
    with pytest.raises(ValueError, match="bias must be"):
        global_attention(q, k, v, bias[:, :8])
    with pytest.raises(ValueError, match="lies on"):
        global_attention(q, k, v, bias.cpu())


# --- K7 and the gradients ------------------------------------------------------

K7_F32_TOL, K7_BF16_TOL = 3e-5, 2e-2
FD_STEP, FD_RTOL = 1e-2, 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize(
    "B,H,T,d",
    [
        (1, 16, 1025, 64),  # beitl16_512
        (2, 16, 1025, 64),  # at batch 2: dbias sums two images
        (1, 16, 577, 64),  # vitl16_384
        (2, 2, 65, 16),  # beittest_64: ragged last tiles
        (1, 2, 128, 32),  # whole tiles
        (1, 3, 257, 64),  # one live row in the last tile
        (3, 2, 70, 128),  # d = 128, three images
        (1, 1, 1, 16),  # a single token
        (3, 2, 130, 64),  # three images: the dq kernel takes two, then one
        (1, 12, 705, 64),  # 12 x 12 CTAs: one wave and 12 more
    ],
)
def test_global_attention_backward_kernel_matches_plain(card, dtype, bias_dtype, B, H, T, d):
    q, k, v, bias = _global_inputs(B, H, T, d, bias_dtype, dtype, card)
    g = torch.from_numpy(
        np.random.default_rng(1).standard_normal((B, H, T, d)).astype(np.float32)
    ).to(card, dtype)
    scale = d**-0.5
    want = global_attention_backward_plain(q, k, v, bias, scale, g)
    tol = K7_F32_TOL if dtype == torch.float32 else K7_BF16_TOL
    before = global_attention_backward.launches
    got = global_attention_backward(q, k, v, bias, scale, g)
    torch.cuda.synchronize()
    assert global_attention_backward.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None, name
            continue
        assert a.dtype == w.dtype and a.shape == w.shape, name
        # a bf16 bias gets a bf16 dbias: two f32 sums an ulp apart can round apart
        t = K7_BF16_TOL if a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(
            a.float().cpu().numpy(), w.float().cpu().numpy(), atol=t, rtol=t, err_msg=name
        )
    again = global_attention_backward(q, k, v, bias, scale, g)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("img", [1, 2])
def test_global_attention_backward_bf16_takes_one_or_two_images_a_dq_cta(card, img):
    """The dq kernel holds one image's dq at a time or two; both are right
    and neither depends on the order CTAs run in."""
    from soccdpt_torch.kernels.global_attention import _launch, _launch_backward

    q, k, v, bias = _global_inputs(2, 16, 1025, 64, torch.float32, torch.bfloat16, card)
    g = torch.from_numpy(
        np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)).to(card, q.dtype)
    out, lse, (qr, kr, vr, br) = _launch(q, k, v, bias, 0.125, want_lse=True)
    got = _launch_backward(qr, kr, vr, br, out, lse, g, 0.125, True, img=img)
    want = global_attention_backward_plain(q, k, v, bias, 0.125, g)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.float().cpu().numpy(), w.float().cpu().numpy(),
                                   atol=K7_BF16_TOL, rtol=K7_BF16_TOL, err_msg=name)
    again = _launch_backward(qr, kr, vr, br, out, lse, g, 0.125, True, img=img)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_global_attention_backward_skips_dbias_when_the_bias_is_frozen(card):
    q, k, v, bias = _global_inputs(2, 2, 65, 16, torch.float32, torch.float32, card)
    g = torch.ones_like(q)
    dq, dk, dv, dbias = global_attention_backward(q, k, v, bias, 0.25, g, want_dbias=False)
    assert dbias is None
    want = global_attention_backward_plain(q, k, v, bias, 0.25, g)
    for a, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), atol=3e-5, rtol=3e-5)
    # through autograd: a frozen bias gets no gradient, the others do
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    before = global_attention_backward.launches
    global_attention(q, k, v, bias, 0.25).backward(g)
    assert global_attention_backward.launches == before + 1
    assert bias.grad is None
    np.testing.assert_allclose(q.grad.cpu().numpy(), want[0].cpu().numpy(), atol=3e-5, rtol=3e-5)


def _directional_check(fn, inputs, seed):
    """d/dt sum(w * fn(x + t u)) at t = 0 by central differences against
    the inner product of autograd's gradients with u."""
    rng = np.random.default_rng(seed)  # numpy: the same numbers on every device

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(tuple(shape)).astype(np.float32)).to(
            inputs[0].device)

    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    w = randn(out.shape)
    (out * w).sum().backward()
    dirs = [randn(t.shape) for t in inputs]
    analytic = sum(float((t.grad.double() * u.double()).sum()) for t, u in zip(leaves, dirs))
    with torch.no_grad():
        plus = fn(*[t + FD_STEP * u for t, u in zip(inputs, dirs)])
        minus = fn(*[t - FD_STEP * u for t, u in zip(inputs, dirs)])
        numeric = float(((plus.double() - minus.double()) * w.double()).sum()) / (2 * FD_STEP)
    assert abs(analytic) > 1e-3, "degenerate direction"
    assert abs(numeric - analytic) <= FD_RTOL * abs(analytic), (numeric, analytic)


@pytest.mark.parametrize("with_bias", [True, False])
def test_global_attention_function_passes_a_finite_difference_check(card, with_bias):
    """K6 forward and K7 backward as one ``autograd.Function``, in f32."""
    q, k, v, bias = _global_inputs(
        2, 2, 65, 16, torch.float32 if with_bias else None, torch.float32, card
    )
    inputs = (q, k, v, bias) if with_bias else (q, k, v)
    before = global_attention_backward.launches

    def fn(q_, k_, v_, b_=None):
        return global_attention(q_, k_, v_, b_, 0.25)

    _directional_check(fn, inputs, seed=2)
    assert global_attention_backward.launches == before + 1


@pytest.mark.parametrize("nW", [None, 4])
def test_window_attention_function_passes_a_finite_difference_check(card, nW):
    """K1 forward with its recompute backward: dq, dk, dv, dtau and dB."""
    q, k, v, scale, bias, mask = _attn_inputs(8, 2, 16, 16, nW, torch.float32, card)
    before = window_attention.launches

    def fn(q_, k_, v_, s_, b_):
        return window_attention(q_, k_, v_, s_, b_, mask)

    _directional_check(fn, (q, k, v, scale, bias), seed=3)
    assert window_attention.launches == before + 3  # forwards only: the backward launches none


@pytest.mark.parametrize("case", ["random", "strided", "batch_folded", "dropped"])
def test_segment_sum_backward_is_the_plain_gather(card, case):
    """K2's gradient: the gather kernel, bit for bit the plain version,
    zeros on dropped rows, shaped like the values; one launch."""
    lin, vals, _, S = _segment_problem(case, card)
    vals = vals.clone().nan_to_num_().requires_grad_()
    cot = torch.randn(S, vals.shape[-1], device=card)
    before = segment_sum_backward.launches
    segment_sum(lin, vals, S).backward(cot)
    torch.cuda.synchronize()
    assert segment_sum_backward.launches == before + 1
    want = segment_sum_backward_plain(lin, cot)
    assert vals.grad.shape == vals.shape
    assert torch.equal(vals.grad.reshape(-1, vals.shape[-1]), want)
    dropped = (lin < 0) | (lin >= S)
    assert not vals.grad.reshape(-1, vals.shape[-1])[dropped].any()
    assert _launches(lambda: segment_sum_backward(lin, cot)) == 1


def test_segment_sum_on_the_card_never_reaches_the_plain_versions(card, monkeypatch):
    from soccdpt_torch.kernels import segment_sum as ss

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached a plain version")

    for name in ("segment_sum_plain", "segment_sum_backward_plain"):
        monkeypatch.setattr(ss, name, refuse)
    for name in ("index_add_", "index_select"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    lin, vals, host, S = _segment_problem("channel_major", card)
    vals = vals.clone().nan_to_num_().requires_grad_()
    for _ in range(2):
        out = ss.segment_sum(lin, vals, S)
        out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    keep = (lin >= 0) & (lin < S)
    assert torch.equal(vals.grad.reshape(-1, 3), 2.0 * keep[:, None].float().expand(-1, 3))


# --- K3, K4, K5: the decoder convolutions ------------------------------------------

DECODER_F32_TOL = {"rcu": 2e-4, "tail": 3e-4, "head": 2e-5}
DECODER_BF16_TOL = 2e-2


@pytest.fixture
def no_tf32(card):
    """f32 plain versions in full f32: cuDNN takes TF32 by default."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield card
    torch.backends.cudnn.allow_tf32 = before


def _decoder_inputs(B, H, W, C, dev, seed=0, scale=0.05):
    """The inputs of tests/test_fused_rcu.py and tests/test_fused_fusion.py:
    s, w1, b1, w2, b2, out_w, out_b (HWIO weights)."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal((B, H, W, C)),
        rng.standard_normal((3, 3, C, C)) * scale, rng.standard_normal(C) * 0.1,
        rng.standard_normal((3, 3, C, C)) * scale, rng.standard_normal(C) * 0.1,
        rng.standard_normal((C, C)) * scale, rng.standard_normal(C) * 0.1,
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def _head_inputs(B, H, W, Ci, Cm, dev, seed=0):
    """The inputs of tests/test_fused_head.py: x, w2, b2, w3, b3."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, H, W, Ci)), rng.standard_normal((3, 3, Ci, Cm)) * 0.1,
              rng.standard_normal((Cm,)) * 0.1, rng.standard_normal((Cm,)) * 0.1,
              rng.standard_normal(())]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]


def _close(got, want, f32_tol, rtol=0.0):
    if got.dtype == torch.bfloat16:
        f32_tol = rtol = DECODER_BF16_TOL
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=f32_tol, rtol=rtol)


DECODER_CASES = [
    (1, 16, 16, 32, 0.05),  # the mirrored JAX cases
    (2, 24, 16, 16, 0.05),
    (1, 7, 9, 16, 0.05),  # ragged tiles
    (2, 5, 13, 64, 0.05),
    (1, 64, 64, 256, 0.02),  # the flagship's refinenet1 width
]


# (dtype, tile): the f32 route with its planned and both fixed tiles, the
# bf16 route, which plans its own launch
ROUTES = [(torch.float32, None), (torch.float32, 8), (torch.float32, 4), (torch.bfloat16, None)]


@pytest.mark.parametrize("dtype,tile", ROUTES)
@pytest.mark.parametrize("B,H,W,C,scale", DECODER_CASES)
def test_fused_rcu_kernel_matches_plain(no_tf32, dtype, B, H, W, C, scale, tile):
    x, w1, b1, w2, b2, _, _ = _decoder_inputs(B, H, W, C, no_tf32, scale=scale)
    x = x.to(dtype)
    before = fused_rcu.launches
    got = fused_rcu(x, w1, b1, w2, b2, tile=tile)
    torch.cuda.synchronize()
    assert fused_rcu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, fused_rcu_plain(x, w1, b1, w2, b2), DECODER_F32_TOL["rcu"])


@pytest.mark.parametrize("dtype,tile", ROUTES)
@pytest.mark.parametrize("B,H,W,C,scale", DECODER_CASES)
def test_fused_rcu_tail_kernel_matches_plain(no_tf32, dtype, B, H, W, C, scale, tile):
    s, w1, b1, w2, b2, wo, bo = _decoder_inputs(B, H, W, C, no_tf32, seed=1, scale=scale)
    s = s.to(dtype)
    if dtype == torch.float32 and C == 256 and tile == 8:
        # tile 8 needs more than a block's shared memory at C = 256 in f32
        with pytest.raises(ValueError, match="shared memory"):
            fused_rcu_tail(s, w1, b1, w2, b2, wo, bo, tile=tile)
        return
    before = fused_rcu_tail.launches
    got = fused_rcu_tail(s, w1, b1, w2, b2, wo.reshape(1, 1, C, C), bo, tile=tile)
    torch.cuda.synchronize()
    assert fused_rcu_tail.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, 2 * H, 2 * W, C)
    _close(got, fused_rcu_tail_plain(s, w1, b1, w2, b2, wo, bo), DECODER_F32_TOL["tail"])


def _close_bf16(got, want):
    """chip_smoke.py's bf16 bound: 2e-2 of the largest |value| plus 2e-2
    relative."""
    want = want.float()
    atol = DECODER_BF16_TOL * float(want.abs().max())
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(), atol=atol,
                               rtol=DECODER_BF16_TOL)


# (B, H, W, C): the flagship's (8..64) and BEiT-large's (16..128) decoder
# maps at batch 1 and 2, ragged maps (9x11 split over K), and C of 8, 16
# and 64, below one K-step of 64 channels
BF16_SHAPES = ([(B, s, s, 256) for B in (1, 2) for s in (8, 16, 32, 64, 128)]
               + [(1, 7, 9, 16), (2, 5, 13, 64), (1, 9, 11, 256), (1, 8, 8, 8), (2, 16, 16, 16),
                  (1, 32, 32, 64)])


@pytest.mark.parametrize("op", ["rcu", "tail"])
@pytest.mark.parametrize("B,H,W,C", BF16_SHAPES)
def test_tensor_core_route_matches_plain(no_tf32, op, B, H, W, C):
    """The bf16 route at every decoder shape, against the plain version in
    bf16; the flagship's 8x8 and 16x16 maps are split over K by the planner."""
    s, w1, b1, w2, b2, wo, bo = _decoder_inputs(B, H, W, C, no_tf32, seed=2,
                                                scale=0.05 if C <= 64 else 0.02)
    s = s.bfloat16()
    with torch.no_grad():
        if op == "rcu":
            got, want = fused_rcu(s, w1, b1, w2, b2), fused_rcu_plain(s, w1, b1, w2, b2)
        else:
            got = fused_rcu_tail(s, w1, b1, w2, b2, wo, bo)
            want = fused_rcu_tail_plain(s, w1, b1, w2, b2, wo, bo)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close_bf16(got, want)


@pytest.mark.parametrize("C", [8, 48, 256])
@pytest.mark.parametrize("lib_name", ["fused_rcu", "fused_fusion"])
def test_prepare_converts_any_weight_layout_and_zeroes_the_counters(card, lib_name, C):
    """The bf16 route's one preparation launch against PyTorch's own cast:
    a module's OIHW weight seen as HWIO, a contiguous HWIO f32 weight, a
    bf16 one, and a transposed (C, C) 1x1 weight; the counters end at 0."""
    from soccdpt_torch.kernels import _build

    g = torch.Generator(device=card).manual_seed(C)
    oihw = torch.randn(C, C, 3, 3, device=card, generator=g)
    weights = [oihw.permute(2, 3, 1, 0), torch.randn(3, 3, C, C, device=card, generator=g),
               torch.randn(C, C, device=card, generator=g).t().reshape(1, 1, C, C)]
    if lib_name == "fused_rcu":
        weights = [weights[0], weights[1].bfloat16()]
    scratch = _conv.Scratch([_conv.plan_conv(1, 8, 8, 256, 9)], card)
    scratch.counters.fill_(5)
    like = torch.zeros(1, 1, 1, C, device=card, dtype=torch.bfloat16)
    outs = _conv.prepare_bf16(_build.load(lib_name), like, weights, scratch)
    torch.cuda.synchronize()
    for w, got in zip(weights, outs):
        want = w.to(torch.bfloat16).reshape(-1, C, C)
        assert torch.equal(got, want)
    assert int(scratch.counters.abs().sum()) == 0


def test_split_k_sums_are_the_same_every_run(card):
    """A shape the planner splits over K: the partials are added in split
    order by the last CTA of each tile, so two runs agree to the bit."""
    B, H, W, C = 1, 8, 8, 256
    assert _conv.plan_conv(B, H, W, C, 9).splits > 1
    x, w1, b1, w2, b2, _, _ = _decoder_inputs(B, H, W, C, card, seed=3, scale=0.02)
    x = x.bfloat16()
    with torch.no_grad():
        runs = [fused_rcu(x, w1, b1, w2, b2) for _ in range(3)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    _close_bf16(runs[0], fused_rcu_plain(x, w1, b1, w2, b2))


@pytest.mark.parametrize("op", ["rcu", "tail"])
def test_a_bf16_call_with_a_tile_raises_on_the_card(card, op):
    s, w1, b1, w2, b2, wo, bo = _decoder_inputs(1, 8, 8, 16, card)
    with torch.no_grad(), pytest.raises(ValueError, match="f32 route only"):
        if op == "rcu":
            fused_rcu(s.bfloat16(), w1, b1, w2, b2, tile=8)
        else:
            fused_rcu_tail(s.bfloat16(), w1, b1, w2, b2, wo, bo, tile=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["rcu", "tail"])
def test_decoder_kernels_keep_the_border_at_zero_padding(no_tf32, kernel, dtype):
    """The all-ones case of tests/test_fused_rcu.py: the intermediate's
    halo outside the image must be zero, not relu(b1 + conv of padding). f32
    at both tiles to rtol 1e-5; bf16 (one planned launch) to the bf16 bound."""
    C = 8
    x = torch.ones(1, 8, 8, C, device=no_tf32, dtype=dtype)
    w = torch.full((3, 3, C, C), 0.01, device=no_tf32)
    b = torch.zeros(C, device=no_tf32)
    for tile in ((8, 4) if dtype == torch.float32 else (None,)):
        if kernel == "rcu":
            got, want = fused_rcu(x, w, b, w, b, tile=tile), fused_rcu_plain(x, w, b, w, b)
        else:
            wo = 0.5 * torch.eye(C, device=no_tf32)
            got = fused_rcu_tail(x, w, b, w, b, wo, b, tile=tile)
            want = fused_rcu_tail_plain(x, w, b, w, b, wo, b)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)
        else:
            _close_bf16(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,W,Ci,Cm",
    [
        (1, 16, 16, 8, 8),  # the mirrored JAX cases
        (2, 16, 32, 16, 8),
        (1, 8, 8, 8, 16),
        (1, 7, 9, 16, 8),  # ragged tiles
        (2, 5, 13, 64, 36),  # two chunks of output channels
        (1, 1, 3, 8, 4),  # one row
        (1, 128, 128, 128, 32),  # the flagship's head
        (1, 16, 16, 16, 200),  # Cm > 128: the bf16 route's CTA walks two N tiles
    ],
)
def test_fused_head_tail_kernel_matches_plain(no_tf32, dtype, B, H, W, Ci, Cm):
    x, w2, b2, w3, b3 = _head_inputs(B, H, W, Ci, Cm, no_tf32)
    x = x.to(dtype)
    before = fused_head_tail.launches
    got = fused_head_tail(x, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert fused_head_tail.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, 2 * H, 2 * W)
    _close(got, fused_head_tail_plain(x, w2, b2, w3, b3), DECODER_F32_TOL["head"],
           rtol=DECODER_F32_TOL["head"])


@pytest.mark.parametrize("B,H,W,Ci,Cm", [(1, 128, 128, 128, 32), (2, 5, 13, 64, 36)])
def test_fused_head_tail_bf16_is_three_launches_on_the_tensor_cores(no_tf32, B, H, W, Ci, Cm):
    """A bf16 call on the weights as a port module holds them (OIHW seen as
    HWIO, w3 (1, 1, Cm, 1)): three launches (the preparation, the upsample
    and the head conv; chip_smoke.py finds wgmma in the library's SASS);
    the same bits on a second call."""
    x, w2, b2, w3, b3 = _head_inputs(B, H, W, Ci, Cm, no_tf32)
    x = x.bfloat16()
    w2 = w2.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    w3 = w3.reshape(1, 1, Cm, 1)
    with torch.no_grad():
        got = fused_head_tail(x, w2, b2, w3, b3)
        assert torch.equal(got, fused_head_tail(x, w2, b2, w3, b3))
        assert _launches(lambda: fused_head_tail(x, w2, b2, w3, b3)) == 3
    _close(got, fused_head_tail_plain(x, w2, b2, w3, b3), DECODER_BF16_TOL, DECODER_BF16_TOL)


def test_fused_head_tail_gradient_is_the_plain_versions(no_tf32):
    """The kernel forward, the recompute backward: every input's gradient
    as autograd through the plain version gives it."""
    inputs = _head_inputs(2, 8, 12, 16, 8, no_tf32, seed=4)
    inputs[3] = inputs[3].reshape(1, 1, 8, 1)  # the (1, 1, Cm, 1) form of w3
    g = torch.randn(2, 16, 24, device=no_tf32, generator=torch.Generator(no_tf32).manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = fused_head_tail.launches
    fused_head_tail(*leaves).backward(g)
    assert fused_head_tail.launches == before + 1
    plain = [t.clone().requires_grad_() for t in inputs]
    fused_head_tail_plain(*plain).backward(g)
    for name, a, b in zip(("x", "w2", "b2", "w3", "b3"), leaves, plain):
        assert a.grad.shape == a.shape, name
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.cpu().numpy(), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


def test_forward_only_decoder_kernels_refuse_a_gradient(card):
    s, w1, b1, w2, b2, wo, bo = _decoder_inputs(1, 8, 8, 16, card)
    w1.requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        fused_rcu(s, w1, b1, w2, b2)
    with pytest.raises(NotImplementedError, match="forward only"):
        fused_rcu_tail(s, w1, b1, w2, b2, wo, bo)
    with torch.no_grad():
        assert fused_rcu(s, w1, b1, w2, b2).shape == s.shape


# --- K1 and K6 as custom ops, and an exported program on the card --------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nW", [None, 4])
def test_window_attention_op_passes_opcheck_on_the_card(card, dtype, nW):
    from torch.library import opcheck

    args = _attn_inputs(8, 2, 16, 16, nW, dtype, card)
    opcheck(torch.ops.soccdpt.window_attention.default, args)
    before = window_attention.launches
    out = torch.ops.soccdpt.window_attention(*args)
    assert window_attention.launches == before + 1
    torch.testing.assert_close(out.float(), window_attention_plain(*args).float(),
                               atol=2e-5 if dtype == torch.float32 else 5e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("biased", [False, True])
def test_global_attention_ops_pass_opcheck_on_the_card(card, dtype, biased):
    from torch.library import opcheck

    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 200, 64, device=card, generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(4, 200, 200, device=card, generator=g) if biased else None
    args = (q, k, v, bias, 0.125)
    opcheck(torch.ops.soccdpt.global_attention.default, args)
    opcheck(torch.ops.soccdpt.global_attention_with_lse.default, args)
    before = global_attention.launches
    out, lse = torch.ops.soccdpt.global_attention_with_lse(*args)
    assert global_attention.launches == before + 1 and lse.shape == (2, 4, 200)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), global_attention_plain(*args).float(),
                               atol=tol, rtol=tol)


def test_exported_flagship_launches_k1_and_equals_eager(card, tmp_path):
    from soccdpt_torch.cli.export import export_model
    from soccdpt_torch.cli.run_exported import load_program
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.bias_cache import build_inference_cache
    from soccdpt_torch.models.soccdpt import build_model

    path = export_model("dpt_swin2_tiny_256", 3, str(tmp_path / "flagship.pt2"))
    program = load_program(path, card)
    model = build_inference_cache(build_model(
        ModelConfig(model_type="dpt_swin2_tiny_256", compute_dtype="bfloat16")).eval())
    for batch in (1, 2):
        g = torch.Generator(device=card).manual_seed(batch)
        x = torch.randn(batch, 3, 256, 256, device=card, generator=g)
        with torch.no_grad():
            before = window_attention.launches
            got = program(x)
            launched = window_attention.launches - before
            want = model(x, return_raw=True)
        assert launched == 12
        assert all(torch.equal(a, b) for a, b in zip(got, want))
