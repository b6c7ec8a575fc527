"""The launch plan of window attention's bf16 route (K1 on the tensor cores:
``soccdpt_torch/kernels/window_attention.py``, ``plan_window_attention``)
and what its wrapper passes the C entries, on the CPU: pure Python, no card
and no JAX.

The kernel (``csrc/window_attention.cu``, namespace ``wgattn``) trusts the
wrapper, so what it must hold is checked here: shared memory within a
block's 232,448 B and two CTAs an SM, a grid whose CTAs cover every query
row of every window-head, a ring that holds the whole window where it has
four key tiles or fewer, the refusals, and, through a fake library, the
arguments of each entry: a bf16 call reaches the tensor-core entry with the
views' own geometry and no copy of q, k, v, tau, bias or mask; an f32 call
reaches the CUDA-core entry.
"""
import ctypes

import numpy as np
import pytest
import torch

from soccdpt_torch.kernels import _build, ops
from soccdpt_torch.kernels import global_attention as ga
from soccdpt_torch.kernels import window_attention as wa

# (Bw, H, N, d): the flagship's four stages at batch 1 (stage 0 and 1 also
# shifted), stage 0 at batch 2, swin2test_64, the 384-px configs' 24-px
# windows, and d = 64
SHAPES = [(16, 3, 256, 32), (4, 6, 256, 32), (1, 12, 256, 32), (1, 24, 64, 32),
          (32, 3, 256, 32), (8, 2, 16, 16), (9, 4, 576, 32), (2, 2, 100, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plans_fit_a_block_and_cover_every_row(shape):
    Bw, H, N, d = shape
    plan = wa.plan_window_attention(Bw, H, N, d)
    assert plan.smem <= wa.MAX_SMEM_BYTES
    # two CTAs an SM (the kernel's launch bounds): their shared memory fits
    # the SM; one with a shift mask, whose loads take the registers of two
    assert plan.ctas_per_sm == 2 and 2 * plan.smem <= wa.SM_SMEM_BYTES
    masked = wa.plan_window_attention(Bw, H, N, d, masked=True)
    assert masked.ctas_per_sm == 1
    assert (masked.grid, masked.stages, masked.smem) == (plan.grid, plan.stages, plan.smem)
    # one CTA per (window, tile of 64 query rows, head); the tiles cover N
    assert plan.grid[0] == Bw and plan.grid[2] == H
    assert plan.grid[1] * wa.WIN_BM >= N > (plan.grid[1] - 1) * wa.WIN_BM
    covered = np.zeros(N, bool)
    for tile in range(plan.grid[1]):
        covered[tile * wa.WIN_BM:(tile + 1) * wa.WIN_BM] = True
    assert covered.all()


@pytest.mark.parametrize("shape", SHAPES)
def test_the_ring_holds_the_whole_window_up_to_four_tiles(shape):
    """At N <= 256 every K and V tile of the window-head has a stage of its
    own, so the producer issues every load at once; N = 576 (nine tiles)
    cycles a ring of four."""
    Bw, H, N, d = shape
    plan = wa.plan_window_attention(Bw, H, N, d)
    tiles = -(-N // wa.WIN_KT)
    assert plan.stages == min(tiles, wa.WIN_MAX_STAGES)
    if N <= 256:
        assert plan.stages * wa.WIN_KT >= N
    else:
        assert plan.stages == wa.WIN_MAX_STAGES


def test_the_smem_formula_counts_the_tiles_and_the_ring():
    # Q 64 x 128 B, four stages of K and V (64 x 128 B each), 9 barriers,
    # 1 KB of alignment slack; d = 16 and 32 take the tiles of d = 64
    assert wa.win_smem_bytes(32, 4) == 1024 + 64 * 128 + 4 * 2 * 64 * 128 + 9 * 8
    assert wa.win_smem_bytes(16, 1) == wa.win_smem_bytes(64, 1) == 1024 + 3 * 64 * 128 + 24
    assert wa.plan_window_attention(1, 1, 16, 16).stages == 1


@pytest.mark.parametrize("args,match", [
    ((2, 2, 16, 48), "head dim"),
    ((2, 2, 16, 128), "head dim"),
    ((0, 2, 16, 16), "Bw, H, N"),
    ((2, 2, 0, 16), "Bw, H, N"),
    ((2, 70000, 16, 16), "grid"),
])
def test_the_planner_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        wa.plan_window_attention(*args)


# --- what the wrapper passes each C entry ----------------------------------------------


class _FakeLib:
    """Stands in for the kernel library and records each entry's call."""

    def __init__(self):
        self.calls = []
        for name in ("soccdpt_window_attention_f32", "soccdpt_window_attention_bf16"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        lib = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append((name, args))
                return 0
        return Entry()


def _on_the_card(op, *args):
    """``op``'s CUDA implementation on CPU tensors, counted as a call on the
    card is: the launcher reaches the fake library."""
    return op.redispatch(torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), *args)


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    return lib


def _block_inputs(Bw, H, N, d, nW, tau_dtype):
    """q, k, v as the Swin block hands them over: strided views of one qkv
    tensor (q and k normalised in place of the block's division, so that
    they stay views), tau (H, 1, 1), bias (H, N, N), mask (nW, N, N)."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((Bw, N, 3, H, d)).astype(np.float32)).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    tau = torch.ones(H, 1, 1, dtype=tau_dtype)
    bias = torch.zeros(H, N, N, dtype=tau_dtype)
    mask = None if nW is None else torch.zeros(nW, N, N)
    return q, k, v, tau, bias, mask


@pytest.mark.parametrize("nW,tau_dtype", [(None, torch.float32), (4, torch.float32),
                                          (4, torch.bfloat16)])
def test_a_bf16_call_takes_the_tensor_core_entry_with_its_views(fake, nW, tau_dtype):
    Bw, H, N, d = 8, 3, 64, 16
    q, k, v, tau, bias, mask = _block_inputs(Bw, H, N, d, nW, tau_dtype)
    before = ops.launches()["window_attention"]
    out = _on_the_card(torch.ops.soccdpt.window_attention.default, q, k, v, tau, bias, mask)
    assert ops.launches()["window_attention"] == before + 1
    (name, args), = fake.calls
    assert name == "soccdpt_window_attention_bf16"
    # q, k, v are read in place, through maps of the views' own strides
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    geometry = list(args[3])
    assert isinstance(args[3], ctypes.Array)
    assert geometry == ga.tma_geometry(q) + ga.tma_geometry(k) + ga.tma_geometry(v)
    assert ga.tma_geometry(v)[4:] == [3 * H * d * 2, d * 2, N * 3 * H * d * 2]
    # tau, bias and mask as they lie, in their own dtype: no cast, no copy
    kind = {torch.float32: 1, torch.bfloat16: 2}[tau_dtype]
    assert args[4:8] == (tau.data_ptr(), kind, bias.data_ptr(), kind)
    assert args[8:10] == ((None, 0) if mask is None else (mask.data_ptr(), 1))
    assert args[10] == out.data_ptr() and out.is_contiguous() and out.shape == q.shape
    plan = wa.plan_window_attention(Bw, H, N, d, masked=nW is not None)
    assert args[11:17] == (Bw, H, N, d, 1 if nW is None else nW, plan.stages)
    assert len(args) == 18 and out.dtype == torch.bfloat16


def test_a_view_tma_cannot_read_is_copied_once(fake):
    """q strided along d (a transposed view) cannot go through TMA: the
    wrapper hands the kernel one aligned contiguous copy of it."""
    Bw, H, N, d = 2, 2, 16, 16
    q = torch.zeros(Bw, H, d, N, dtype=torch.bfloat16).transpose(2, 3)
    k = v = torch.zeros(Bw, H, N, d, dtype=torch.bfloat16)
    wa._launch(q, k, v, torch.ones(H), torch.zeros(H, N, N), None)
    (_, args), = fake.calls
    assert args[0] != q.data_ptr() and args[1:3] == (k.data_ptr(), v.data_ptr())
    assert list(args[3])[4:7] == [d * 2, N * d * 2, H * N * d * 2]


def test_a_bias_in_another_dtype_goes_to_f32(fake):
    Bw, H, N, d = 2, 2, 16, 16
    q = torch.zeros(Bw, H, N, d, dtype=torch.bfloat16)
    bias = torch.zeros(H, N, N, dtype=torch.float16)
    wa._launch(q, q, q, torch.ones(H, dtype=torch.float64), bias, None)
    (_, args), = fake.calls
    assert args[5] == 1 and args[7] == 1  # tau and bias as f32 copies
    assert args[6] != bias.data_ptr()


def test_an_f32_call_takes_the_cuda_core_entry(fake):
    q, k, v, tau, bias, mask = _block_inputs(8, 3, 64, 16, 4, torch.float32)
    q, k, v = q.float(), k.float(), v.float()
    wa._launch(q, k, v, tau, bias, mask)
    (name, args), = fake.calls
    assert name == "soccdpt_window_attention_f32"
    assert args[7:12] == (8, 3, 64, 16, 4)
    assert args[12] == wa.pick_q_tile(8, 3, 64)
