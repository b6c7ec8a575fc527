"""The launch plan and the tensor maps of global attention's bf16 route (K6
and K7 on the tensor cores: ``soccdpt_torch/kernels/global_attention.py``,
``plan_attention``, ``tma_geometry``), on the CPU: pure Python, no card and
no JAX.

The kernels (``csrc/attention_wgmma.cuh`` and the two ``.cu`` files) trust
what the wrapper passes them, so what it must hold is checked here: shared
memory within a block's 232,448 B, grids whose CTAs cover every row, the
two-image dq kernel where the batch has two images, tensor maps that
describe the caller's view element for element and give zeros past T
(never the next head's rows), the arguments each C entry receives, and the
refusals. The register fragments that carry a tile of weights from one
product to the next are restated and checked to cover each key once.
"""
import ctypes

import numpy as np
import pytest
import torch

from soccdpt_torch.kernels import _build, ops
from soccdpt_torch.kernels import global_attention as ga

# (B, H, T, D): beitl16_512 at batch 1 and 2, the 384-px models at batch 2,
# vitl16_384, the test config's ragged tiles, whole tiles, d = 128, a token
SHAPES = [(1, 16, 1025, 64), (2, 16, 1025, 64), (2, 12, 577, 64), (1, 16, 577, 64),
          (2, 2, 65, 16), (1, 2, 128, 32), (1, 3, 257, 64), (3, 2, 70, 128), (1, 1, 1, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plans_fit_a_block_and_cover_every_row(shape):
    B, H, T, D = shape
    plan = ga.plan_attention(B, H, T, D)
    assert max(plan.fwd_smem, plan.dq_smem, plan.dkv_smem) <= ga.MAX_SMEM_BYTES
    # two K6 CTAs an SM: their shared memory fits the SM's 228 KB
    assert 2 * plan.fwd_smem <= 228 * 1024
    # K6 and the dq kernel own 64 query rows of a head (K6 one image, the
    # dq kernel every image); the dk/dv kernel 128 keys of one image and head
    assert plan.fwd_grid == (B, -(-T // 64), H) and plan.dq_grid == (-(-T // 64), H)
    assert plan.dkv_grid == (B, -(-T // 128), H)
    assert plan.dq_grid[0] * 64 >= T > (plan.dq_grid[0] - 1) * 64
    assert plan.dkv_grid[1] * 128 >= T > (plan.dkv_grid[1] - 1) * 128


@pytest.mark.parametrize("shape", SHAPES)
def test_the_dq_kernel_holds_two_images_where_there_are_two(shape):
    """At batch >= 2 (the training step) each bias tile is read and each
    dbias tile written once per pair of images; D = 128 takes one image, as
    two images' dq would not fit the registers."""
    B, H, T, D = shape
    assert ga.plan_attention(B, H, T, D).img == (2 if B >= 2 and D <= 64 else 1)
    assert ga.plan_attention(B, H, T, D, img=1).img == 1


def test_the_smem_formulas_count_the_tiles_and_rings():
    # K6, D = 64: Q 64 x 128 B, three stages of K and V (64 x 128 B each),
    # 7 barriers, 1 KB of alignment slack
    assert ga.fwd_smem_bytes(64) == 1024 + 64 * 128 + 3 * 2 * 64 * 128 + 7 * 8
    # D = 16 and 32 take the tiles of D = 64 (zeros past D); D = 128 two chunks
    assert ga.fwd_smem_bytes(16) == ga.fwd_smem_bytes(64)
    assert ga.fwd_smem_bytes(128) == 1024 + 2 * (64 + 6 * 64) * 128 + 56
    # the dq kernel, two images: Q and g of each, two stages of their K and
    # V tiles of 32 keys, two dbias tiles of 64 rows of 33 floats, 6 barriers
    assert ga.DQ_KT == 32
    assert ga.dq_smem_bytes(64, 2) == (1024 + 2 * 2 * 64 * 128 + 2 * 2 * 2 * 32 * 128
                                       + 2 * 64 * 33 * 4 + 48)
    # the dk/dv kernel: its K and V (two warpgroups of 64 rows), two stages of
    # q and g tiles of 32 rows with 1 KB of statistics each, 5 barriers
    assert ga.dkv_smem_bytes(64) == 1024 + 4 * 64 * 128 + 2 * (2 * 32 * 128 + 1024) + 40


def test_the_beit_forward_fills_the_card():
    """beitl16_512 at batch 1: 17 tiles of 64 query rows a head (the 17th
    holds one live row) make 272 K6 CTAs for 132 SMs, two to an SM; the
    dk/dv kernel 9 tiles of 128 keys a head."""
    plan = ga.plan_attention(1, 16, 1025, 64)
    assert plan.fwd_grid == (1, 17, 16) and plan.dkv_grid == (1, 9, 16)
    assert np.prod(plan.fwd_grid) >= _build.SMS and np.prod(plan.dkv_grid) >= _build.SMS


def test_the_planner_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="img"):
        ga.plan_attention(2, 16, 70, 128, img=2)
    with pytest.raises(ValueError, match="img"):
        ga.plan_attention(2, 16, 70, 64, img=3)
    with pytest.raises(ValueError, match="grid"):
        ga.plan_attention(1, 70000, 65, 64)


# --- the tensor maps ------------------------------------------------------------


def _tma_box(buf: np.ndarray, geometry, coords, box):
    """A TMA load of a 4-D box as the card makes it: element (c0 + i, c1 +
    r, c2, c3) of the map at byte offset sum(coord * stride) from the base,
    zero where a coordinate lies outside the dims."""
    dims, strides = geometry[:4], [2] + geometry[4:]
    out = np.zeros((box[1], box[0]), np.float32)
    for r in range(box[1]):
        for i in range(box[0]):
            c = (coords[0] + i, coords[1] + r, coords[2], coords[3])
            if all(0 <= x < n for x, n in zip(c, dims)):
                out[r, i] = buf[sum(x * s for x, s in zip(c, strides)) // 2]
    return out


def _views(B, H, T, D, seed=0):
    """(name, view, the flat bf16 buffer under it as float32): a contiguous
    (B, H, T, D) tensor and q, k, v of one (B, T, 3, H, D) qkv tensor."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(np.float32)).bfloat16()
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, D)).astype(np.float32)).bfloat16()
    flat = qkv.reshape(-1).float().numpy()
    out = [("contiguous", x, x.reshape(-1).float().numpy())]
    for i, name in enumerate("qkv"):
        view = qkv.permute(2, 0, 3, 1, 4)[i]
        out.append((name, view, flat[(view.data_ptr() - qkv.data_ptr()) // 2:]))
    return out


@pytest.mark.parametrize("B,H,T,D", [(2, 3, 65, 16), (1, 2, 130, 64), (2, 2, 70, 128)])
def test_tensor_maps_read_the_view_and_zero_past_t(B, H, T, D):
    """Each box of 64 columns x 64 rows the kernels load holds the view's
    elements, and zeros in the rows past T and the columns past D."""
    for name, view, buf in _views(B, H, T, D):
        assert ga.tma_ready(view), name  # read in place: no copy
        geometry = ga.tma_geometry(view)
        assert geometry[:4] == [D, T, H, B]
        want_all = view.float().numpy()
        for b in range(B):
            for h in range(H):
                for row0 in range(0, T, 64):
                    for c0 in range(0, D, 64):
                        got = _tma_box(buf, geometry, (c0, row0, h, b), (64, 64))
                        want = np.zeros((64, 64), np.float32)
                        block = want_all[b, h, row0:row0 + 64, c0:c0 + 64]
                        want[:block.shape[0], :block.shape[1]] = block
                        np.testing.assert_array_equal(got, want, err_msg=f"{name} b{b} h{h} r{row0}")


def test_a_view_tma_cannot_read_is_copied_once():
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.standard_normal(2 * 3 * 65 * 16 + 1).astype(np.float32)).bfloat16()
    off = flat[1:].view(2, 3, 65, 16)  # 2 bytes into the buffer
    assert off.data_ptr() % 16 != 0 and not ga.tma_ready(off)
    sliced = torch.zeros(2, 3, 65, 20, dtype=torch.bfloat16)[..., :16]  # rows 40 bytes apart
    assert not ga.tma_ready(sliced)
    transposed = torch.zeros(2, 3, 16, 65, dtype=torch.bfloat16).transpose(2, 3)  # D strided
    assert not ga.tma_ready(transposed)
    for view in (off, sliced, transposed):
        copy = ga._as_tma(view)
        assert ga.tma_ready(copy) and copy.is_contiguous() and torch.equal(copy, view)
    ok = torch.zeros(2, 3, 65, 16, dtype=torch.bfloat16)
    assert ga._as_tma(ok) is ok


# --- the register fragments ---------------------------------------------------------


@pytest.mark.parametrize("n", [32, 64])
def test_the_weights_pass_from_sums_to_a_fragments_once(n):
    """``to_fragments``: sum 8 t + 2 r + {0, 1} of a thread becomes bf16
    pair r of the A fragment of k-step t. wgmma reads A fragment register r
    of thread (w, l) as row 16 w + l / 4 + 8 (r % 2), columns 16 t + 2 (l %
    4) + 8 (r // 2) + {0, 1}: the accumulator's own element, so each key of
    each row feeds the next product once, in its own k-step."""
    seen = np.zeros((64, n), int)
    for t_id in range(128):
        w, lane = t_id // 32, t_id % 32
        for t in range(n // 16):
            for r in range(4):
                for q in range(2):
                    i = 8 * t + 2 * r + q  # the sum packed into this half
                    # where the accumulator holds sum i ...
                    acc = (16 * w + lane // 4 + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2)
                    # ... and where wgmma reads A register r, half q, of k-step t
                    frag = (16 * w + lane // 4 + 8 * (r % 2), 16 * t + 2 * (lane % 4) + 8 * (r // 2) + q)
                    assert acc == frag
                    seen[frag] += 1
    assert (seen == 1).all()


# --- what the wrapper passes each C entry ----------------------------------------------


class _FakeLib:
    """Stands in for the kernel libraries and records each entry's call."""

    def __init__(self):
        self.calls = []
        for name in ("soccdpt_global_attention_f32", "soccdpt_global_attention_bf16",
                     "soccdpt_global_attention_bwd_f32", "soccdpt_global_attention_bwd_bf16"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        lib = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append((name, args))
                return 0
        return Entry()


def _geometry_arg(arg, n):
    assert isinstance(arg, ctypes.Array) and len(arg) == 7 * n
    return list(arg)


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


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16, None])
def test_bf16_calls_take_the_tensor_core_entries_with_their_views(fake, bias_dtype):
    B, H, T, D = 2, 3, 65, 16
    qkv = torch.zeros(B, T, 3, H, D, dtype=torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    bias = None if bias_dtype is None else torch.zeros(H, T, T, dtype=bias_dtype)
    before = ops.launches()
    out, lse = _on_the_card(torch.ops.soccdpt.global_attention_with_lse.default, q, k, v, bias,
                            0.25)
    launched = ops.launches()
    assert launched["global_attention_with_lse"] == before["global_attention_with_lse"] + 1
    (name, args), = fake.calls
    assert name == "soccdpt_global_attention_bf16"
    # q, k, v are read in place, through maps of the views' own strides
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert _geometry_arg(args[3], 3) == ga.tma_geometry(q) + ga.tma_geometry(k) + ga.tma_geometry(v)
    assert ga.tma_geometry(q)[4:] == [3 * H * D * 2, D * 2, T * 3 * H * D * 2]
    assert args[4] == (None if bias is None else bias.data_ptr())
    assert args[5] == out.data_ptr() and out.is_contiguous() and out.shape == q.shape
    assert args[6] == lse.data_ptr()
    assert args[7:12] == (B, H, T, D, {None: 0, torch.float32: 1, torch.bfloat16: 2}[bias_dtype])
    assert len(args) == 14

    g = torch.zeros(B, H, T, D, dtype=torch.bfloat16)
    dq, dk, dv, dbias = _on_the_card(torch.ops.soccdpt.global_attention_backward.default, q, k,
                                     v, bias, out, lse, g, 0.25, bias is not None)
    assert ops.launches()["global_attention_backward"] == launched["global_attention_backward"] + 1
    name, args = fake.calls[1]
    assert name == "soccdpt_global_attention_bwd_bf16"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr())
    assert _geometry_arg(args[4], 4) == sum(map(ga.tma_geometry, (q, k, v, g)), [])
    assert args[5] == out.data_ptr()
    assert args[9:12] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert (args[12] is None) == (bias is None) and (dbias.numel() == 0) == (bias is None)
    assert args[-2] == ga.plan_attention(B, H, T, D).img == 2
    assert len(fake.calls) == 2


def test_f32_calls_take_the_cuda_core_entries(fake):
    q = torch.zeros(1, 2, 65, 16)
    out, lse, (qr, kr, vr, _) = ga._launch(q, q, q, None, 0.25, want_lse=True)
    ga._launch_backward(qr, kr, vr, None, out, lse, torch.zeros_like(q), 0.25, False)
    assert [name for name, _ in fake.calls] == ["soccdpt_global_attention_f32",
                                                "soccdpt_global_attention_bwd_f32"]


BAD_BACKWARD = {
    "head dim": lambda q, b: (q[..., :12], b),
    "f32 or bf16": lambda q, b: (q.half(), b),
    "bias must be": lambda q, b: (q, b[:, :8]),
    r"\(B, H, T, d\)": lambda q, b: (q[0], b),
}


@pytest.mark.parametrize("match", list(BAD_BACKWARD))
def test_the_backward_refuses_what_the_kernels_do_not_take(match):
    """The backward checks its arguments before it looks at the device, as
    the forward does (tests/test_torch_global_attention.py)."""
    q = torch.zeros(1, 2, 16, 16)
    b = torch.zeros(2, 16, 16)
    q2, b2 = BAD_BACKWARD[match](q, b)
    with pytest.raises(ValueError, match=match):
        ga.global_attention_backward(q2, q2, q2, b2, 0.25, q2)
