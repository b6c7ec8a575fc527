"""Which resizes take the decoder's upsample kernel (``ops/resize.py``) and
what the ``soccdpt::upsample2x`` op is on the CPU (``kernels/upsample.py``).

The rule is checked on fake CUDA tensors (``FakeTensorMode``: shapes,
dtypes, strides and a CUDA device, no data) with both ends stubbed, the op
and the call of ``F.interpolate``, so nothing launches: a call reaches
exactly one of the two. The op's CPU implementation is ``F.interpolate``
itself, so it is held to it bit for bit.
"""
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck

from soccdpt_torch.kernels import ops, upsample as up
from soccdpt_torch.ops import resize


def _stub():
    def stub(x):
        assert x.is_contiguous()  # the kernel reads contiguous NHWC
        stub.calls += 1
        B, H, W, C = x.shape
        return x.new_empty((B, 2 * H, 2 * W, C))

    stub.calls, stub.fallbacks = 0, 0
    return stub


def _nhwc(device, dtype=torch.bfloat16, shape=(2, 8, 12, 16), requires_grad=False):
    return torch.empty(shape, device=device, dtype=dtype, requires_grad=requires_grad)


# (case, tensor maker, size, method, align_corners, grad enabled, takes the kernel,
#  counted as a fallback)
RULE = [
    ("served", lambda d: _nhwc(d), (16, 24), "bilinear", True, True, True, False),
    ("grad_off", lambda d: _nhwc(d, requires_grad=True), (16, 24), "bilinear", True, False,
     True, False),
    ("seg_logits", lambda d: _nhwc(d, shape=(2, 8, 12, 3)), (16, 24), "bilinear", True, True,
     True, False),
    ("f32", lambda d: _nhwc(d, torch.float32), (16, 24), "bilinear", True, True, False, True),
    ("recorded", lambda d: _nhwc(d, requires_grad=True), (16, 24), "bilinear", True, True,
     False, True),
    ("not_2x", lambda d: _nhwc(d), (16, 25), "bilinear", True, True, False, True),
    ("size_3x", lambda d: _nhwc(d), (24, 36), "bilinear", True, True, False, True),
    ("strided", lambda d: _nhwc(d, shape=(2, 12, 8, 16)).transpose(1, 2), (16, 24), "bilinear",
     True, True, True, False),
    ("align_false", lambda d: _nhwc(d), (16, 24), "bilinear", False, True, False, False),
    ("bicubic", lambda d: _nhwc(d), (16, 24), "bicubic", False, True, False, False),
]


@pytest.mark.parametrize("case,make,size,method,align,grad,kernel,fallback", RULE,
                         ids=[r[0] for r in RULE])
def test_the_dispatch_rule_on_the_card(monkeypatch, case, make, size, method, align, grad,
                                       kernel, fallback):
    stub, interpolated = _stub(), []

    def interpolate(x_nchw, size, method, align_corners):
        interpolated.append(method)
        return x_nchw.new_empty((*x_nchw.shape[:2], *size))

    monkeypatch.setattr(resize, "upsample2x", stub)
    monkeypatch.setattr(resize, "_interpolate", interpolate)
    with FakeTensorMode(), torch.no_grad():
        x = make("cuda")
        # the rule reads the grad mode; autograd itself stays off, since
        # recording on a fake CUDA tensor needs a CUDA build
        monkeypatch.setattr(torch, "is_grad_enabled", lambda: grad)
        assert resize.takes_kernel(x, size, method, align) == kernel
        out = resize.resize_hw(x, size, method, align)
        monkeypatch.undo()
    assert (stub.calls, len(interpolated)) == (int(kernel), int(not kernel))
    assert stub.fallbacks == int(fallback)
    assert tuple(out.shape) == (x.shape[0], *size, x.shape[3])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_cpu_goes_to_interpolate_unless_a_program_is_traced(monkeypatch, dtype):
    """Eager on the CPU: ``F.interpolate``, not counted as a fallback. While
    ``torch.export`` traces, a bf16 call becomes the op, as on the card."""
    stub = _stub()
    monkeypatch.setattr(resize, "upsample2x", stub)
    x = torch.randn(2, 8, 12, 16).to(dtype)
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(16, 24), mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)
    assert torch.equal(resize.upsample2x_hw(x), want)
    assert (stub.calls, stub.fallbacks) == (0, 0)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    resize.upsample2x_hw(x)
    assert (stub.calls, stub.fallbacks) == (int(dtype == torch.bfloat16), 0)


@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 1, 1, 8), (3, 1, 7, 3), (2, 5, 1, 256),
                                   (6, 16, 16, 256), (1, 9, 13, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_op_on_the_cpu_is_interpolate_bit_for_bit(shape, dtype):
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(0)) * 3).to(dtype)
    B, H, W, C = shape
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * H, 2 * W), mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)
    before = ops.launches()
    got = torch.ops.soccdpt.upsample2x(x)
    assert torch.equal(got, want) and got.is_contiguous()
    assert torch.equal(up.upsample2x(x), want)
    assert ops.launches() == before  # the CPU runs F.interpolate: no launch
    opcheck(torch.ops.soccdpt.upsample2x.default, (x,))
    with torch.device("meta"):
        fake = torch.ops.soccdpt.upsample2x(x.to("meta"))
    assert fake.shape == got.shape and fake.dtype == dtype


H100_SMS = 132  # streaming multiprocessors of an H100 SXM

# (B, H, W, C) of the two benchmark cells' six calls a request, batch 6
CELL_CALLS = [(6, s, s, 256) for s in (8, 16, 32, 64, 128)] + [
    (6, 256, 256, 128), (6, 128, 128, 128), (6, 256, 256, 3), (6, 128, 128, 3)]


@pytest.mark.parametrize("B,H,W,C", CELL_CALLS)
def test_the_band_plan_fills_the_card_or_walks_one_row(B, H, W, C):
    wide = C % 8 == 0
    rows = up.plan_rows(B, H, W, C, H100_SMS, wide)

    def ctas(r):
        return -(-2 * W * (C // 8 if wide else C) // up.THREADS) * -(-2 * H // r) * B

    assert rows in (up.BAND_ROWS[wide], up.BAND_ROWS[wide] // 2, up.BAND_ROWS[wide] // 4,
                    up.BAND_ROWS[wide] // 8, 1)
    assert rows == 1 or ctas(rows) >= H100_SMS
    assert rows == up.BAND_ROWS[wide] or ctas(2 * rows) < H100_SMS


def test_the_cells_calls_take_the_swept_bands():
    """Bands of 4 rows from 16x16 maps up, 16 on the seg head's one-channel
    path; the backlog's 8x8 refinenet4 (48 CTAs at 4 rows) walks one."""
    assert [up.plan_rows(6, s, s, 256, H100_SMS) for s in (8, 16, 32, 64, 128)] == [1, 4, 4, 4, 4]
    assert up.plan_rows(6, 256, 256, 128, H100_SMS) == up.plan_rows(6, 128, 128, 128, H100_SMS) == 4
    assert up.plan_rows(6, 256, 256, 3, H100_SMS, wide=False) == 16
    assert up.upsample_bytes(6, 128, 128, 256) == 50331648 * 5
