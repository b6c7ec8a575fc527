"""The decoder's bf16 2x upsample kernel (``kernels/upsample.py``) on the
card: against aten's ``F.interpolate(..., mode="bilinear",
align_corners=True)`` at every call shape of the two benchmark cells'
decoders (batch 6) and at edge shapes, inside a CUDA graph, and on a served
request of each benchmark configuration.

Every test here carries the ``gpu`` marker and skips without a card. This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upsample_gpu.py

Bound: one bf16 step. The kernel takes aten's f32 weights, neighbours and
blend and rounds once, as aten does; the two may contract the blend's
products into fused multiply-adds at other places, which moves the f32
value by an ulp of f32 and, rarely, its rounding to bf16 by one step.
"""
import pytest
import torch
import torch.nn.functional as F

from soccdpt_torch.kernels import ops
from soccdpt_torch.kernels import upsample as up
from soccdpt_torch.kernels.upsample import upsample2x

pytestmark = pytest.mark.gpu

# (H, W, C) of the six calls a request makes at batch 6: refinenet4, 3, 2,
# 1, the depth head after conv1, the seg head after conv2
RIG_CALLS = [(16, 16, 256), (32, 32, 256), (64, 64, 256), (128, 128, 256), (256, 256, 128),
             (256, 256, 3)]
BACKLOG_CALLS = [(8, 8, 256), (16, 16, 256), (32, 32, 256), (64, 64, 256), (128, 128, 128),
                 (128, 128, 3)]
EDGE_CALLS = [(1, 1, 8), (1, 7, 3), (5, 1, 256), (1, 1, 256), (7, 9, 3), (13, 5, 8),
              (3, 11, 256), (9, 9, 24), (2, 2, 1)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _aten(x):
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * x.shape[1], 2 * x.shape[2]),
                        mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _ordered(t):
    """bf16 bit patterns as integers in the order of their values (+0 and
    -0 both 0), so that two values' difference counts bf16 steps."""
    b = t.contiguous().view(torch.int16).int()
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _steps(got, want):
    """(largest distance in bf16 steps, share of elements bit for bit)."""
    d = (_ordered(got) - _ordered(want)).abs()
    return int(d.max()), float((d == 0).float().mean())


def _input(B, H, W, C, card, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(B, H, W, C, device=card, generator=g).mul_(3).bfloat16()


@pytest.mark.parametrize("H,W,C", RIG_CALLS + BACKLOG_CALLS + EDGE_CALLS)
def test_kernel_is_within_one_bf16_step_of_aten(card, H, W, C):
    B = 6 if (H, W, C) not in EDGE_CALLS else 2
    x = _input(B, H, W, C, card)
    before = ops.launches()["upsample2x"]
    with torch.no_grad():
        got = upsample2x(x)
    want = _aten(x)
    torch.cuda.synchronize()
    assert ops.launches()["upsample2x"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    steps, same = _steps(got, want)
    print(f"upsample {B}x{H}x{W}x{C}: bit for bit {same:.6f}, at most {steps} step(s)")
    assert steps <= 1


@pytest.mark.parametrize("C", [3, 8, 256])
def test_a_misaligned_input_takes_the_one_channel_path(card, C):
    """A view two bytes past a 16-byte boundary is read one channel a thread."""
    flat = _input(1, 1, 1, 2 * 9 * 11 * C + 1, card).reshape(-1)
    x = flat[1:1 + 2 * 9 * 11 * C].view(2, 9, 11, C)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    with torch.no_grad():
        got = upsample2x(x)
    assert _steps(got, _aten(x))[0] <= 1


@pytest.mark.parametrize("rows", [1, 2, 3, 16, 64])
def test_every_band_height_gives_the_same_bits(card, monkeypatch, rows):
    x = _input(2, 37, 21, 64, card, seed=1)
    monkeypatch.setattr(up, "plan_rows", lambda *args: 1)
    want = up.launch(x)
    monkeypatch.setattr(up, "plan_rows", lambda *args: rows)
    assert torch.equal(up.launch(x), want)


def test_the_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="contiguous 4-D bf16"):
        up.launch(_input(1, 4, 4, 8, card).float())
    with pytest.raises(ValueError, match="contiguous 4-D bf16"):
        up.launch(_input(1, 4, 4, 8, card).transpose(1, 2))


def test_one_capture_and_three_replays_in_a_cuda_graph(card):
    """The op inside a CUDA graph: each replay upsamples what the static
    input holds then, as an eager call does."""
    static = _input(6, 64, 64, 256, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        upsample2x(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = upsample2x(static)
    for seed in (1, 2, 3):
        static.copy_(_input(6, 64, 64, 256, card, seed=seed))
        graph.replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            assert torch.equal(out, upsample2x(static))


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type.name == "CUDA"]


@pytest.mark.parametrize("model_type", ["dpt_beit_large_512", "dpt_swin2_tiny_256"])
def test_a_served_request_of_each_benchmark_configuration(card, model_type):
    """SOccDPT V3 on BEiT-L/512 and on Swin-V2-T/256 at full width (features
    256, the depth head's conv1 128 wide), bf16, 1080p frames at batch 6.
    Eager: the kernel launched 6 times a request, no bilinear
    align_corners=True resize left to aten. As a CUDA graph: 6 kernel nodes
    of the upsample a request and no aten ``upsample_bilinear2d``."""
    from soccdpt_torch.core.config import ModelConfig
    from soccdpt_torch.models.soccdpt import build_model
    from soccdpt_torch.serving import make_serving_fn

    mcfg = ModelConfig(model_type=model_type, version=3, compute_dtype="bfloat16")
    model = build_model(mcfg, device=card, seed=1)
    frames = torch.randint(0, 256, (6, 1080, 1920, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    eager = make_serving_fn(mcfg, model, compute_occ=True, device=card, graph=False)
    eager(frames)
    torch.cuda.synchronize()
    launches, fallbacks = ops.launches()["upsample2x"], ops.fallbacks()["upsample2x"]
    eager(frames)
    torch.cuda.synchronize()
    assert ops.launches()["upsample2x"] - launches == 6
    assert ops.fallbacks()["upsample2x"] == fallbacks
    graphed = make_serving_fn(mcfg, model, compute_occ=True, device=card, graph=True)
    graphed(frames)
    names = _kernel_names(lambda: graphed(frames))
    assert sum("upsample2x_bf16" in n for n in names) == 6
    assert not [n for n in names if "upsample_bilinear2d" in n]
