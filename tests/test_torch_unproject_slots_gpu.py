"""The geometry kernel (``kernels/unproject_slots.py``) on the card: the
1080p tail of each benchmark configuration against the plain path on the
same card, ragged and misaligned images, a served grid request as a CUDA
graph, the exported flagship with points, and the calls that keep the
plain path.

Every test here carries the ``gpu`` marker and skips without a card. This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_unproject_slots_gpu.py

Bounds: the points equal the plain path's bit for bit (the kernel repeats
aten's operations and roundings). A slot may differ where the rotation
lands a point on a cell's face, if cuBLAS's GEMM sums a row in another
order than the kernel's FMA chain: at most 1e-5 of the pixels. The grids
K2 sums from the two sets of slots differ by its atomics' order too: at
most 1e-6 of the grid's mass on top of what the slots move.
"""
import json
from pathlib import Path

import pytest
import torch

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels import ops
from soccdpt_torch.kernels import unproject_slots as us
from soccdpt_torch.kernels.segment_sum import segment_sum
from soccdpt_torch.ops import geometry

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
CELLS = ["beitl512", "swin2t256", "hybrid384"]
B, H, W, C = 6, 1080, 1920, 3
SLOT_MISMATCH_SHARE = 1e-5
GRID_MASS_SHARE = 1e-6
GRID_TOL = 1e-5  # K2 against itself: tests/test_torch_serving_gpu.py
EXPORT_LADDER = (1e-4, 1e-4, 5e-3)  # inverse depth, segmentation, points (m)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _configs(name):
    cfg = json.loads((CONFIGS / f"soccdpt-v3-{name}.json").read_text())
    cam = CameraConfig(**cfg["camera"])
    o = cfg["occupancy"]
    occ = OccupancyConfig(grid_size=tuple(o["grid_size"]), scale=tuple(o["scale"]),
                          shift=tuple(o["shift"]), pc_scale=tuple(o["pc_scale"]),
                          pc_shift=tuple(o["pc_shift"]),
                          correction_angle=tuple(o["correction_angle"]))
    return cam, occ


def _inverse_depth(card, shape, seed=0):
    """Inverse depths over depths of 1.4-10 m, and 0, inf, NaN and negative
    ones scattered among them."""
    g = torch.Generator(device=card).manual_seed(seed)
    inv = torch.rand(shape, device=card, generator=g) * 0.6 + 0.1
    flat = inv.view(-1)
    for i, special in enumerate((0.0, float("inf"), float("nan"), -0.25, -float("inf"), 1e-12)):
        flat[i * 7919 % flat.numel()::104729] = special
    return inv


def _plain(inv, cam, occ, slots=True):
    points = geometry.camera_frame_points(inv, cam)
    if not slots:
        return points, None
    frame = geometry.occupancy_frame(points.reshape(inv.shape[0], -1, 3), occ)
    return points, geometry.slot_keys(frame, occ)


def _bits(t):
    return t.contiguous().view(torch.int32)



def _counts():
    """(the geometry op's launches, the geometry tail's fallbacks) so far."""
    return ops.launches()["unproject_slots"], ops.fallbacks()["unproject_slots"]


@pytest.mark.parametrize("name", CELLS)
def test_the_1080p_tail_of_each_configuration_matches_the_plain_path(card, name):
    cam, occ = _configs(name)
    inv = _inverse_depth(card, (B, H, W))
    before = ops.launches()["unproject_slots"]
    with torch.no_grad():
        points, slot = us.unproject_slots(inv, cam, occ, True)
        want_points, want_slot = _plain(inv, cam, occ)
    torch.cuda.synchronize()
    assert ops.launches()["unproject_slots"] == before + 1
    assert points.shape == (B, H, W, 3) and slot.shape == (B * H * W,)
    assert slot.dtype == torch.int32 and points.is_contiguous()
    assert torch.equal(_bits(points), _bits(want_points))
    mismatched = float((slot != want_slot).float().mean())
    kept = float((want_slot >= 0).float().mean())
    print(f"{name}: slots mismatched {mismatched:.3g}, kept {kept:.4f}")
    assert mismatched <= SLOT_MISMATCH_SHARE and kept > 0.5
    g = torch.Generator(device=card).manual_seed(1)
    # the served layout: a channel-major (B, C, H W) map seen as (B, H W, C)
    vals = torch.rand(B, C, H * W, device=card, generator=g).transpose(1, 2)
    cells = B * 256 * 256 * 32
    grid, want_grid = segment_sum(slot, vals, cells), segment_sum(want_slot, vals, cells)
    moved = float((slot != want_slot).sum()) * 2 / max(kept * B * H * W, 1.0)
    share = float((grid - want_grid).double().abs().sum() / want_grid.double().sum())
    assert share <= GRID_MASS_SHARE + moved


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 37, 53), (2, 40, 66), (3, 16, 32),
                                   (1, 1, 1)])
@pytest.mark.parametrize("slots", [True, False], ids=["slots", "points"])
def test_ragged_images_and_points_alone(card, shape, slots):
    """Images whose pixels are no multiple of a warp's 128 (or of 4, one
    pixel at a time), with slots and without."""
    cam = CameraConfig(fx=40.0, fy=41.5, cx=shape[2] / 2, cy=shape[1] / 2, width=shape[2],
                       height=shape[1])
    occ = OccupancyConfig(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0),
                          pc_shift=(4.0, 4.0, 0.0))
    inv = _inverse_depth(card, shape, seed=2)
    with torch.no_grad():
        points, slot = us.unproject_slots(inv, cam, occ, slots)
        want_points, want_slot = _plain(inv, cam, occ, slots)
    assert torch.equal(_bits(points), _bits(want_points))
    if slots:
        assert torch.equal(slot, want_slot)
    else:
        assert slot is None


def test_a_misaligned_input_is_copied_first(card):
    cam, occ = _configs("swin2t256")
    flat = _inverse_depth(card, (1 + 2 * H * W,), seed=3)
    inv = flat[1:].view(2, H, W)
    assert inv.data_ptr() % 16 and inv.is_contiguous()
    with torch.no_grad():
        points, slot = us.unproject_slots(inv, cam, occ, True)
        want_points, want_slot = _plain(inv, cam, occ)
    assert torch.equal(_bits(points), _bits(want_points))
    assert float((slot != want_slot).float().mean()) <= SLOT_MISMATCH_SHARE


def test_the_kernel_refuses_what_it_does_not_take(card):
    cam, occ = _configs("swin2t256")
    inv = _inverse_depth(card, (1, 8, 8))
    args = ([cam.fx, cam.fy, cam.cx, cam.cy], occ.pc_scale, occ.pc_shift,
            occ.correction_angle, occ.grid_size, occ.scale, True)
    with pytest.raises(ValueError, match="contiguous"):
        us.launch(inv.transpose(1, 2), *args)
    with pytest.raises(ValueError, match="contiguous"):
        us.launch(inv.double(), *args)


def test_a_recorded_tail_keeps_the_plain_path_and_its_gradient(card):
    cam, occ = _configs("swin2t256")
    inv = (torch.rand(1, 8, 8, device=card) * 0.5 + 0.1).requires_grad_(True)
    seg = torch.rand(1, C, 8, 8, device=card, requires_grad=True)
    launches, fallbacks = _counts()
    out = geometry.get_semantic_occupancy(inv, seg, cam, occ, C, compute_occ=True,
                                          output_size=(16, 24))
    assert _counts() == (launches, fallbacks + 1)
    (out[2].sum() + out[3].sum()).backward()
    assert inv.grad is not None and bool(torch.isfinite(inv.grad).all())
    assert seg.grad is not None and float(seg.grad.abs().sum()) > 0


def _flagship(card):
    from soccdpt_torch.models.soccdpt import build_model

    cam, occ = _configs("swin2t256")
    cfg = ModelConfig(model_type="dpt_swin2_tiny_256", version=3, compute_dtype="bfloat16",
                      camera=cam, occupancy=occ)
    model = build_model(cfg, device=card, seed=0)
    with torch.no_grad():  # inverse depth in the configuration's band
        model.depth_net.head.conv3.weight.mul_(0.01)
        model.depth_net.head.conv3.bias.fill_(0.3)
    return cfg, model


def test_a_served_grid_request_as_a_cuda_graph(card):
    """The flagship at batch 6, 1080p frames: eager requests launch the
    kernel once each; the graph counts it at its warm-up and its capture
    and never at a replay, with no fallback; every replay equals the eager
    request on the same frames."""
    from soccdpt_torch.serving import GraphedFunction, make_serving_fn

    cfg, model = _flagship(card)
    eager = make_serving_fn(cfg, model, compute_occ=True, graph=False)
    graph = make_serving_fn(cfg, model, compute_occ=True)
    assert isinstance(graph, GraphedFunction)
    launches, fallbacks = _counts()
    for seed in range(3):
        frames = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8,
                               generator=torch.Generator().manual_seed(seed))
        want = eager(frames)
        got = graph(frames)
        torch.cuda.synchronize()
        if seed == 0:
            assert _counts()[0] - launches == 1 + 2  # eager, then warm-up and capture
        for g, w, what in zip(got[:3], want[:3], ("inv_depth", "seg", "points")):
            assert torch.equal(g, w), what
        torch.testing.assert_close(got[3], want[3], rtol=GRID_TOL, atol=GRID_TOL)
        assert float(want[3].sum()) > 0
    assert _counts() == (launches + 3 + 2, fallbacks)  # two more eager requests, no replay


def test_the_exported_flagship_with_points_calls_the_op_once(card, tmp_path):
    from soccdpt_torch.cli.export import export_model
    from soccdpt_torch.cli.run_exported import load_program
    from soccdpt_torch.models.bias_cache import build_inference_cache
    from soccdpt_torch.models.soccdpt import build_model

    path = export_model("dpt_swin2_tiny_256", 3, str(tmp_path / "points.pt2"),
                        with_points=True, device=card)
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("soccdpt.unproject_slots.default") == 1
    assert not any("stack" in t for t in targets)
    module = load_program(path, card)
    eager = build_model(ModelConfig(model_type="dpt_swin2_tiny_256", compute_dtype="bfloat16"),
                        device=card)
    build_inference_cache(eager.eval())
    x = torch.randn(2, 3, 256, 256, device=card,
                    generator=torch.Generator(device=card).manual_seed(4))
    launches, fallbacks = _counts()
    with torch.no_grad():
        got = module(x)
        want = eager(x, compute_occ=False)[:3]
    assert _counts() == (launches + 2, fallbacks)
    # bit for bit, or within the ladder of tests/test_composition_oracle.py
    for g, w, tol in zip(got, want, EXPORT_LADDER):
        assert g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
