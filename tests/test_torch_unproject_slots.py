"""The ``soccdpt::unproject_slots`` op on the CPU (``kernels/unproject_slots.py``)
and which calls of ``ops/geometry.py::get_semantic_occupancy`` take it.

The op's CPU implementation is the plain path, so it is held bit for bit
to ``unproject_depth`` and ``occupancy_slots`` composed by hand here: over
batches 1-3, the camera's own size and a reduced output size (the
intrinsics scaled as ``get_semantic_occupancy`` scales them), inverse
depths of 0, inf, NaN and below 0, and points placed exactly on cell faces
and on the grid's edges. The dispatch rule is checked on fake CUDA tensors
(``FakeTensorMode``: shapes, dtypes, strides and a CUDA device, no data)
with the op and K2 stubbed, so nothing launches.
"""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck

from soccdpt_torch.core.config import CameraConfig, OccupancyConfig
from soccdpt_torch.kernels import ops
from soccdpt_torch.kernels import unproject_slots as us
from soccdpt_torch.kernels.segment_sum import segment_sum as k2
from soccdpt_torch.ops import geometry
from soccdpt_torch.ops.geometry import occupancy_slots, rotate_points, unproject_depth

CAM = CameraConfig(fx=50.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
# 1 m cells (scale 1 voxel a meter), no rotation: the point (v - cx) depth / fx
# + 4 lies on a face wherever v = cx, and depth 2 on the face z = 2
FACES = OccupancyConfig(grid_size=(8, 8, 4), scale=(1.0, 1.0, 1.0), pc_scale=(1.0, 1.0, 1.0),
                        pc_shift=(4.0, 4.0, 0.0), correction_angle=(0.0, 0.0, 0.0))
TILTED = OccupancyConfig(grid_size=(16, 16, 8), scale=(2.0, 2.0, 0.666),
                         pc_scale=(1.5, 2.5, 1.0), pc_shift=(4.0, 4.0, 1.0),
                         correction_angle=(7.0, -3.0, 2.0))
SPECIALS = (0.0, float("inf"), float("nan"), -0.25, -float("inf"), 1e-12)


def _camera_at(H, W):
    """``get_semantic_occupancy``'s intrinsics at an output size."""
    sy, sx = H / CAM.height, W / CAM.width
    return CameraConfig(fx=CAM.fx * sx, fy=CAM.fy * sy, cx=CAM.cx * sx, cy=CAM.cy * sy,
                        width=W, height=H)


def _inverse_depth(B, H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    inv = torch.rand(B, H, W, generator=g) * 0.6 + 0.1
    inv[:, ::5, ::3] = 0.5  # depth 2: on the face z = 2
    inv[:, ::5, W // 2] = 0.5  # and at v = cx, x on a face too
    inv[:, 1, :4] = 0.25  # depth 4: on the grid's far edge in z (out)
    for i, special in enumerate(SPECIALS):
        inv.view(-1)[3 + 11 * i::97] = special
    return inv


def _by_hand(inv, cam, occ):
    """``unproject_depth`` and ``occupancy_slots``, composed as the plain
    path composes them."""
    points = unproject_depth(1.0 / torch.clamp(inv, min=1e-8), cam)
    pts = points.reshape(inv.shape[0], -1, 3)
    pts = rotate_points(pts * torch.tensor(occ.pc_scale) + torch.tensor(occ.pc_shift),
                        occ.correction_angle)
    sem = torch.zeros(inv.shape[0], pts.shape[1], 3)
    return points, occupancy_slots(pts, sem, occ, 3)[0]


def _op(inv, cam, occ, slots=True):
    return torch.ops.soccdpt.unproject_slots(
        inv, [cam.fx, cam.fy, cam.cx, cam.cy], list(occ.pc_scale), list(occ.pc_shift),
        list(occ.correction_angle), list(occ.grid_size), list(occ.scale), slots)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("size", [(48, 64), (20, 32)], ids=["camera", "reduced"])
@pytest.mark.parametrize("occ", [FACES, TILTED], ids=["faces", "tilted"])
def test_the_op_on_the_cpu_is_the_plain_path_bit_for_bit(B, size, occ):
    cam = _camera_at(*size)
    inv = _inverse_depth(B, *size, seed=B)
    points, slot = _op(inv, cam, occ)
    want_points, want_slot = _by_hand(inv, cam, occ)
    assert points.shape == (B, *size, 3) and points.dtype == torch.float32
    assert slot.shape == (B * size[0] * size[1],) and slot.dtype == torch.int32
    assert torch.equal(_bits(points), _bits(want_points))
    assert torch.equal(slot, want_slot)
    kept = slot >= 0
    assert 0.3 < float(kept.float().mean()) < 1.0
    # each image's slots lie in its own grid
    cells = math.prod(occ.grid_size)
    image = torch.arange(B).repeat_interleave(size[0] * size[1])
    assert bool((slot[kept] // cells == image[kept]).all())


def test_specials_and_faces_land_where_the_plain_rules_say():
    inv = _inverse_depth(1, 48, 64)
    points, slot = _op(inv, CAM, FACES)
    flat_inv, flat_pts = inv.view(-1), points.view(-1, 3)
    nan = torch.isnan(flat_inv)
    assert bool(torch.isnan(flat_pts[nan]).all()) and bool((slot[nan] == -1).all())
    clamped = (flat_inv <= 1e-8) & ~nan  # 0, below 0, -inf, 1e-12: depth 1 / 1e-8
    assert bool((flat_pts[clamped, 2] == 1.0 / torch.tensor(1e-8)).all())
    far = flat_inv == float("inf")  # depth 0: z = 0, the grid's near face (out)
    assert bool((flat_pts[far, 2] == 0).all()) and bool((slot[far] == -1).all())
    # depth 4 is the grid's far face in z: out, the test being strict
    assert bool((flat_pts[64:68, 2] == 4).all()) and bool((slot[64:68] == -1).all())
    # depth 2 at v = cx: x + 4 = 4 and z = 2, both on faces, kept in cells 4 and 2
    gx, gy, gz = FACES.grid_size
    on_axis = torch.arange(0, 48, 5) * 64 + 32
    on_axis = on_axis[flat_inv[on_axis] == 0.5]
    assert len(on_axis) > 5
    assert bool((flat_pts[on_axis, 0] == 0).all()) and bool((flat_pts[on_axis, 2] == 2).all())
    assert bool((slot[on_axis] // (gy * gz) == 4).all())
    assert bool((slot[on_axis] % gz == 2).all())


@pytest.mark.parametrize("B", [1, 3])
def test_points_alone_give_an_empty_slot_output(B):
    inv = _inverse_depth(B, 48, 64)
    points, slot = _op(inv, CAM, TILTED, slots=False)
    assert slot.shape == (0,) and slot.dtype == torch.int32
    assert torch.equal(_bits(points), _bits(_by_hand(inv, CAM, TILTED)[0]))


@pytest.mark.parametrize("slots", [True, False], ids=["slots", "points"])
def test_the_fake_implementation_gives_the_outputs_shapes_and_dtypes(slots):
    inv = torch.rand(2, 6, 10, generator=torch.Generator().manual_seed(0)) * 0.5 + 0.1
    opcheck(torch.ops.soccdpt.unproject_slots.default,
            (inv, [5.0, 5.0, 5.0, 3.0], [1.0, 1.0, 1.0], [4.0, 4.0, 0.0], [7.0, 0.0, 0.0],
             [8, 8, 4], [1.0, 1.0, 1.0], slots))
    with torch.device("meta"):
        points, slot = _op(inv.to("meta"), CAM, TILTED, slots)
    assert points.shape == (2, 6, 10, 3) and points.dtype == torch.float32
    assert slot.shape == ((120,) if slots else (0,)) and slot.dtype == torch.int32
    with FakeTensorMode():
        points, slot = _op(torch.empty(2, 6, 10, device="cuda"), CAM, TILTED, slots)
    assert points.device.type == "cuda" and slot.device.type == "cuda"
    assert points.shape == (2, 6, 10, 3) and slot.shape == ((120,) if slots else (0,))


def test_the_cpu_takes_the_plain_path_through_the_module_s_functions(monkeypatch):
    """CPU tensors never reach the op, and reach ``unproject_depth`` and
    ``segment_sum`` through the module's globals (the names the benchmark's
    fault tests patch); no fallback is counted off the card."""
    calls = []

    def unproject(depth, cam):
        calls.append("unproject_depth")
        return unproject_depth(depth, cam)

    def segment_sum(lin, vals, num_slots):
        calls.append("segment_sum")
        return k2(lin, vals, num_slots)

    def op(*args):
        raise AssertionError("a CPU call reached the op")

    monkeypatch.setattr(geometry, "unproject_depth", unproject)
    monkeypatch.setattr(geometry, "segment_sum", segment_sum)
    monkeypatch.setattr(geometry, "unproject_slots", op)
    fallbacks = us.unproject_slots.fallbacks
    seg = torch.rand(2, 3, 12, 16)
    out = geometry.get_semantic_occupancy(torch.rand(2, 12, 16) * 0.5 + 0.1, seg, CAM, TILTED,
                                          3, compute_occ=True)
    assert calls == ["unproject_depth", "segment_sum"]
    assert out[2].shape == (2, 48, 64, 3) and out[3].shape == (2, 16, 16, 8, 3)
    assert us.unproject_slots.fallbacks == fallbacks


def test_a_recorded_input_takes_the_plain_path_and_its_gradient_flows():
    inv = (torch.rand(1, 12, 16) * 0.5 + 0.1).requires_grad_(True)
    seg = torch.rand(1, 3, 12, 16, requires_grad=True)
    out = geometry.get_semantic_occupancy(inv, seg, CAM, TILTED, 3, compute_occ=True,
                                          output_size=(24, 32))
    (out[2].sum() + out[3].sum()).backward()
    assert inv.grad is not None and bool(torch.isfinite(inv.grad).all())
    assert float(inv.grad.abs().sum()) > 0 and float(seg.grad.abs().sum()) > 0


def _fake_cuda(shape=(2, 48, 64), dtype=torch.float32, requires_grad=False):
    return torch.empty(shape, device="cuda", dtype=dtype, requires_grad=requires_grad)


# (case, tensor maker, slots, grad enabled, takes the kernel)
RULE = [
    ("served", lambda: _fake_cuda(), True, True, True),
    ("points_alone", lambda: _fake_cuda(), False, True, True),
    ("grad_off", lambda: _fake_cuda(requires_grad=True), True, False, True),
    ("recorded", lambda: _fake_cuda(requires_grad=True), True, True, False),
    ("f64", lambda: _fake_cuda(dtype=torch.float64), True, True, False),
    ("strided", lambda: _fake_cuda((2, 64, 48)).transpose(1, 2), True, True, False),
    ("slot_overflow", lambda: _fake_cuda((1100, 4, 4)), True, True, False),
    ("slot_overflow_points_alone", lambda: _fake_cuda((1100, 4, 4)), False, True, True),
    ("image_too_large", lambda: _fake_cuda((1, 2**15, 2**15)), False, True, False),
]


@pytest.mark.parametrize("case,make,slots,grad,kernel", RULE, ids=[r[0] for r in RULE])
def test_the_dispatch_rule_on_the_card(monkeypatch, case, make, slots, grad, kernel):
    cells = 256 * 256 * 32
    with FakeTensorMode(), torch.no_grad():
        x = make()
        # the rule reads the grad mode; autograd itself stays off, since
        # recording on a fake CUDA tensor needs a CUDA build
        monkeypatch.setattr(torch, "is_grad_enabled", lambda: grad)
        assert geometry.takes_kernel(x, slots, cells) == kernel
        monkeypatch.undo()
    assert not geometry.takes_kernel(torch.empty(2, 48, 64), slots, cells)  # the CPU


@pytest.mark.parametrize("compute_occ", [False, True], ids=["points", "grid"])
def test_a_card_call_takes_the_op_and_k2_or_counts_a_fallback(monkeypatch, compute_occ):
    launched, summed = [], []

    def op(inv, cam, occ, slots):
        launched.append((cam.width, cam.height, slots))
        B, H, W = inv.shape
        slot = inv.new_empty((B * H * W,), dtype=torch.int32) if slots else None
        return inv.new_empty((B, H, W, 3)), slot

    op.fallbacks = 0

    def segment_sum(lin, vals, num_slots):
        summed.append((tuple(lin.shape), tuple(vals.shape), num_slots))
        return vals.new_empty((num_slots, vals.shape[-1]))

    def plain(inv, cam):  # aten's arange cannot make a fake CUDA tensor here
        launched.append("plain")
        return inv.new_empty((*inv.shape, 3))

    monkeypatch.setattr(geometry, "unproject_slots", op)
    monkeypatch.setattr(geometry, "segment_sum", segment_sum)
    monkeypatch.setattr(geometry, "camera_frame_points", plain)
    with FakeTensorMode(), torch.no_grad():
        out = geometry.get_semantic_occupancy(
            torch.empty(2, 12, 16, device="cuda"), torch.empty(2, 3, 12, 16, device="cuda"),
            CAM, TILTED, 3, compute_occ=compute_occ, output_size=(24, 32))
        assert out[2].shape == (2, 24, 32, 3)
        # a f64 call keeps the plain path, counted as a fallback
        geometry.get_semantic_occupancy(
            torch.empty(2, 12, 16, device="cuda", dtype=torch.float64),
            torch.empty(2, 3, 12, 16, device="cuda"), CAM, TILTED, 3, compute_occ=False,
            output_size=(24, 32))
    assert launched == [(32, 24, compute_occ), "plain"]
    cells = math.prod(TILTED.grid_size)
    assert summed == ([((2 * 24 * 32,), (2, 24 * 32, 3), 2 * cells)] if compute_occ else [])
    if compute_occ:
        assert out[3].shape == (2, *TILTED.grid_size, 3)
    assert op.fallbacks == 1


def test_the_counters():
    """``launches()`` shows the kernel; a CPU call of the op launches
    nothing; ``fallbacks()`` stays the upsample's count."""
    assert "unproject_slots" in ops.launches() and hasattr(torch.ops.soccdpt, "unproject_slots")
    assert ops.COUNTERS["unproject_slots"] is us.unproject_slots
    before = ops.launches()
    _op(_inverse_depth(1, 6, 10), CAM, TILTED)
    assert ops.launches() == before
    assert ops.fallbacks() == ops.upsample2x.fallbacks
    assert us.tail_bytes(6, 1080, 1920) == 6 * 1080 * 1920 * 20
    assert us.tail_bytes(6, 1080, 1920, slots=False) == 6 * 1080 * 1920 * 16
