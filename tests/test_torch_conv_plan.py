"""The launch planner of the decoder convolutions' bf16 route (K3, K4 on
the tensor cores: ``soccdpt_torch/kernels/_conv.py``, ``plan_conv``), on
the CPU: pure Python, no card and no JAX.

The planner picks, from (B, H, W, C) and the taps, a box of output pixels,
a tile of output channels and a split of the K-steps; the kernel
(``csrc/conv_wgmma.cuh``) trusts it, so what it must hold is checked here:
shared memory within a block's 232,448 B, splits that divide the
K-steps, boxes that cover every pixel of a ragged map, and grids that
fill the card (132 SMs on an H100): at least half the SMs without a split,
else one CTA per SM where a split into runs of at least
``MIN_SPLIT_KSTEPS`` K-steps reaches it (the flagship's 32x32 map; at 8x8
and 16x16 the floor holds the split, as measured).
The fragment and workspace layouts the kernel's epilogue and split-K sum
use are restated and checked to cover each value exactly once.
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.kernels import _conv
from soccdpt_torch.kernels.fused_fusion import fused_rcu_tail
from soccdpt_torch.kernels.fused_rcu import fused_rcu

# (B, H, W, C): the flagship's decoder maps (8..64) and BEiT-large's
# (16..128) at batch 1 and 2, ragged maps, and channels below one K-step
SHAPES = ([(B, s, s, 256) for B in (1, 2) for s in (8, 16, 32, 64, 128)]
          + [(1, 7, 9, 16), (2, 5, 13, 64), (1, 1, 3, 8), (1, 8, 8, 8), (1, 16, 16, 16),
             (2, 24, 16, 16), (1, 9, 11, 128), (3, 33, 17, 64)])


def _plans():
    return [(shape, taps, _conv.plan_conv(*shape, taps)) for shape in SHAPES for taps in (9, 1)]


@pytest.mark.parametrize("config", range(len(_conv.WGMMA_TILES)))
def test_every_tile_fits_a_blocks_shared_memory(config):
    box_h, box_w, bn = _conv.WGMMA_TILES[config]
    assert _conv.wgmma_smem_bytes(box_h, box_w, bn) <= _conv.MAX_SMEM_BYTES
    # whole warpgroups of 64 rows and whole 64-column B boxes
    assert box_h * box_w % 64 == 0 and bn % 64 == 0


def test_the_smem_formula_counts_the_ring():
    # 1 KB of alignment slack, 6 stages of A (128 x 128 B) and B (128 x 128 B),
    # 12 barriers of 8 B, a 16 B flag
    assert _conv.STAGES == 6
    assert _conv.wgmma_smem_bytes(16, 8, 128) == 1024 + 6 * (16384 + 16384) + 96 + 16


@pytest.mark.parametrize("shape", SHAPES)
def test_splits_divide_the_k_steps(shape):
    C = shape[-1]
    for taps in (9, 1):
        plan = _conv.plan_conv(*shape, taps)
        assert plan.ksteps == taps * -(-C // _conv.KSTEP)
        assert plan.splits >= 1 and plan.ksteps % plan.splits == 0
        assert plan.smem_bytes <= _conv.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", SHAPES)
def test_boxes_and_channel_tiles_cover_every_output(shape):
    B, H, W, C = shape
    for taps in (9, 1):
        plan = _conv.plan_conv(*shape, taps)
        box_h, box_w, bn = plan.box
        covered = np.zeros((H, W), bool)
        for by in range(plan.boxes_y):
            for bx in range(plan.boxes_x):
                covered[by * box_h:(by + 1) * box_h, bx * box_w:(bx + 1) * box_w] = True
        assert covered.all()
        # no box lies wholly outside the map
        assert (plan.boxes_y - 1) * box_h < H and (plan.boxes_x - 1) * box_w < W
        assert plan.n_tiles * bn >= C > (plan.n_tiles - 1) * bn
        assert plan.batch == B and plan.tiles == B * plan.boxes_y * plan.boxes_x * plan.n_tiles


@pytest.mark.parametrize("size", [8, 16, 32, 64, 128])
def test_decoder_maps_at_batch_1_fill_the_card_where_the_plan_says_so(size):
    """The flagship's four maps (8..64) and BEiT-large's largest (128), C =
    256, batch 1, the 3x3 convs: unsplit, CTAs for at least half the SMs;
    split, one CTA per SM unless the split is at its floor of
    MIN_SPLIT_KSTEPS K-steps a CTA."""
    plan = _conv.plan_conv(1, size, size, 256, 9)
    at_floor = plan.ksteps // plan.splits == _conv.MIN_SPLIT_KSTEPS
    if plan.splits == 1:
        assert 2 * plan.ctas >= _conv.SMS
    else:
        assert plan.ctas >= _conv.SMS or at_floor
    expected = {8: ((8, 8, 64), 4, 16), 16: ((8, 8, 64), 4, 64), 32: ((8, 8, 64), 3, 192),
                64: ((8, 8, 128), 1, 128), 128: ((16, 8, 128), 1, 256)}
    assert (plan.box, plan.splits, plan.ctas) == expected[size]


def test_the_largest_tile_that_fills_half_the_card_wins():
    plan = _conv.plan_conv(1, 128, 128, 256, 9)
    assert plan.box == _conv.WGMMA_TILES[0] and plan.splits == 1
    # 16x8 x 128 gives 64 CTAs at 64x64, fewer than half of 132: the next tile
    assert _conv.plan_conv(1, 64, 64, 256, 9).box == (8, 8, 128)
    assert _conv.plan_conv(2, 64, 64, 256, 9).box == (16, 8, 128)
    # where no tile fills half the card, the one with the most CTAs is split
    plan = _conv.plan_conv(1, 32, 32, 256, 9)
    assert plan.box == (8, 8, 64) and plan.splits == 3 and plan.ctas == 192


def test_no_split_is_shorter_than_the_floor():
    for shape in SHAPES:
        for taps in (9, 1):
            plan = _conv.plan_conv(*shape, taps)
            assert plan.ksteps // plan.splits >= min(_conv.MIN_SPLIT_KSTEPS, plan.ksteps)
    # one K-step a tap (C <= 64): never split
    assert _conv.plan_conv(1, 7, 9, 16, 9).splits == 1
    assert _conv.plan_conv(1, 1, 3, 8, 1).splits == 1


@pytest.mark.parametrize("shape,taps,plan", _plans()[::3])
def test_split_k_workspace_holds_one_tile_per_cta(shape, taps, plan):
    box_h, box_w, bn = plan.box
    if plan.splits == 1:
        assert plan.partial_floats == 0
        return
    assert plan.partial_floats == plan.ctas * box_h * box_w * bn
    # the kernel's float4 index [tile][split][SUMS / 4][CONSUMERS] stays inside it
    consumers, sums = box_h * box_w * 2, bn // 2
    last = ((((plan.tiles - 1) * plan.splits + plan.splits - 1) * (sums // 4) + sums // 4 - 1)
            * consumers + consumers - 1)
    assert 4 * (last + 1) == plan.partial_floats


@pytest.mark.parametrize("bn", [64, 128])
def test_the_accumulator_fragment_covers_the_tile_once(bn):
    """wgmma's m64nNk16 f32 layout as the epilogue reads it: thread t of a
    warpgroup (warp w, lane l), register 4 j + 2 h + q holds row
    16 w + l / 4 + 8 h and column 8 j + 2 (l % 4) + q."""
    seen = np.zeros((64, bn), int)
    for t in range(128):
        w, lane = t // 32, t % 32
        for j in range(bn // 8):
            for h in range(2):
                for q in range(2):
                    seen[16 * w + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + q] += 1
    assert (seen == 1).all()


def test_scratch_gives_each_convolution_its_own_counters():
    plans = [_conv.plan_conv(1, 8, 8, 256, 9)] * 2 + [_conv.plan_conv(1, 16, 16, 256, 9)]
    assert all(p.splits > 1 for p in plans)
    scratch = _conv.Scratch(plans, "cpu")
    assert scratch.partials.numel() == max(p.partial_floats for p in plans)
    # one counter per output tile; the prepare launch zeroes them
    assert scratch.counters.numel() == sum(p.tiles for p in plans)
    taken = [scratch.take(p)[1] for p in plans]
    starts = [c.data_ptr() for c in taken]
    assert len(set(starts)) == 3 and [c.numel() for c in taken] == [p.tiles for p in plans]
    unsplit = _conv.Scratch([_conv.plan_conv(1, 128, 128, 256, 9)], "cpu")
    assert unsplit.partials is None and unsplit.take(_conv.plan_conv(1, 128, 128, 256, 9)) == (
        None, None)


class _FakePrepare:
    """Stands in for a kernel library's ``soccdpt_prepare_bf16`` and
    decodes the arguments ``prepare_bf16`` passes it."""

    seen = None

    def __call__(self, n, w, strides, taps, is_bf16, out, counters, n_counters, C, stream):
        import ctypes

        def read(arg, kind, count):
            return list((kind * count).from_address(arg.value))

        st = read(strides, ctypes.c_longlong, 4 * n)
        self.seen = {"n": n, "w": read(w, ctypes.c_void_p, n), "out": read(out, ctypes.c_void_p, n),
                     "taps": read(taps, ctypes.c_int, n),
                     "is_bf16": read(is_bf16, ctypes.c_int, n),
                     "strides": [tuple(st[4 * i:4 * i + 4]) for i in range(n)],
                     "counters": counters, "n_counters": n_counters, "C": C}
        return 0


def test_prepare_passes_every_weight_with_its_strides_taps_and_dtype(monkeypatch):
    """One launch converts all of a call's weights, whatever their layout, and
    zeroes its split-K counters: the arguments as the C entry reads them."""
    C = 16
    rng = np.random.default_rng(1)
    oihw = torch.from_numpy(rng.standard_normal((C, C, 3, 3)).astype(np.float32))
    w1 = oihw.permute(2, 3, 1, 0)  # a port module's weight seen as HWIO
    w2 = torch.from_numpy(rng.standard_normal((3, 3, C, C)).astype(np.float32)).bfloat16()
    wo = torch.from_numpy(rng.standard_normal((C, C)).astype(np.float32)).t().reshape(1, 1, C, C)
    like = torch.zeros(1, 2, 2, C, dtype=torch.bfloat16)
    scratch = _conv.Scratch([_conv.plan_conv(1, 8, 8, 256, 9)], "cpu")
    fake = _FakePrepare()
    lib = type("Lib", (), {"soccdpt_prepare_bf16": fake})()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    outs = _conv.prepare_bf16(lib, like, [w1, w2, wo], scratch)
    seen = fake.seen
    assert seen["w"] == [w1.data_ptr(), w2.data_ptr(), wo.data_ptr()]
    assert seen["out"] == [o.data_ptr() for o in outs]
    assert (seen["n"], seen["taps"], seen["is_bf16"], seen["C"]) == (3, [9, 9, 1], [0, 1, 0], C)
    assert seen["strides"] == [w1.stride(), w2.stride(), wo.stride()]
    assert (seen["counters"], seen["n_counters"]) == (scratch.counters.data_ptr(),
                                                      scratch.counters.numel())
    assert [tuple(o.shape) for o in outs] == [(9, C, C), (9, C, C), (1, C, C)]
    assert all(o.dtype == torch.bfloat16 and o.is_contiguous() for o in outs)


def test_biases_stay_f32_without_a_copy():
    like = torch.zeros(1, dtype=torch.bfloat16)
    b = torch.randn(8)
    assert _conv.wgmma_bias(b, like).data_ptr() == b.data_ptr()
    bb = _conv.wgmma_bias(b.to(torch.bfloat16), like)
    assert bb.dtype == torch.float32 and torch.equal(bb, b.to(torch.bfloat16).float())


@pytest.mark.parametrize("op", ["rcu", "tail"])
def test_a_bf16_call_with_a_tile_raises(op):
    """``tile`` is the f32 route's: a bf16 call that passes one raises, on
    any device, rather than ignore it."""
    rng = np.random.default_rng(0)
    C = 16
    s = torch.from_numpy(rng.standard_normal((1, 4, 4, C)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, C, C)).astype(np.float32)) * 0.05
    b = torch.zeros(C)
    wo = torch.eye(C)
    with torch.no_grad():
        for tile in (8, 4):
            with pytest.raises(ValueError, match="f32 route only"):
                if op == "rcu":
                    fused_rcu(s.bfloat16(), w, b, w, b, tile=tile)
                else:
                    fused_rcu_tail(s.bfloat16(), w, b, w, b, wo, b, tile=tile)
        # f32 takes it (the CPU runs the plain version either way)
        if op == "rcu":
            assert fused_rcu(s, w, b, w, b, tile=4).shape == s.shape
        else:
            assert fused_rcu_tail(s, w, b, w, b, wo, b, tile=4).shape == (1, 8, 8, C)


# --- K5: the depth head's conv, Ci -> Cm, with the head epilogue ----------------------

# (B, H, W, Ci, Cm) of the conv, at the upsampled size: the flagship's and
# BEiT-large's head at batch 1 and 2, the mirrored JAX cases, ragged maps,
# Cm = 4, 36 (columns padded to 40) and above 128 (two N tiles walked)
HEAD_SHAPES = [(1, 256, 256, 128, 32), (2, 512, 512, 128, 32), (1, 32, 32, 8, 8),
               (2, 32, 64, 16, 8), (1, 14, 18, 16, 8), (2, 10, 26, 64, 36), (1, 2, 6, 8, 4),
               (1, 16, 16, 16, 200), (1, 8, 12, 64, 256)]


@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_plans_take_bn_against_cm_and_walk_every_channel(shape):
    B, H, W, Ci, Cm = shape
    plan = _conv.plan_head(B, H, W, Ci, Cm)
    box_h, box_w, bn = plan.box
    assert plan.head and plan.box == _conv.HEAD_TILES[plan.config]
    # bn 64 up to Cm = 64, else 128; the CTA walks its N tiles over every channel
    assert bn == (64 if Cm <= 64 else 128)
    assert plan.walk == -(-Cm // bn) and plan.walk * bn >= Cm > (plan.walk - 1) * bn
    # one CTA a box: no split of K, no grid of N tiles (the 1x1 conv sums them)
    assert plan.splits == 1 and plan.n_tiles == 1 and plan.partial_floats == 0
    assert plan.ksteps == 9 * -(-Ci // _conv.KSTEP)
    assert plan.smem_bytes <= _conv.MAX_SMEM_BYTES
    covered = np.zeros((H, W), bool)
    for by in range(plan.boxes_y):
        for bx in range(plan.boxes_x):
            covered[by * box_h:(by + 1) * box_h, bx * box_w:(bx + 1) * box_w] = True
    assert covered.all() and plan.tiles == B * plan.boxes_y * plan.boxes_x


@pytest.mark.parametrize("Cm,bn,walk", [(4, 64, 1), (32, 64, 1), (36, 64, 1), (64, 64, 1),
                                        (72, 128, 1), (128, 128, 1), (136, 128, 2),
                                        (200, 128, 2), (260, 128, 3)])
def test_head_n_tiles_against_cm(Cm, bn, walk):
    plan = _conv.plan_head(1, 64, 64, 128, Cm)
    assert (plan.box[2], plan.walk) == (bn, walk)
    # the prepared rows: Cm rounded up to 8 columns, whole 16-byte rows for TMA
    assert _conv.head_columns(Cm) % 8 == 0 and 0 <= _conv.head_columns(Cm) - Cm < 8


def test_the_flagship_head_fills_the_card_with_the_larger_box():
    plan = _conv.plan_head(1, 256, 256, 128, 32)
    assert plan.box == (16, 8, 64) and plan.ctas == 512
    # a small map takes the 8x8 box, which gives more CTAs
    assert _conv.plan_head(1, 32, 32, 8, 8).box == (8, 8, 64)


def test_every_head_tile_fits_a_blocks_shared_memory():
    for box_h, box_w, bn in _conv.HEAD_TILES:
        assert _conv.wgmma_smem_bytes(box_h, box_w, bn) <= _conv.MAX_SMEM_BYTES
        assert box_h * box_w % 64 == 0 and bn % 64 == 0


class _FakeHeadLib:
    """Stands in for the fused-head library: records the entries a call
    reaches and decodes the preparation's arguments."""

    def __init__(self):
        self.calls, self.prepared = [], None
        for name in ("soccdpt_upsample2x_bf16", "soccdpt_head_conv_bf16",
                     "soccdpt_fused_head_f32"):
            setattr(self, name, self._entry(name))
        self.soccdpt_prepare_head_bf16 = self._prepare_entry()

    def _entry(self, name):
        lib = self

        class Entry:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append((name, args))
                return 0
        return Entry()

    def _prepare_entry(self):
        import ctypes

        lib = self

        def read(arg, kind, count):
            return list((kind * count).from_address(arg.value))

        class Entry:
            argtypes = restype = None

            def __call__(self, w2, strides, is_bf16, w_out, vec, vec_strides, vec_n, vec_bf16,
                         vec_out, Ci, Cm, Cw, stream):
                lib.calls.append(("soccdpt_prepare_head_bf16", ()))
                lib.prepared = {"w2": w2, "strides": read(strides, ctypes.c_longlong, 4),
                                "is_bf16": is_bf16, "w_out": w_out,
                                "vec": read(vec, ctypes.c_void_p, 3),
                                "vec_strides": read(vec_strides, ctypes.c_longlong, 3),
                                "vec_n": read(vec_n, ctypes.c_int, 3),
                                "vec_bf16": read(vec_bf16, ctypes.c_int, 3),
                                "vec_out": vec_out, "dims": (Ci, Cm, Cw)}
                return 0
        return Entry()


@pytest.fixture
def fake_head(monkeypatch):
    from soccdpt_torch.kernels import _build, upsample

    lib = _FakeHeadLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    # the upsample's band plan reads the card's SM count: an H100 SXM's
    monkeypatch.setattr(upsample, "_sms", lambda device: 132)
    return lib


@pytest.mark.parametrize("Cm", [8, 36])
def test_a_bf16_head_call_is_prepare_upsample_conv(fake_head, Cm):
    """Three launches: one preparation of all four weights as they lie (a
    port module's OIHW conv weight seen as HWIO, w3 in its (1, 1, Cm, 1)
    form, a scalar b3), the upsample of x into u, the head conv of u."""
    from soccdpt_torch.kernels import fused_head as fh

    B, H, W, Ci = 2, 5, 7, 16
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, H, W, Ci)).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy(rng.standard_normal((Cm, Ci, 3, 3)).astype(np.float32)).permute(
        2, 3, 1, 0)
    b2 = torch.zeros(Cm)
    w3 = torch.zeros(1, Cm, 1, 1).permute(2, 3, 1, 0)
    b3 = torch.zeros(())
    before = fh.fused_head_tail.launches
    out = fh._launch(x, w2, b2, w3, b3)
    assert fh.fused_head_tail.launches == before + 1
    assert [name for name, _ in fake_head.calls] == [
        "soccdpt_prepare_head_bf16", "soccdpt_upsample2x_bf16", "soccdpt_head_conv_bf16"]
    seen = fake_head.prepared
    Cw = _conv.head_columns(Cm)
    assert seen["w2"] == w2.data_ptr() and seen["strides"] == list(w2.stride())
    assert seen["is_bf16"] == 0 and seen["dims"] == (Ci, Cm, Cw)
    assert seen["vec"] == [b2.data_ptr(), w3.data_ptr(), b3.data_ptr()]
    assert seen["vec_n"] == [Cm, Cm, 1] and seen["vec_bf16"] == [0, 0, 0]
    _, up = fake_head.calls[1]
    assert up[0] == x.data_ptr() and up[2:6] == (B, H, W, Ci)
    _, conv = fake_head.calls[2]
    plan = _conv.plan_head(B, 2 * H, 2 * W, Ci, Cm)
    assert conv[0] == up[1]  # the conv reads the upsample's output
    assert conv[3] == out.data_ptr() and out.shape == (B, 2 * H, 2 * W)
    assert out.dtype == torch.bfloat16
    assert conv[4:12] == (B, 2 * H, 2 * W, Ci, Cm, Cw, plan.config, plan.walk)


def test_an_f32_head_call_takes_the_cuda_core_entry(fake_head):
    from soccdpt_torch.kernels import fused_head as fh

    x = torch.zeros(1, 4, 4, 8)
    fh._launch(x, torch.zeros(3, 3, 8, 4), torch.zeros(4), torch.zeros(4), torch.zeros(1))
    assert [name for name, _ in fake_head.calls] == ["soccdpt_fused_head_f32"]
