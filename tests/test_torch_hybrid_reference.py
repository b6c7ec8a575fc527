"""The port's ViT-hybrid (``dpt_hybrid_384``) against the benchmark's plain
reference (``benchmark/reference/vit_hybrid.py``), on the CPU, and the
trunk's counters.

One state dict, drawn by ``benchmark.system.make_weights`` for the
benchmark's hybrid configuration at the test trunk's sizes (its family's
``TINY``: the program's ``hybridtest_64``), loads into both by name. Frames
come from the same seed.

Tolerances:

* f32 against f32: 1e-4 relative to each output's largest magnitude on the
  trunk's four feature maps and on inverse depth, segmentation, points and
  grid. Two f32 stacks that order their sums differently (the program's
  K6 plain version, its cached standardized kernels, NHWC convs) agree to
  about 1e-6 here.
* bf16 program against the f32 reference: the shape error of inverse depth
  (``depth_err``) under 0.15 and the segmentation's (``seg_err``) under
  0.04, the benchmark's own numbers (``benchmark/check.py``). The bf16
  program reads about 0.091 and 0.014 on this seed, and the reference's fp8
  control (bf16 activations, fp8 e4m3 products) about 0.26 and 0.096: each
  bound lies near the geometric mean of the two, and the test shows the
  control lands above both.
"""
import copy

import pytest
import torch

from benchmark import check, reference, run, spec, system
from benchmark.reference import precision, vit_hybrid as ref_hybrid
from soccdpt_torch.core.config import MODEL_TYPES
from soccdpt_torch.models.backbones import vit as program_vit
from soccdpt_torch.models.backbones import vit_hybrid
from soccdpt_torch.serving import make_serving_fn

CELL = "hybrid384.backlog.b6.grid"
SEED = 2**31 + 77
F32_RTOL = 1e-4
BF16_BOUNDS = {"depth_err": 0.15, "seg_err": 0.04}
MODEL_TYPES.setdefault(ref_hybrid.TINY[0], ref_hybrid.TINY[1])


def tiny_cfg(dtype: str) -> dict:
    """The benchmark's hybrid configuration at the test trunk's sizes: a
    64 px net, a 48x64 camera, a 16x16x8 grid."""
    cfg = copy.deepcopy(spec.load(run.ROOT, CELL).config)
    cfg["model_type"], _, cfg["backbone"] = copy.deepcopy(ref_hybrid.TINY)
    cfg.update(net_size=[64, 64], features=16, head_features_2=8, compute_dtype=dtype)
    cfg["camera"].update(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0)
    cfg["occupancy"].update(grid_size=[16, 16, 8], pc_scale=[1.0, 1.0, 1.0],
                            pc_shift=[4.0, 4.0, 0.0])
    # at the cell's 0.002 the test trunk's inverse depth spreads so little
    # that bf16's rounding of it (about 6e-4 at 0.31) reads as large as the
    # fp8 control's error; at 0.01 it spreads as the real trunk's does
    cfg["weights"]["depth_net.head.conv3.weight"]["std"] = 0.01
    return cfg


@pytest.fixture(scope="module")
def drawn():
    """(state, frames, the f32 reference and its outputs) of the seed."""
    run._reference_precision()
    cfg = tiny_cfg("float32")
    state = system.make_weights(cfg, SEED, "cpu")
    frames = system.frames(SEED, 1, 2, cfg, "cpu")[0]
    model = reference.build(cfg, state, "cpu")
    return state, frames, model, reference.serve(model, frames, cfg)


def assert_close(got: torch.Tensor, want: torch.Tensor, name: str):
    assert got.shape == want.shape, name
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= F32_RTOL * max(scale, 1e-30), (name, err, scale)


def test_trunk_features_f32(drawn):
    state, frames, model, _ = drawn
    cfg = tiny_cfg("float32")
    prog = system.program_model(cfg, state, "cpu").eval()
    x = reference.preprocess(frames, cfg["net_size"]).permute(0, 2, 3, 1)
    with torch.no_grad():
        got = prog.depth_net.backbone(x)
        want = model.depth_net.backbone(x)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert w.shape[-1] == model.depth_net.backbone.channels[i]
        assert_close(g, w, f"level {i + 1}")


def test_served_outputs_f32(drawn):
    state, frames, _, want = drawn
    cfg = tiny_cfg("float32")
    prog = system.program_model(cfg, state, "cpu")
    serve = make_serving_fn(system.model_config(cfg), prog, compute_occ=True, device="cpu",
                            graph=False)
    got = serve(frames)
    for name, g, w in zip(("inverse depth", "segmentation", "points", "grid"), got, want):
        assert_close(g, w, name)
    assert float(want[3].sum()) > 0  # the seeded points land in the grid


def test_bf16_program_within_bound_fp8_control_outside(drawn):
    state, frames, model, want = drawn
    cfg = tiny_cfg("bfloat16")
    prog = system.program_model(cfg, state, "cpu")
    serve = make_serving_fn(system.model_config(cfg), prog, compute_occ=True, device="cpu",
                            graph=False)
    program = check.serve_numbers(serve(frames), want, cfg)
    with precision.precision("fp8"):
        control = check.serve_numbers(reference.serve(model, frames, cfg), want, cfg)
    for name, bound in BF16_BOUNDS.items():
        assert 0 < program[name] < bound < control[name], (name, program[name], control[name])


def test_counters_on_the_test_trunk(drawn):
    """A forward without gradients runs one GroupNorm a conv (13 on the
    test trunk) and standardizes each kernel once; a second one takes
    every kernel from the cache."""
    state, frames, _, _ = drawn
    cfg = tiny_cfg("float32")
    prog = system.program_model(cfg, state, "cpu").eval()
    x = reference.preprocess(frames, cfg["net_size"]).permute(0, 2, 3, 1)
    convs = sum(isinstance(m, vit_hybrid.WSConv) for m in prog.modules())
    norms = sum(isinstance(m, torch.nn.GroupNorm) for m in prog.modules())
    assert convs == norms == 13
    with torch.no_grad():
        before = vit_hybrid.counts()
        prog.depth_net.backbone(x)
        first = vit_hybrid.counts()
        prog.depth_net.backbone(x)
        second = vit_hybrid.counts()
    assert first["group_norm"] - before["group_norm"] == 13
    assert first["standardized_weight"] - before["standardized_weight"] == 13
    assert second["group_norm"] - first["group_norm"] == 13
    assert second["standardized_weight"] == first["standardized_weight"]
    # with gradients nothing is cached: every kernel is standardized again
    prog.depth_net.backbone(x)
    assert vit_hybrid.counts()["standardized_weight"] - second["standardized_weight"] == 13


def test_counters_full_width(monkeypatch):
    """``vitb_rn50_384`` on the meta device at batch 6: 52 GroupNorms and
    52 standardized kernels in the first forward without gradients, none
    standardized in the second; twelve K6 calls of (6, 12, 577, 64)
    without a bias, as the benchmark's ``k6_calls`` counts them."""
    calls = []

    def record(q, k, v, bias=None, scale=1.0):
        calls.append((*q.shape, 0 if bias is None else bias.element_size()))
        return torch.empty_like(v)

    monkeypatch.setattr(program_vit, "global_attention", record)
    with torch.device("meta"):
        trunk = vit_hybrid.ViTHybridBackbone(vit_hybrid.HYBRID_CONFIGS["vitb_rn50_384"])
        x = torch.empty(6, 384, 384, 3)
    trunk.eval()
    with torch.no_grad():
        before = vit_hybrid.counts()
        feats = trunk(x)
        first = vit_hybrid.counts()
        trunk(x)
        second = vit_hybrid.counts()
    assert [tuple(f.shape) for f in feats] == [(6, 96, 96, 256), (6, 48, 48, 512),
                                               (6, 24, 24, 768), (6, 12, 12, 768)]
    assert first["group_norm"] - before["group_norm"] == 52
    assert first["standardized_weight"] - before["standardized_weight"] == 52
    assert second["group_norm"] - first["group_norm"] == 52
    assert second["standardized_weight"] == first["standardized_weight"]
    cfg = spec.load(run.ROOT, CELL).config
    assert calls[:12] == ref_hybrid.k6_calls(cfg, 6) == [(6, 12, 577, 64, 0)] * 12


def test_reference_runs_the_program_state_strictly(drawn):
    """The reference trunk's parameters carry the program's names: a
    strict load of the program's own state dict, both ways."""
    state, _, model, _ = drawn
    cfg = tiny_cfg("float32")
    prog = system.program_model(cfg, state, "cpu")
    model.load_state_dict(prog.state_dict(), strict=True)
    prog.load_state_dict(model.state_dict(), strict=True)
    names = set(model.state_dict())
    for leaf in ("stem_conv.weight", "stage0_block0.downsample_gn.weight", "patch_embed_proj.bias",
                 "block1.qkv.bias", "readout3.project.weight", "proj4.weight", "down2x.weight",
                 "pos_embed", "cls_token"):
        assert f"depth_net.backbone.{leaf}" in names, leaf

