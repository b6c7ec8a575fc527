"""Trunk families found by name: both cells' weights and operation counts
as they were when the harness held a closed table of trunks, a family
that exists only as a module built, drawn for and counted, and the error
for a family with no module."""
import dataclasses
import math
import re
import sys
import time
import types
from pathlib import Path

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import flops, reference, run, spec, system, work
from benchmark.reference import layers as L
from benchmark.reference import swin2

from .conftest import shrink

CELLS = ["beitl512.rig6.20hz.grid", "swin2t.backlog.b6.grid"]
SEED = 2**31 + 19
# request_flops of each cell at its batch, counted by the harness before
# the trunk families held their own facts
FLOPS = {"beitl512.rig6.20hz.grid": 6189283344384, "swin2t.backlog.b6.grid": 460201822208}


def old_rule(mod: nn.Module, name: str, t: torch.Tensor):
    """The rule table as the harness kept it in one place for both trunks."""
    if name == "weight" and isinstance(mod, nn.ConvTranspose2d):
        return 0.0, 1.0 / math.sqrt(t.shape[0])
    if name == "weight" and isinstance(mod, (nn.Linear, nn.Conv2d)):
        return 0.0, 1.0 / math.sqrt(t[0].numel())
    if name == "weight" and isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
        return 1.0, 0.05
    if name == "rel_pos_table":
        return 0.0, 0.5
    if name in ("gamma_1", "gamma_2"):
        return 0.1, 0.02
    if name == "logit_scale":
        return math.log(10.0), 0.05
    if name == "running_var":
        return 1.0, 0.1
    return 0.0, 0.05


def old_make_weights(cfg: dict, seed: int, device):
    with torch.device("meta"):
        skeleton = reference.SOccDPTV3(cfg)
    names, shapes, means, stds, ints = [], [], [], [], {}
    for mpath, mod in skeleton.named_modules():
        leaves = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in leaves:
            full = f"{mpath}.{pname}" if mpath else pname
            if not t.is_floating_point():
                ints[full] = torch.zeros(t.shape, dtype=t.dtype, device=device)
                continue
            mean, std = old_rule(mod, pname, t)
            spec_ = cfg.get("weights", {}).get(full, {})
            names.append(full)
            shapes.append(t.shape)
            means.append(float(spec_.get("mean", mean)))
            stds.append(float(spec_.get("std", std)))
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=system.generator(seed, system.WEIGHTS, device),
                       device=device)
    parts = list(flat.split(sizes))
    torch._foreach_mul_(parts, stds)
    torch._foreach_add_(parts, means)
    state = {n: p.view(s) for n, p, s in zip(names, parts, shapes)}
    state.update(ints)
    return state


@pytest.mark.parametrize("workload", CELLS)
def test_weight_table_unchanged(workload):
    """The real configuration files, on the meta device: every leaf keeps
    its name, shape, order, mean and standard deviation, so a seed draws
    the same tensors."""
    cfg = spec.load(run.ROOT, workload).config
    with torch.device("meta"):
        skeleton = reference.SOccDPTV3(cfg)
    want = []
    for mpath, mod in skeleton.named_modules():
        for pname, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t.is_floating_point():
                full = f"{mpath}.{pname}" if mpath else pname
                mean, std = old_rule(mod, pname, t)
                over = cfg.get("weights", {}).get(full, {})
                want.append((full, t.shape, over.get("mean", mean), over.get("std", std)))
    table, _ = system.weight_table(cfg)
    assert table == want


@pytest.mark.parametrize("workload", CELLS)
def test_make_weights_bit_for_bit(workload):
    """A test-sized copy of each cell (the CPU is too slow for BEiT-L):
    the same tensors, bit for bit, as the old rule table draws."""
    cfg = shrink(spec.load(run.ROOT, workload)).config
    got = system.make_weights(cfg, SEED, "cpu")
    want = old_make_weights(cfg, SEED, "cpu")
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("workload", CELLS)
def test_request_flops_unchanged(workload):
    cell = spec.load(run.ROOT, workload)
    assert flops.request_flops(cell.config, cell.traffic["batch"]) == FLOPS[workload]


class ToyTrunk(nn.Module):
    """Four maps at 1/4 to 1/32 of the image: a patch conv, a GroupNorm,
    average pooling."""

    def __init__(self, bcfg: dict, input_size):
        super().__init__()
        c = bcfg["width"]
        self.channels = (c, c, c, c)
        self.stem = nn.Conv2d(3, c, 4, stride=4)
        self.norm = nn.GroupNorm(2, c)

    def forward(self, x):
        h = L.conv(self.stem, x).permute(0, 3, 1, 2)
        h = F.group_norm(h.float(), 2, self.norm.weight, self.norm.bias).to(x.dtype)
        outs = [h]
        for _ in range(3):
            outs.append(F.avg_pool2d(outs[-1], 2))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


def toy_weight_rule(mod, name, t):
    return (0.5, 0.0) if isinstance(mod, nn.GroupNorm) and name == "bias" else None


def toy_k6_calls(cfg, batch):
    return [(batch, 2, 17, 4, 0)] * 3


TOY_TINY = ("dpt_toy_test_64", ("toytest_64", 64, 64), {"family": "toy", "width": 8})


@pytest.fixture
def toy_cfg(monkeypatch):
    """The backlog cell on a toy trunk, shrunk by the toy's own ``TINY``."""
    toy = types.ModuleType("benchmark.reference.toy")
    toy.TRUNK, toy.weight_rule, toy.k6_calls = ToyTrunk, toy_weight_rule, toy_k6_calls
    toy.TINY = TOY_TINY
    monkeypatch.setitem(sys.modules, "benchmark.reference.toy", toy)
    cell = spec.load(run.ROOT, CELLS[1])
    cell.config["backbone"] = {"family": "toy", "width": 64}
    return shrink(cell).config


def test_family_module_sizes_its_tests(toy_cfg):
    """The CPU tests' shrunk cell takes its trunk from the family module."""
    assert toy_cfg["model_type"] == TOY_TINY[0] and toy_cfg["backbone"] == TOY_TINY[2]
    assert toy_cfg["backbone"] is not TOY_TINY[2]  # a copy: a test's edit stays its own


def test_family_without_tiny_cannot_shrink(monkeypatch):
    bare = types.ModuleType("benchmark.reference.bare")
    bare.TRUNK = ToyTrunk
    monkeypatch.setitem(sys.modules, "benchmark.reference.bare", bare)
    cell = spec.load(run.ROOT, CELLS[1])
    cell.config["backbone"] = {"family": "bare"}
    with pytest.raises(AttributeError, match="benchmark.reference.bare gives no TINY"):
        shrink(cell)


def test_family_that_is_only_a_module(toy_cfg):
    cfg = toy_cfg
    assert reference.trunk_module(cfg) is sys.modules["benchmark.reference.toy"]
    state = system.make_weights(cfg, SEED, "cpu")
    scale, shift = state["depth_net.backbone.norm.weight"], state["depth_net.backbone.norm.bias"]
    assert ((scale - 1.0).abs() < 0.25).all() and scale.std() > 0  # the shared norm rule
    assert torch.equal(shift, torch.full_like(shift, 0.5))  # the family's own rule
    model = reference.build(cfg, state, "cpu")
    frames = system.frames(SEED, 1, 2, cfg, "cpu")[0]
    inv, seg, points, grid = reference.serve(model, frames, cfg)
    cam = cfg["camera"]
    assert inv.shape == (2, cam["height"], cam["width"]) and torch.isfinite(points).all()
    assert flops.request_flops(cfg, 2) > 0

    trace = types.SimpleNamespace(kernel_seconds=lambda name: (
        (1e-3, 6) if name == "global_attention_kernel" else (1e-3, 4)))
    r = types.SimpleNamespace(trace=trace, config=cfg, batch=2)
    least = 3 * work.bound(4 * 2 * 2 * 17 * 4 * 2, 4 * 2 * 2 * 17 * 17 * 4)[0]  # no bias
    assert spec.reader("k6_roofline")(r) == pytest.approx(100.0 * least * (6 / 3) / 1e-3)
    assert spec.reader("k1_roofline")(r) is None  # the family gives no K1 calls


def test_no_harness_file_names_the_toy():
    here = Path(spec.__file__).parent
    files = [p for p in here.rglob("*.py") if "tests" not in p.relative_to(here).parts]
    assert files and not [p for p in files if "toy" in p.read_text()]


@pytest.mark.parametrize("family", ["nosuch", "../swin2"])
def test_unknown_family_names_its_file(family):
    cfg = {"backbone": {"family": family}}
    with pytest.raises(FileNotFoundError, match=re.escape(f"benchmark/reference/{family}.py")):
        reference.trunk_module(cfg)


def test_module_without_trunk(monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.reference.bare", types.ModuleType("bare"))
    with pytest.raises(AttributeError, match="benchmark/reference/bare.py gives no TRUNK"):
        reference.trunk_module({"backbone": {"family": "bare"}})


def test_padded_swin2_serves_as_the_program(tiny, monkeypatch):
    """A Swin-V2 whose window does not divide its stages (a 6-token window
    over a 16-token grid, as Swin-V2-B's 24 over 64 at 256 px): the program
    pads them to whole windows, and the reference, padding alike, agrees
    with it in f32 within the cell's limits."""
    from soccdpt_torch.models.backbones import swin2 as program_swin2

    tiny_cfg = program_swin2.SWIN2_CONFIGS["swin2test_64"]
    monkeypatch.setitem(program_swin2.SWIN2_CONFIGS, "swin2test_64",
                        dataclasses.replace(tiny_cfg, window_size=6))
    cell = tiny(CELLS[1])
    cell.config["compute_dtype"] = "float32"
    cell.config["backbone"]["window_size"] = 6
    calls = swin2.k1_calls(cell.config, 1)
    assert [c[0] for c in calls] == [9, 9, 4, 4, 1, 1, 1, 1] and calls[0][4] == 9
    numbers = {}
    out = run.execute(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(), numbers)
    assert out["correct"] and max(numbers.values()) < 1e-4, numbers


def test_shifted_padded_mask_follows_the_program_rule():
    """Which tokens a window that both pads and shifts masks, by the rule
    of the program and the JAX package that the reference copies: pad,
    roll by -s, then mark rows and columns [res, padded) of the rolled map
    as padding. After the roll the padding lies at [res - s, padded - s),
    so the rule masks where it does not lie. Here res 7, window 4, shift
    2 (padded - res < s, as Swin-V2-B's 8 < 12 at 256 px): in the window
    that holds the original rows 6, 7 (zero padding), 0 and 1 of column 2,
    the real row 6 attends to the padding below it, and the wrapped real
    rows 0 and 1 are kept apart. A swin2 cell whose blocks both pad and
shift (Swin-V2-B at 256, stages 0 and 1) is judged by this rule."""
    m = swin2.shift_mask(7, 4, 2, 8)
    assert m.shape == (4, 16, 16)
    block = swin2.Block(8, 1, 7, 4, True, 0, 1.0)
    assert (block.ws, block.shift, block.padded) == (4, 2, 8)
    # rolled (r, c) holds original ((r + 2) % 8, (c + 2) % 8); window 2 is
    # rolled rows 4-7, columns 0-3; a token's index is 4 * (r - 4) + c
    row6, pad7, row0, row1 = 0, 4, 8, 12  # original rows, column 2
    win = m[2]
    assert win[row6, pad7] == 0.0  # a real token sees a zero pad token
    assert win[row0, row1] == -100.0  # two neighbouring real rows kept apart
    assert win[row6, row0] == -100.0  # the shift's wrap, as every Swin masks it
    assert win[pad7, row1] == -100.0  # the real row 1, not the pad row 7, is marked padding
    # no shift: the padding lies where the rule marks it
    m = swin2.shift_mask(7, 4, 0, 8)
    assert m[0, 0, 3] == 0.0 and m[1, 0, 3] == -100.0  # window 1 is columns 4-7; 7 pads
