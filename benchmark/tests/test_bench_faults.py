"""The comparison that decides ``correct``, at tiny width on the CPU: a
sound run of the program (in f32, where it must agree with the reference
to rounding) passes each cell's limits, the timed path broken underneath
fails them, once for each fault the cell can have, and the control (the
reference in fp8, its geometry in bf16, in the program's place) fails
them too."""
import time

import pytest
import torch

from benchmark import check, reference, run, serve, system
from benchmark.reference import precision

SERVING = ["beitl512.rig6.20hz.grid", "swin2t.backlog.b6.grid"]
SEED = 2**31 + 7


def f32(cell):
    cell.config["compute_dtype"] = "float32"
    return cell


def correct(cell):
    """(correct, every number of the comparison) of a short run."""
    numbers = {}
    out = run.execute(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(), numbers)
    return out["correct"], numbers


@pytest.mark.parametrize("workload", SERVING)
def test_sound_run_passes(workload, tiny):
    ok, numbers = correct(f32(tiny(workload)))
    assert ok, numbers


def _scaled(monkeypatch, owner, name, factor):
    original = getattr(owner, name)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        return out * factor

    monkeypatch.setattr(owner, name, wrapped)


def _half_batch_served(monkeypatch):
    from soccdpt_torch.models.soccdpt import SOccDPT_V3

    original = SOccDPT_V3.forward

    def forward(self, x, *args, **kwargs):
        out = original(self, x[: max(x.shape[0] // 2, 1)], *args, **kwargs)
        return tuple(None if t is None else torch.cat([t, t])[: x.shape[0]] for t in out)

    monkeypatch.setattr(SOccDPT_V3, "forward", forward)


def _stale(monkeypatch):
    from soccdpt_torch import serving

    original = serving.make_serving_fn

    def make(*args, **kwargs):
        fn = original(*args, **kwargs)
        first = []

        def stale(frames):
            if not first:
                first.append(fn(frames))
            return first[0]

        stale.device = fn.device
        return stale

    monkeypatch.setattr(serving, "make_serving_fn", make)


def _segment_sum_drops(monkeypatch):
    from soccdpt_torch.ops import geometry

    original = geometry.segment_sum

    def drops(lin, vals, num_slots):
        lin = lin.clone()
        lin[::10] = -1
        return original(lin, vals, num_slots)

    monkeypatch.setattr(geometry, "segment_sum", drops)


SERVE_FAULTS = {
    "depth_altered": lambda mp: _scaled(mp, __import__(
        "soccdpt_torch.models.heads", fromlist=["DepthHead"]).DepthHead, "forward", 1.5),
    "points_altered": lambda mp: _scaled(mp, __import__(
        "soccdpt_torch.ops.geometry", fromlist=["x"]), "unproject_depth", 1.01),
    "grid_rows_dropped": _segment_sum_drops,
    "half_batch": _half_batch_served,
    "stale_outputs": _stale,
}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
@pytest.mark.parametrize("workload", SERVING)
def test_serving_fault_fails(workload, fault, tiny, monkeypatch):
    cell = f32(tiny(workload))
    SERVE_FAULTS[fault](monkeypatch)
    ok, numbers = correct(cell)
    assert not ok, numbers


def _shifted(monkeypatch):
    from soccdpt_torch.models.heads import DepthHead

    original = DepthHead.forward

    def forward(self, *args, **kwargs):
        return original(self, *args, **kwargs) + 0.02

    monkeypatch.setattr(DepthHead, "forward", forward)


@pytest.mark.parametrize("workload", SERVING)
def test_depth_offset_fails_where_compared(workload, tiny, monkeypatch):
    """A constant added to the served inverse depth: only ``depth_shift``
    sees it, and it is compared in the cells whose limits name it."""
    cell = f32(tiny(workload))
    _shifted(monkeypatch)
    ok, numbers = correct(cell)
    assert numbers["depth_shift"] > 0.03, numbers
    assert ok == ("depth_shift" not in check.limits(workload)), numbers


@pytest.mark.parametrize("workload", SERVING)
def test_serving_control_fails(workload, tiny):
    """The reference in fp8 served in the program's place, on the cell's
    sampled requests."""
    cell = tiny(workload)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device("cpu")
    ring = system.frames(SEED, tr["ring"], tr["batch"], cfg, dev)
    model = reference.build(cfg, system.make_weights(cfg, SEED, dev), dev)
    with precision.precision("fp8"):
        outs = [reference.serve(model, ring[0][f:f + 1], cfg) for f in range(tr["batch"])]
    kept = {0: (0, [torch.cat(parts) for parts in zip(*outs)])}
    numbers = serve.compare(cell, SEED, kept, ring, dev)
    ok, _ = check.decide(numbers, check.limits(workload))
    assert not ok, numbers
