"""The port's span recorder (``soccdpt_torch/utils/spans.py``) and the
spans of the served path on the CPU: nothing recorded while off, nested
spans in order, spans from other threads all kept, ``snapshot()`` on
``torch.profiler``'s clock, one ``stream.stage`` a frame of
``serve_stream`` and one ``serve.call`` a request of an eager serving fn.

The clock is held to 1 ms: a ``record_function`` entered inside a span
must lie inside it once both are on the profiler's axis, and the host
work between them is a few microseconds. The graph's spans and the
card's side of the clock are in tests/test_torch_serving_gpu.py.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.data.loader import prefetch
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import make_serving_fn, serve_stream
from soccdpt_torch.utils import spans
from soccdpt_torch.utils.spans import span

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
CLOCK_NS = 1_000_000


@pytest.fixture(autouse=True)
def fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC),
                      model_type="dpt_swin2_test_64", version=3, features=64)
    model = build_model(cfg, device="cpu", seed=0)
    frames = [np.random.default_rng(i).integers(0, 256, (1, 48, 64, 3), dtype=np.uint8)
              for i in range(3)]
    return cfg, model, frames


def test_spans_off_record_nothing():
    assert span("a") is span("b")  # one shared context: nothing allocated
    with span("a"):
        with span("b"):
            pass
    assert spans.snapshot() == {}


def test_nested_spans_come_out_in_order_and_disable_and_clear_work():
    spans.enable()
    for _ in range(2):
        with span("outer"):
            with span("inner"):
                time.sleep(1e-4)
    spans.disable()
    with span("outer"):
        pass
    got = spans.snapshot()
    assert sorted(got) == ["inner", "outer"]
    assert len(got["outer"]) == len(got["inner"]) == 2
    for (o0, o1), (i0, i1) in zip(got["outer"], got["inner"]):
        assert o0 <= i0 <= i1 <= o1
        assert i1 - i0 >= 100_000
    assert got["outer"][0][1] <= got["outer"][1][0]
    spans.clear()
    assert spans.snapshot() == {}


def test_spans_from_other_threads_all_arrive():
    """A source pulled by ``prefetch``'s worker thread, then more threads
    than cores racing on one name with a short switch interval: a lost
    append would leave a count short."""
    spans.enable()

    def source(n):
        for i in range(n):
            with span("source"):
                yield i

    assert list(prefetch(source(50), size=2)) == list(range(50))
    assert len(spans.snapshot()["source"]) == 50

    workers, each = 2 * (os.cpu_count() or 2) + 1, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("race"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    race = spans.snapshot()["race"]
    assert len(race) == workers * each
    assert all(a <= b for a, b in race)


def test_snapshot_lies_on_the_profiler_clock():
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with span("outer"):
            with record_function("inner"):
                time.sleep(2e-3)
    (s0, s1), = spans.snapshot()["outer"]
    start = prof.profiler.kineto_results.trace_start_ns()
    inner = [e for e in prof.events() if e.name == "inner"]
    assert len(inner) == 1
    e0 = start + int(inner[0].time_range.start * 1e3)
    e1 = start + int(inner[0].time_range.end * 1e3)
    assert s0 - CLOCK_NS <= e0 <= e1 <= s1 + CLOCK_NS
    assert abs(e0 - s0) <= CLOCK_NS and abs(s1 - e1) <= CLOCK_NS


def test_serve_stream_records_one_stage_a_frame(tiny):
    cfg, model, frames = tiny
    serve = make_serving_fn(cfg, model, compute_occ=True, device="cpu")
    spans.enable()
    outs = list(serve_stream(serve, frames, depth=2))
    got = spans.snapshot()
    assert len(outs) == len(got["stream.stage"]) == len(got["serve.call"]) == len(frames)
    assert all(a <= b for a, b in got["stream.stage"])


def test_an_eager_serving_fn_records_one_call_a_request(tiny):
    cfg, model, frames = tiny
    serve = make_serving_fn(cfg, model, device="cpu", graph=False)
    serve(frames[0])
    spans.enable()
    for f in frames:
        serve(torch.from_numpy(f))
    got = spans.snapshot()
    assert list(got) == ["serve.call"] and len(got["serve.call"]) == len(frames)
