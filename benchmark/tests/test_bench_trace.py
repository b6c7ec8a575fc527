"""The reduction of a traced slice, on events made by hand."""
import pytest

from benchmark.trace import Event, Slice, Trace, slices


def make(wall=None):
    return Trace(
        device=[Event("k_a", 0, 40), Event("k_b", 30, 60), Event("Memset (Device)", 70, 75),
                Event("segment_sum_kernel<3>", 75, 90), Event("k_a", 150, 260)],
        host=[Event("cudaGraphLaunch", 100, 140), Event("aten::copy_", 60, 70)],
        wall_s=wall, units=2)


def test_busy_and_window():
    t = make()
    assert t.window == (0, 260)
    assert t.window_s == pytest.approx(260e-6)
    assert make(wall=1e-3).window_s == 1e-3
    # [0, 60] + [70, 90] + [150, 260]
    assert t.busy_s == pytest.approx(190e-6)


def test_kernel_seconds():
    t = make()
    assert t.kernel_seconds("k_a") == (pytest.approx(150e-6), 2)
    assert t.kernel_seconds("segment_sum_kernel") == (pytest.approx(15e-6), 1)


def test_idle_gaps_by_host_call():
    gaps = dict(make().idle_gaps())
    assert gaps == {"aten::copy_": pytest.approx(10e-6), "cudaGraphLaunch": pytest.approx(60e-6)}


def test_top_ops():
    assert make().top_ops(1) == [("k_a", pytest.approx(150e-6))]


def test_slices_follow_each_other():
    dev, host = slices([5, 3, 2], True)
    assert (dev.first, dev.count, dev.host) == (5, 3, False)
    assert (host.first, host.count, host.host) == (8, 2, True)
    off = Slice(0, 1, False)
    assert off.at(0, lambda: None) >= 0 and not off.active and not off.pending


def test_k2_roofline_counts_the_recorded_requests():
    from types import SimpleNamespace

    from benchmark import spec, work

    read = spec.reader("k2_roofline.lat")
    cfg = {"camera": {"height": 2, "width": 3}, "num_classes": 3}
    trace = Trace(device=[Event("segment_sum_kernel", 0, 10), Event("segment_sum_kernel", 20, 30)])
    requests = [(4, 2), (6, 3)]
    least = sum(work.bound(work.k2_bytes(12, k, c, 3), 0)[0] for k, c in requests)
    r = SimpleNamespace(trace=trace, batch=2, config=cfg, k2_requests=requests)
    assert read(r) == pytest.approx(100 * least / 20e-6)
    r.k2_requests = None
    assert read(r) is None
