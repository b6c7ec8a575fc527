"""The reader of the 1080p geometry tail's roofline share
(``metrics/geometry_roofline.py``) on traces made by hand, and its three
entries in BENCHMARK.json."""
import json
from types import SimpleNamespace

import pytest

from benchmark import run, spec, work
from benchmark.trace import Event, Trace

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
ENTRIES = [m for m in MANIFEST["per_layer"] if m["name"].startswith("geometry_roofline.")]
CFG = {"camera": {"height": 2, "width": 3}}


def _reading(device, batch=2):
    return SimpleNamespace(trace=Trace(device=device), batch=batch, config=CFG)


def test_the_share_of_each_launch_s_bytes_bound():
    read = spec.reader("geometry_roofline.fps")
    device = [Event("void unproject::unproject_slots_kernel<true, true>(...)", 0, 10),
              Event("segment_sum_kernel", 10, 40),
              Event("void unproject::unproject_slots_kernel<true, true>(...)", 50, 70)]
    least = work.bound(2 * 2 * 3 * 20, 0)[0]  # 12 pixels a launch, 20 bytes each
    assert read(_reading(device)) == pytest.approx(100 * least * 2 / 30e-6)
    # the camera's full size: 249 MB a batch-6 launch, 74 us at 3.35 TB/s
    full = SimpleNamespace(trace=Trace(device=[Event("unproject_slots_kernel", 0, 100)]),
                           batch=6, config={"camera": {"height": 1080, "width": 1920}})
    assert read(full) == pytest.approx(100 * 6 * 1080 * 1920 * 20 / 3.35e12 / 100e-6)


@pytest.mark.parametrize("device", [
    [], [Event("segment_sum_kernel", 0, 10)],
    [Event("void at::native::CatArrayBatchedCopy<float>", 0, 10),
     Event("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 10, 20)]],
    ids=["empty", "k2_only", "aten_tail"])
def test_nothing_is_read_without_the_kernel(device):
    assert spec.reader("geometry_roofline.lat")(_reading(device)) is None


@pytest.mark.parametrize("entry", ENTRIES, ids=lambda e: e["name"])
def test_each_entry_names_an_existing_cell_that_reads_it(entry):
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert len(ENTRIES) == 3 and entry["workloads"] and set(entry["workloads"]) <= cells
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"]) == (
        "%", "higher", "device_trace", "ops/geometry.py")
    for workload in entry["workloads"]:
        cell = spec.load(run.ROOT, workload)
        assert entry["moves"] in {m["name"] for m in cell.end_to_end}
        assert entry["name"] in spec.readers(cell)
