"""The ``vit_hybrid`` family's cell, ``hybrid384.backlog.b6.grid``: the
shrunk cell end to end on the CPU, its K6 calls against the program's, the
GroupNorm reader on traces made by hand, and the real configuration's
operation count on the meta device."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import flops, reference, run, spec, work
from benchmark.reference import vit_hybrid
from benchmark.trace import Event, Trace

CELL = "hybrid384.backlog.b6.grid"
SEED = 2**31 + 2**30 + 5


def test_shrunk_cell_runs_and_is_correct(tiny):
    """The cell at the test trunk's sizes through the harness, traced: in
    f32 (the cell's limits are set for bf16 at its real widths) correct,
    every number within 1e-4 of the reference; every reading of the
    hybrid's per-layer metrics that a CPU profile can give, given."""
    cell = tiny(CELL)
    assert cell.config["backbone"]["family"] == "vit_hybrid"
    cell.config["compute_dtype"] = "float32"
    numbers = {}
    out = run.execute(cell, SEED, 0.5, True, torch.device("cpu"), time.perf_counter(), numbers)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert max(numbers.values()) < 1e-4, numbers
    assert set(out["checks"]) == {"depth_err", "points_err", "grid_err"}
    assert "serve_call_ms.hyb" in out["metrics"]
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}


def test_k6_calls_match_the_program(tiny, monkeypatch):
    """The K6 calls the program makes in a forward recorded on the CPU,
    shape by shape, and twelve (6, 12, 577, 64) without a bias for the
    real configuration at batch 6."""
    from soccdpt_torch.models.backbones import vit as program_vit

    real = spec.load(run.ROOT, CELL).config  # before the fixture shrinks what loads
    cfg = tiny(CELL).config
    calls, attend = [], program_vit.global_attention

    def record(q, k, v, bias=None, scale=1.0):
        calls.append((*q.shape, 0 if bias is None else bias.element_size()))
        return attend(q, k, v, bias, scale)

    monkeypatch.setattr(program_vit, "global_attention", record)
    from benchmark import system

    model = system.program_model(cfg, system.make_weights(cfg, SEED, "cpu"), "cpu").eval()
    with torch.no_grad():
        model.depth_net.backbone(torch.zeros(3, 64, 64, 3, dtype=torch.bfloat16))
    assert calls == reference.kernel_calls(cfg, "k6", 3) == [(3, 2, 17, 16, 0)] * 2
    assert vit_hybrid.k6_calls(real, 6) == [(6, 12, 577, 64, 0)] * 12
    assert reference.kernel_calls(real, "k1", 6) is None


def test_k6_roofline_reads_the_bias_free_calls():
    cfg = spec.load(run.ROOT, CELL).config
    seconds, launches = 0.02, 24
    per = seconds / launches * 1e6
    trace = Trace(device=[Event("wgattn::global_attention_kernel<64>", i * per, (i + 1) * per)
                          for i in range(launches)])
    r = SimpleNamespace(trace=trace, config=cfg, batch=6)
    least = work.bound(4 * 6 * 12 * 577 * 64 * 2, 4 * 6 * 12 * 577 * 577 * 64)[0]
    assert spec.reader("k6_roofline.hyb")(r) == pytest.approx(100.0 * least * 24 / seconds)


def _groupnorm_trace():
    return Trace(device=[
        Event("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long, "
              "float, float const*, float*, float*)", 0, 10),
        Event("void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>(...)",
              10, 12),
        Event("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native"
              "::(anonymous namespace)::GroupNormKernelImplInternal<float>(...)::{lambda(float, "
              "float, float)#1}>(...)", 12, 30),
        Event("soccdpt_group_norm_nhwc_kernel", 40, 45),
        Event("void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda(...)>", 30, 40),
        Event("wgattn::global_attention_kernel", 50, 90),
    ], units=2)


def test_groupnorm_ms_reads_the_groupnorm_kernels():
    r = SimpleNamespace(trace=_groupnorm_trace(), units=2)
    # 10 + 2 + 18 + 5 us over two requests; the copy and the attention left out
    assert spec.reader("groupnorm_ms.hyb")(r) == pytest.approx(35e-3 / 2)


def test_groupnorm_ms_reads_nothing_without_a_match():
    trace = Trace(device=[Event("wgattn::global_attention_kernel", 0, 10)], units=2)
    assert spec.reader("groupnorm_ms.hyb")(SimpleNamespace(trace=trace, units=2)) is None
    assert spec.reader("groupnorm_ms.hyb")(SimpleNamespace(trace=Trace(), units=0)) is None


def test_request_flops_real_configuration():
    cfg = spec.load(run.ROOT, CELL).config
    n = flops.request_flops(cfg, 6)
    assert 0 < n < float("inf")
    # the ViT alone: twelve blocks of qkv, attention, proj and MLP at T = 577
    T, C = 577, 768
    vit = 12 * 6 * 2 * (T * C * 3 * C + 2 * T * T * C + T * C * C + 2 * T * C * 4 * C)
    assert n > vit
