"""The served request as a CUDA graph, on the card: graph against eager,
outputs the caller owns, a weight load never served stale, ``serve_stream``
against sequential serving, a second serving fn that keeps the first's
graphs, a request after ``model.train()`` served as before it, the
ViT-hybrid and the Swin-V1, LeViT and Next-ViT test configs served on the
card against the CPU's plain versions, a request's spans
(``utils/spans.py``) and a kernel inside a span on the profiler's clock,
and a capture that fails.

Every test here carries the ``gpu`` marker and skips without a card. This
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_gpu.py

Tiny setup of tests/test_torch_serving.py (``dpt_swin2_test_64``, a 48x64
camera, a 16x16x8 grid), f32, weights from numpy seeds. A graph replays
the kernels its capture recorded on the same inputs, so inverse depth,
segmentation and points equal the eager request's bit for bit; the grid
is held to K2's bound, rtol = atol = 1e-5 (tests/test_sorted_segment_sum.py:
its atomics add in an order the card chooses on every run). The hybrid on
the card in f32 (TF32 off) is held to the CPU on the ladder of
tests/test_composition_oracle.py: 1e-4 on inverse depth and segmentation,
5e-3 m on points, under 1 % of the grid's mass mismatched; so are the
last three families.
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels import ops
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import GraphedFunction, make_serving_fn, serve_stream
from soccdpt_torch.utils import spans
from soccdpt_torch.utils.spans import span

pytestmark = pytest.mark.gpu

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
GRID_TOL = 1e-5
for _name, _backbone in (("dpt_hybridtest_64", "hybridtest_64"),
                         ("dpt_swin1test_64", "swin1test_64"),
                         ("dpt_levittest_64", "levittest_64"),
                         ("dpt_nextvittest_64", "nextvittest_64")):
    MODEL_TYPES.setdefault(_name, (_backbone, 64, 64))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the served graph has no CPU mode")
    return torch.device("cuda")


def tiny_model(card, seed, version=3, model_type="dpt_swin2_test_64"):
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC),
                      model_type=model_type, version=version, features=64)
    model = build_model(cfg, device=card, seed=seed)
    with torch.no_grad():  # inverse depth near 0.3, so points land in the grid
        model.depth_net.head.conv3.weight.mul_(0.01)
        model.depth_net.head.conv3.bias.fill_(0.3)
    return cfg, model


def frames(batch, seed):
    return np.random.default_rng(seed).integers(0, 256, (batch, 48, 64, 3), dtype=np.uint8)


def assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w, name in zip(got[:3], want[:3], ("inv_depth", "seg", "points")):
        assert torch.equal(g, w), name
    if want[3] is None:
        assert got[3] is None
    else:
        torch.testing.assert_close(got[3], want[3], rtol=GRID_TOL, atol=GRID_TOL)
        assert float(want[3].sum()) > 0


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("compute_occ", [False, True])
def test_graph_outputs_equal_eager_outputs(card, batch, compute_occ):
    cfg, model = tiny_model(card, 0)
    eager = make_serving_fn(cfg, model, compute_occ=compute_occ, graph=False)
    graph = make_serving_fn(cfg, model, compute_occ=compute_occ)
    assert isinstance(graph, GraphedFunction)
    for seed in range(3):
        f = frames(batch, seed)
        assert_same(graph(f), eager(f))
    (cap,) = graph.graphs.values()
    assert cap.replays == 3 and graph.recaptures == 0


def test_a_graph_output_survives_the_next_request(card):
    cfg, model = tiny_model(card, 0)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    first = serve(frames(1, 1))
    kept = [t.clone() for t in first]
    second = serve(frames(1, 2))
    for t, k in zip(first, kept):
        assert torch.equal(t, k)
    assert not torch.equal(first[0], second[0])
    assert first[0].data_ptr() != second[0].data_ptr()


def test_a_weight_load_recaptures_and_serves_the_new_weights(card):
    cfg, model = tiny_model(card, 0)
    _, other = tiny_model(card, 5)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    f = frames(1, 3)
    before = serve(f)
    model.load_state_dict(other.state_dict())
    after = serve(f)
    assert serve.recaptures == 1
    assert not torch.equal(before[0], after[0])
    assert_same(after, make_serving_fn(cfg, other, compute_occ=True)(f))


@pytest.mark.parametrize("second_graph", [False, True])
def test_binding_a_second_serving_fn_keeps_the_first_s_graphs(card, second_graph):
    """A second serving fn bound to the model after the first one's graph
    was captured leaves the folded biases in place: the first one's next
    request replays its graph, no recapture."""
    cfg, model = tiny_model(card, 0)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    f = frames(1, 4)
    first = serve(f)
    other = make_serving_fn(cfg, model, compute_occ=False, graph=second_graph)
    other(f)
    again = serve(f)
    assert serve.recaptures == 0
    (cap,) = serve.graphs.values()
    assert cap.replays == 2
    assert_same(again, first)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serve_stream_equals_sequential_serving(card, depth):
    cfg, model = tiny_model(card, 0)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    stream = [frames(1, 10 + i) for i in range(6)]
    got = list(serve_stream(serve, iter(stream), depth=depth))
    assert len(got) == len(stream)
    for f, g in zip(stream, got):
        assert_same(g, serve(f))


@pytest.mark.parametrize("version", [1, 3])
def test_a_graph_request_after_train_is_served_in_eval_mode(card, version):
    """The graph was captured in eval mode; after ``model.train()`` the next
    request replays it (no recapture) and gives bit for bit what it gave,
    V1's BatchNorm statistics stay as they were, and the model is left in
    training mode."""
    cfg, model = tiny_model(card, 0, version)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    f = frames(2, 6)
    before = serve(f)
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    assert stats
    model.train()
    after = serve(f)
    assert_same(after, before)
    assert serve.recaptures == 0
    for n, b in model.named_buffers():
        if n in stats:
            assert torch.equal(b, stats[n]), n
    assert all(m.training for m in model.modules())
    eager = make_serving_fn(cfg, model, compute_occ=True, graph=False)  # binds in eval mode
    model.train()
    assert_same(eager(f), before)
    assert all(m.training for m in model.modules())


@pytest.mark.parametrize("compute_occ", [False, True])
def test_hybrid_served_on_the_card_matches_the_cpu(card, compute_occ):
    """``dpt_hybridtest_64`` (two ViT blocks, K6 in each) served through a
    graph in f32 against the same weights served on the CPU through the
    plain versions; eager on the card launches K6 twice a request."""
    cfg, model = tiny_model(card, 0, model_type="dpt_hybridtest_64")
    f = frames(2, 7)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = make_serving_fn(cfg, model, compute_occ=compute_occ)(f)
        before = ops.launches()["global_attention"]
        eager = make_serving_fn(cfg, model, compute_occ=compute_occ, graph=False)(f)
        assert ops.launches()["global_attention"] - before == 2
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert_same(got, eager)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = make_serving_fn(cfg, cpu, compute_occ=compute_occ, device="cpu")(f)
    for g, w, atol, name in zip(got[:3], want[:3], (1e-4, 1e-4, 5e-3),
                                ("inv_depth", "seg", "points")):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=atol, msg=name)
    if compute_occ:
        total = float(want[3].sum())
        assert total > 0
        assert float((got[3].cpu() - want[3]).abs().sum()) / total < 0.01


@pytest.mark.parametrize("model_type", ["dpt_swin1test_64", "dpt_levittest_64",
                                        "dpt_nextvittest_64"])
def test_last_three_families_served_on_the_card_match_the_cpu(card, model_type):
    """The Swin-V1, LeViT and Next-ViT test configs, V3 with the grid,
    through a graph in f32: equal to the eager request, and held to the
    same weights served on the CPU on the ladder; K2 once a request.
    With cuDNN's deterministic algorithms: without them two eager runs of
    the LeViT request in f32 differ in the last bit (3e-8 in inverse
    depth), so no graph could equal one of them."""
    cfg, model = tiny_model(card, 0, model_type=model_type)
    f = frames(2, 7)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        got = make_serving_fn(cfg, model, compute_occ=True)(f)
        before = ops.launches()["segment_sum"]
        eager = make_serving_fn(cfg, model, compute_occ=True, graph=False)(f)
        assert ops.launches()["segment_sum"] - before == 1
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = deterministic
    assert_same(got, eager)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = make_serving_fn(cfg, cpu, compute_occ=True, device="cpu")(f)
    for g, w, atol, name in zip(got[:3], want[:3], (1e-4, 1e-4, 5e-3),
                                ("inv_depth", "seg", "points")):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=atol, msg=name)
    total = float(want[3].sum())
    assert total > 0
    assert float((got[3].cpu() - want[3]).abs().sum()) / total < 0.01


def test_a_graph_request_records_its_spans_inside_its_call(card):
    """One request after the capture: ``serve.check``, ``serve.stage`` and
    ``serve.launch`` once each, in that order, inside one ``serve.call``."""
    cfg, model = tiny_model(card, 0)
    serve = make_serving_fn(cfg, model, compute_occ=True)
    serve(frames(2, 7))
    spans.clear()
    spans.enable()
    try:
        serve(torch.from_numpy(frames(2, 8)).pin_memory())
    finally:
        spans.disable()
    got = spans.snapshot()
    spans.clear()
    assert sorted(got) == ["serve.call", "serve.check", "serve.launch", "serve.stage"]
    assert all(len(v) == 1 for v in got.values())
    (c0, c1), = got["serve.call"]
    inner = [got[name][0] for name in ("serve.check", "serve.stage", "serve.launch")]
    assert c0 <= inner[0][0] and inner[-1][1] <= c1
    for (a0, a1), (b0, b1) in zip(inner, inner[1:]):
        assert a0 <= a1 <= b0 <= b1


def test_a_kernel_inside_a_span_lies_within_it_on_the_profiler_clock(card):
    """``torch.cuda._sleep`` launched and waited for inside a span, five
    times, under a profiler that records the card alone: on the shared
    clock each kernel lies inside its span, give or take 50 us, and at each
    end the closest of the five lies within 50 us of the span's (a launch
    and a synchronize apart). The host can only widen a span: a thread
    that the machine schedules away late widens one by a millisecond now
    and then, which an offset of the clock would not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    spans.clear()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(5):
                with span("sleep"):
                    torch.cuda._sleep(2_000_000)
                    torch.cuda.synchronize()
    finally:
        spans.disable()
    got = spans.snapshot()["sleep"]
    spans.clear()
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and "spin" in e.name and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
    assert len(kernels) == 6, [e.name for e in prof.events()]
    after, before = [], []
    for (s0, s1), e in zip(got, kernels[1:]):
        after.append((start + e.time_range.start * 1e3 - s0) / 1e3)
        before.append((s1 - start - e.time_range.end * 1e3) / 1e3)
    print("kernel starts after its span (us):", [round(a, 1) for a in after],
          "ends before its span (us):", [round(b, 1) for b in before])
    assert min(after) >= -50 and min(before) >= -50
    assert min(after) <= 50 and min(before) <= 50


def test_a_capture_that_fails_raises(card):
    """A host sync inside the request cannot be captured: the call raises,
    and nothing falls back to an eager request. Last in the file, after the
    failed capture nothing else runs here."""
    _, model = tiny_model(card, 0)

    def syncs(x):
        return (x * float(x.float().mean()),)

    fn = GraphedFunction(syncs, model, card)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the request failed"):
        fn(torch.ones(4, device=card))
    assert not fn.graphs
    torch.cuda.synchronize()  # the card is still usable
