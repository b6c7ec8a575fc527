"""The served request as a CUDA graph, on the card: graph against eager,
outputs the caller owns, a weight load never served stale, ``serve_stream``
against sequential serving, a second serving fn that keeps the first's
graphs, a request after ``model.train()`` served as before it, the
ViT-hybrid served on the card against the CPU's plain versions, and a
capture that fails.

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
5e-3 m on points, under 1 % of the grid's mass mismatched.
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.core.config import MODEL_TYPES, CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.kernels.global_attention import global_attention
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import GraphedFunction, make_serving_fn, serve_stream

pytestmark = pytest.mark.gpu

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
GRID_TOL = 1e-5
MODEL_TYPES.setdefault("dpt_hybridtest_64", ("hybridtest_64", 64, 64))


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
        before = global_attention.launches
        eager = make_serving_fn(cfg, model, compute_occ=compute_occ, graph=False)(f)
        assert global_attention.launches - before == 2
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
