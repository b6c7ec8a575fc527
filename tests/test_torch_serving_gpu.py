"""The served request as a CUDA graph, on the card: graph against eager,
outputs the caller owns, a weight load never served stale, ``serve_stream``
against sequential serving, a second serving fn that keeps the first's
graphs, and a capture that fails.

Every test here carries the ``gpu`` marker and skips without a card. This
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_gpu.py

Tiny setup of tests/test_torch_serving.py (``dpt_swin2_test_64``, a 48x64
camera, a 16x16x8 grid), f32, weights from numpy seeds. A graph replays
the kernels its capture recorded on the same inputs, so inverse depth,
segmentation and points equal the eager request's bit for bit; the grid
is held to K2's bound, rtol = atol = 1e-5 (tests/test_sorted_segment_sum.py:
its atomics add in an order the card chooses on every run).
"""
import numpy as np
import pytest
import torch

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import GraphedFunction, make_serving_fn, serve_stream

pytestmark = pytest.mark.gpu

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
GRID_TOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the served graph has no CPU mode")
    return torch.device("cuda")


def tiny_model(card, seed):
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC),
                      model_type="dpt_swin2_test_64", version=3, features=64)
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
