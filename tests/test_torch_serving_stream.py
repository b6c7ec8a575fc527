"""Pipelined serving and its feeders: the port's ``serve_stream``,
``prefetch`` and ``device_prefetch`` against the port's own ``serve()``
and against the JAX package's ``serve_stream``, on the CPU.

Tiny setup of tests/test_torch_serving.py (``dpt_swin2_test_64``, a
48x64 camera, a 16x16x8 grid), f32, one weight set carried by
``load_jax_variables``. Against the port's ``serve()`` the streamed
outputs are equal bit for bit (the same calls on the same frames);
against JAX they sit on that file's ladder: atol 1e-4 on inv_depth and
seg, 5e-3 m on points, under 1 % of the grid's mass mismatched.
"""
import copy
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soccdpt_tpu.core.config import CameraConfig as JaxCamera
from soccdpt_tpu.core.config import ModelConfig as JaxModelConfig
from soccdpt_tpu.core.config import OccupancyConfig as JaxOcc
from soccdpt_tpu.data.loader import device_prefetch as jax_device_prefetch
from soccdpt_tpu.models.soccdpt import build_model as jax_build_model
from soccdpt_tpu.serving import make_serving_fn as jax_make_serving_fn
from soccdpt_tpu.serving import serve_stream as jax_serve_stream

from soccdpt_torch.core.config import CameraConfig, ModelConfig, OccupancyConfig
from soccdpt_torch.data.loader import DeviceCopy, device_prefetch, pinned_put, prefetch
from soccdpt_torch.models.soccdpt import build_model
from soccdpt_torch.serving import _Weights, make_serving_fn, serve_stream
from soccdpt_torch.weights import load_jax_variables

from test_torch_modules import perturbed_variables

CAM = dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48)
OCC = dict(grid_size=(16, 16, 8), pc_scale=(1.0, 1.0, 1.0), pc_shift=(2.0, 2.0, 0.0),
           correction_angle=(0.0, 0.0, 0.0))
TINY = dict(model_type="dpt_swin2_test_64", version=3, features=64)
N_FRAMES = 5
ATOL = {"inv_depth": 1e-4, "seg": 1e-4, "points": 5e-3}


@pytest.fixture(scope="module")
def stacks():
    jcfg = JaxModelConfig(camera=JaxCamera(**CAM), occupancy=JaxOcc(**OCC), **TINY)
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)), return_raw=True)
    variables = perturbed_variables(variables, 0)
    head = variables["params"]["depth_net"]["head"]["conv3"]  # inv_depth near 0.3
    head["kernel"] = head["kernel"] * 0.002
    head["bias"] = np.full_like(head["bias"], 0.3)
    model = load_jax_variables(build_model(cfg, device="cpu"), variables)
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (1, 48, 64, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    return jcfg, cfg, variables, model, frames


@pytest.fixture(scope="module")
def jax_streamed(stacks):
    """The JAX package's ``serve_stream`` over the frames, with the grid."""
    jcfg, _, variables, _, frames = stacks
    serve = jax_make_serving_fn(jcfg, variables, compute_occ=True)
    return [jax.tree_util.tree_map(np.asarray, out)
            for out in jax_serve_stream(serve, iter(frames), depth=2)]


@pytest.mark.parametrize("host_prefetch", [2, None])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serve_stream_matches_serve_frame_by_frame(stacks, depth, host_prefetch):
    _, cfg, _, model, frames = stacks
    serve = make_serving_fn(cfg, model, compute_occ=True, device="cpu", graph=False)
    streamed = list(serve_stream(serve, iter(frames), depth=depth, host_prefetch=host_prefetch))
    assert len(streamed) == N_FRAMES
    for frame, got in zip(frames, streamed):
        want = serve(frame)
        assert len(got) == 4
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serve_stream_matches_jax_serve_stream(stacks, jax_streamed, depth):
    _, cfg, _, model, frames = stacks
    serve = make_serving_fn(cfg, model, compute_occ=True, device="cpu")
    streamed = list(serve_stream(serve, iter(frames), depth=depth))
    assert len(streamed) == len(jax_streamed) == N_FRAMES
    for got, want in zip(streamed, jax_streamed):
        for g, w, name in zip(got[:3], want[:3], ATOL):
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL[name], err_msg=name)
        grid, wgrid = got[3].numpy(), want[3]
        assert grid.shape == (1, 16, 16, 8, 3)
        assert wgrid.sum() > 10.0, "degenerate fixture: the grid is empty"
        assert np.abs(grid - wgrid).sum() / wgrid.sum() < 0.01


def test_make_serving_fn_asks_a_card_for_graphs(stacks):
    _, cfg, _, model, _ = stacks
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        make_serving_fn(cfg, model, device="cpu", graph=True)
    assert make_serving_fn(cfg, model, device="cpu").device == torch.device("cpu")


def _swap_head_conv(model):
    head = model.depth_net.head
    head.conv3 = copy.deepcopy(head.conv3)


def _replace_parameter(model):
    conv = model.depth_net.head.conv3
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())


def _replace_data(model):
    conv = model.depth_net.head.conv3
    conv.weight.data = conv.weight.data.clone()


WEIGHT_CHANGES = {
    "nothing": lambda model: None,
    "load_state_dict": lambda model: model.load_state_dict(model.state_dict()),
    "data": _replace_data,
    "parameter": _replace_parameter,
    "submodule": _swap_head_conv,
}


@pytest.mark.parametrize("change", sorted(WEIGHT_CHANGES))
def test_the_graph_weight_check_sees_every_change(change):
    """What ``GraphedFunction`` checks before each replay: a load (even of
    equal values), a new storage, a new parameter and a new submodule each
    read as changed, and the snapshot after the change reads as current."""
    cfg = ModelConfig(camera=CameraConfig(**CAM), occupancy=OccupancyConfig(**OCC), **TINY)
    model = build_model(cfg, device="cpu")
    weights = _Weights(model)
    assert weights.current()
    WEIGHT_CHANGES[change](model)
    assert weights.current() == (change == "nothing")
    weights.snapshot()
    assert weights.current()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_order_and_passthrough(depth):
    """As the JAX package's (tests/test_training.py), and when an item is
    yielded the puts of the ``depth - 1`` after it have started."""
    calls, seen = [], []

    def put(x):
        calls.append(x)
        return x * 10

    for y in device_prefetch(iter([1, 2, 3, 4]), put, depth=depth):
        seen.append((y, len(calls)))
    assert [y for y, _ in seen] == [10, 20, 30, 40]
    assert calls == [1, 2, 3, 4]
    assert [n for _, n in seen] == [min(i + depth - 1, 4) for i in range(1, 5)]
    assert list(jax_device_prefetch(iter([1, 2, 3, 4]), lambda x: x * 10, depth)) == [
        10, 20, 30, 40]


def test_prefetch_yields_in_order_ahead_of_a_slow_consumer():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield i

    out = []
    for item in prefetch(source(), size=2):
        time.sleep(0.05)
        out.append((item, len(pulled)))
    assert [i for i, _ in out] == list(range(6))
    assert out[0][1] >= 2  # the thread ran ahead while the consumer slept


def test_prefetch_raises_the_source_s_exception_after_its_items():
    """A departure from the JAX package, whose prefetch ends the stream
    silently when the source raises (ROADMAP.md, queue 3)."""

    def source():
        yield 1
        yield 2
        raise OSError("frame source lost")

    got = []
    with pytest.raises(OSError, match="frame source lost"):
        for item in prefetch(source(), size=1):
            got.append(item)
    assert got == [1, 2]


def test_prefetch_under_thread_switching_stress():
    """Many items through a small queue while the interpreter switches
    threads every microsecond: none lost, none repeated, in order."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = []
        done = threading.Event()

        def consume():
            out.extend(prefetch(iter(range(5000)), size=3))
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=60)
        assert done.is_set() and not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(5000))


def test_pinned_put_on_the_cpu_moves_without_an_event():
    put = pinned_put("cpu")
    frame = np.arange(24, dtype=np.uint8).reshape(1, 2, 4, 3)
    staged = put(frame)
    assert isinstance(staged, DeviceCopy) and staged.event is None
    got = staged.result()
    assert got.device == torch.device("cpu") and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), frame)
