"""End-to-end serving: raw camera frames -> depth, segmentation, points
and the occupancy grid (the port of ``soccdpt_tpu/serving.py``).

One call preprocesses uint8 frames on the device, runs the network and
the geometry tail, and returns outputs at camera resolution. The
network runs in bf16 when ``cfg.compute_dtype == "bfloat16"``.

On a card the request is one CUDA graph, the counterpart of the JAX
package's ``jit=True``: the first request of each input shape (batch
size) runs once eagerly on a side stream, then is captured from the
uint8 frame in a static device buffer to the four outputs; every later
request of that shape copies its frames into the buffer and replays the
graph, one launch from the host. Weights are checked before each replay
and a change is never served stale (``GraphedFunction``). On the CPU the
request runs eagerly (the JAX package's ``jit=False``).

``serve_stream`` pipelines a stream of frames: a host thread that pulls
frames, pinned copies on a side stream, and ``depth`` requests in flight.
"""
from __future__ import annotations

import collections
import contextlib
import operator
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .core.config import ModelConfig
from .core.device import resolve_device
from .data.loader import device_prefetch, pinned_put, prefetch
from .data.transforms import device_preprocess
from .models.bias_cache import build_inference_cache
from .models.soccdpt import compute_dtype


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """Every module of ``model`` in eval mode inside the block, and the
    ones that were in training mode put back in it afterwards: a request
    is served deterministically (BatchNorm on its running statistics,
    which it leaves as they are; no dropout or stochastic depth), as the
    JAX package serves with ``deterministic=True``, whatever mode the
    caller left the model in."""
    training = [mod for mod in model.modules() if mod.training]
    for mod in training:
        mod.training = False
    try:
        yield
    finally:
        for mod in training:
            mod.training = True


class _Weights:
    """The modules, parameters and buffers of a model as a graph was
    captured on them, and each module's mode. A load (``copy_``,
    ``load_state_dict``, an optimizer step) bumps a tensor's version
    counter, ``.data =`` or a move changes its storage, an assignment puts
    another tensor or submodule in a module (``model.head = ...``), and
    ``train()``/``eval()`` flips a module's ``training`` flag, which a graph
    froze at its capture: ``current()`` sees all five."""

    def __init__(self, model: nn.Module) -> None:
        self.model = model
        self.snapshot()

    def _entries(self) -> list:
        return [v for d in self._dicts for v in d.values()]

    def _flags(self) -> list:
        return [mod.training for mod in self._modules]

    def snapshot(self) -> None:
        self._modules = list(self.model.modules())
        self._dicts = [d for mod in self._modules
                       for d in (mod._modules, mod._parameters, mod._buffers)]
        self._held = self._entries()
        self._tensors = [v for v in self._held if isinstance(v, torch.Tensor)]
        self._ptrs = [t.data_ptr() for t in self._tensors]
        self._versions = [t._version for t in self._tensors]
        self._modes = self._flags()

    def current(self) -> bool:
        now = self._entries()
        return (len(now) == len(self._held) and all(map(operator.is_, now, self._held))
                and [t._version for t in self._tensors] == self._versions
                and [t.data_ptr() for t in self._tensors] == self._ptrs
                and self._flags() == self._modes)


class _Capture:
    """One CUDA graph of ``fn`` for one input shape: the static input, the
    graph, its static outputs, and what it cost to make."""

    def __init__(self, fn: Callable, example: torch.Tensor) -> None:
        dev = example.device
        self.input = torch.empty_like(example)
        self.input.copy_(example)
        # the eager run on a side stream fills every host-side cache (the
        # kernels' libraries, geometry constants, cuBLAS and cuDNN state)
        # before the capture, which must not meet a first call
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(self.input)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(self.input)
            self.graph.instantiate()
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph capture of the request failed for input "
                f"{tuple(example.shape)} {example.dtype}: {e}") from e
        self.capture_seconds = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, x: torch.Tensor):
        self.input.copy_(x)  # on the stream, after the previous replay
        self.graph.replay()
        self.replays += 1
        # the caller owns what it gets: copies out of the graph's pool,
        # which the next replay overwrites
        return tuple(None if o is None else o.clone() for o in self.outputs)


class GraphedFunction:
    """``fn(x) -> tuple of tensors (or None)`` through one CUDA graph per
    input shape, on the card, with ``model`` in eval mode (``eval_mode``):
    a call in training mode is served as one in eval mode, from the same
    graphs.

    The graph of a shape is captured at its first call. Before each call
    every submodule, parameter and buffer of ``model`` is compared with the
    one the graphs were captured on (the same module or tensor, a tensor's
    storage and its version counter, the module's mode): on a change,
    ``refresh`` runs (serving re-folds the attention biases) and every
    graph is captured again, since a graph reads the tensors it was
    captured on, and a changed storage would leave it reading freed
    memory. Outputs are copies the caller owns: no later call overwrites
    them. Graphs of different shapes keep their own memory pools.

    ``graphs`` maps input shapes to their captures (``graph``, ``replays``,
    ``warmup_seconds``, ``capture_seconds``); ``recaptures`` counts the
    weight changes seen.
    """

    def __init__(self, fn: Callable, model: nn.Module, device: torch.device,
                 refresh: Optional[Callable[[], None]] = None) -> None:
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.fn = fn
        self.model = model
        self.device = device
        self.refresh = refresh
        self.graphs: Dict[Tuple, _Capture] = {}
        self.recaptures = 0
        with eval_mode(model):
            self.weights = _Weights(model)

    def __call__(self, x: Union[np.ndarray, torch.Tensor]):
        x = torch.as_tensor(x)
        # the graphs were captured with every module in eval mode, so a
        # current model is one left in eval mode: no walk to set modes
        if self.weights.current():
            return self._replay(x)
        with eval_mode(self.model):
            if not self.weights.current():
                self.graphs.clear()
                if self.refresh is not None:
                    with torch.inference_mode(False):  # tensors that keep a version counter
                        self.refresh()
                self.weights.snapshot()
                self.recaptures += 1
            return self._replay(x)

    def _replay(self, x: torch.Tensor):
        with torch.inference_mode():
            shape = (tuple(x.shape), x.dtype)
            cap = self.graphs.get(shape)
            if cap is None:
                cap = self.graphs[shape] = _Capture(self.fn, x.to(self.device))
            return cap(x)


def make_serving_fn(
    cfg: ModelConfig,
    model: nn.Module,
    compute_occ: bool = False,
    output_size: Optional[Tuple[int, int]] = None,
    device: Union[str, torch.device, None] = None,
    bias_cache_dtype: Optional[torch.dtype] = None,
    graph: Optional[bool] = None,
) -> Callable:
    """Build ``serve(frames_u8) -> (inv_depth, seg, points, occ|None)``.

    ``frames_u8``: (B, H, W, 3) uint8 RGB, a numpy array or a tensor on
    any device. ``model`` is put in eval mode at bind, and every request
    runs it in eval mode whatever mode a caller put it in since, leaving
    its modes as it found them (``eval_mode``). ``model`` moves to ``device``
    (the card unless ``device`` says otherwise) and its attention biases
    are folded from its current weights; a later weight load is detected
    and never served stale (``models/bias_cache.py``, and
    ``GraphedFunction`` for graphs).
    ``bias_cache_dtype=torch.bfloat16`` stores the folded biases in bf16,
    which halves what BEiT's attention reads; the default keeps them f32.

    ``graph``: ``None`` serves through CUDA graphs on a card and eagerly on
    the CPU; ``True`` asks for graphs (on the CPU it raises); ``False``
    serves eagerly. A capture that fails raises. The TF32 and cuDNN
    settings in force at a graph's capture stay baked into it. Both
    callables carry the device they serve on as ``serve.device``.
    """
    if getattr(model, "cfg", None) != cfg:
        raise ValueError("the model was built for another config")
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device; serve on {dev} with graph=False")
    model = model.to(dev).eval()
    build_inference_cache(model, cache_dtype=bias_cache_dtype)
    net_w, net_h = cfg.net_size
    dtype = compute_dtype(cfg)

    def request(frames: torch.Tensor):
        x = device_preprocess(frames, (net_w, net_h), dtype=dtype)
        return model(x, compute_occ=compute_occ, output_size=output_size)

    if graph:
        return GraphedFunction(
            request, model, dev,
            refresh=lambda: build_inference_cache(model, cache_dtype=bias_cache_dtype))

    def serve(frames_u8):
        if isinstance(frames_u8, np.ndarray):
            frames_u8 = torch.from_numpy(frames_u8)
        with torch.inference_mode(), eval_mode(model):
            return request(frames_u8.to(dev))

    serve.device = dev
    return serve


def serve_stream(
    serve_fn: Callable,
    frames: Iterable,
    depth: int = 2,
    host_prefetch: Optional[int] = None,
) -> Iterator:
    """Pipelined serving over a stream of camera frames; yields each
    frame's outputs in order, complete when yielded.

    The stages overlap as in the JAX package: with ``host_prefetch`` set,
    a host thread pulls from a slow frame source at most that many frames
    ahead (the default ``None`` pulls frames in turn on this thread: on
    a source that is already in memory the thread only lengthened the
    latency, PERF.md §5); each frame is staged in pinned memory and copied on a side stream
    (``data.loader.pinned_put``) up to ``depth`` frames ahead; and
    ``depth`` requests stay in flight. The request's stream waits for its
    frame's copy through an event, and a graph's static input is written
    on that stream, after the replay before it has read it. An output is
    handed out once the event recorded after its request has passed (the
    JAX package's ``block_until_ready``). ``serve_fn`` is a serving fn of
    :func:`make_serving_fn`, whose ``device`` says where frames go.
    """
    device = serve_fn.device
    put = pinned_put(device)
    cuda = device.type == "cuda"
    source = frames if host_prefetch is None else prefetch(frames, size=host_prefetch)
    inflight: collections.deque = collections.deque()

    def finished(outputs, done):
        if done is not None:
            done.synchronize()
        return outputs

    for staged in device_prefetch(source, put, depth=depth):
        outputs = serve_fn(staged.result())
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        inflight.append((outputs, done))
        if len(inflight) >= depth:
            yield finished(*inflight.popleft())
    while inflight:
        yield finished(*inflight.popleft())
