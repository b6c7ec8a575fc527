"""Named host spans inside the program, on ``torch.profiler``'s clock.

``with span("serve.stage"): ...`` records the block's start and end when
spans are on, and costs one test of a module flag when they are off (the
default): it returns a shared do-nothing context, reads no clock and
allocates nothing. ``enable()`` turns them on, ``disable()`` off,
``clear()`` drops what was recorded, and ``snapshot()`` returns
``{name: [(start_ns, end_ns), ...]}``, each list in the order the spans
ended.

Spans are taken on ``time.perf_counter_ns`` and handed out on the
profiler's clock: Kineto stamps its host and device events in Unix-epoch
nanoseconds (``time.time_ns``), so ``enable()`` reads the two clocks side
by side, and ``snapshot()`` moves every span by their difference. A span
and the kernels the card ran inside it then lie on one axis.

Spans may end on any thread (``data.loader.prefetch``'s worker): each is
one ``dict.setdefault`` and one ``list.append``, which the interpreter
lock makes whole, so the hot path takes no lock.

Spans of the serving path (``serving.py``):

- ``serve.call``: one request, all of ``GraphedFunction.__call__`` or the
  eager ``serve`` of ``make_serving_fn``;
- ``serve.check``: the weight check before a replay (on a change: the
  refresh, the new snapshot and the capture);
- ``serve.stage``: the copy of the frames into the graph's static input,
  which blocks the host until done when they come from pinned memory;
- ``serve.launch``: the graph's replay;
- ``stream.stage``: one frame's ``put`` in ``serve_stream`` (pinned
  staging, the side-stream copy's enqueue and its event).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

_on = False
_spans: Dict[str, List[Tuple[int, int]]] = {}
_offset_ns = 0  # epoch ns less perf_counter ns, read by enable()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        _spans.setdefault(self.name, []).append((self.start, time.perf_counter_ns()))


def span(name: str):
    """A context that records its block as span ``name`` when spans are on."""
    return _Span(name) if _on else _OFF


def _clock_offset(reads: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the pair of reads
    that lay closest together of ``reads`` tries."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        epoch = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, epoch - (a + b) // 2)
    return best[1]


def enable() -> None:
    global _on, _offset_ns
    _offset_ns = _clock_offset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def clear() -> None:
    global _spans
    _spans = {}


def snapshot() -> Dict[str, List[Tuple[int, int]]]:
    """What was recorded, on the profiler's clock (Unix-epoch ns)."""
    off = _offset_ns
    return {name: [(a + off, b + off) for a, b in list(spans)]
            for name, spans in list(_spans.items())}
