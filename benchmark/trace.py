"""The traced slices of a window, from ``torch.profiler``.

A traced run profiles two slices of the window's iterations (requests).
The first records the device alone (kernels, copies, memsets): its busy
time, its length on the host's clock and the time by kernel, which the
per-layer metrics read. Recording the host's calls too slows a
host-bound iteration by half, so the second, short slice records
both, and only names the host calls under the device's idle gaps.
Events are kept as plain tuples, so the reduction is tested without a
card.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

clock = time.perf_counter


@dataclass
class Event:
    name: str
    start_us: float
    end_us: float


@dataclass
class Trace:
    """What a slice left: the device's operations, the host's calls (if
    recorded), the slice's length on the host's clock and the iterations
    it spans. The window on the profiler's clock runs from the first
    event to the last."""

    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    wall_s: Optional[float] = None
    units: int = 0

    @property
    def window(self) -> Tuple[float, float]:
        events = self.device + self.host
        if not events:
            return 0.0, 0.0
        return min(e.start_us for e in events), max(e.end_us for e in events)

    @property
    def window_s(self) -> float:
        if self.wall_s is not None:
            return self.wall_s
        lo, hi = self.window
        return (hi - lo) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for e in sorted(self.device, key=lambda e: e.start_us):
            if merged and e.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end_us)
            else:
                merged.append([e.start_us, e.end_us])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, part: str) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds ``part``."""
        hits = [e for e in self.device if part in e.name]
        return sum(e.end_us - e.start_us for e in hits) * 1e-6, len(hits)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = {}
        for e in self.device:
            total[e.name] = total.get(e.name, 0.0) + (e.end_us - e.start_us) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds of the device within the window, by the innermost
        host call under each gap's middle (``idle`` where the host ran none)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        total: Dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            under = [e for e in self.host if e.start_us <= mid <= e.end_us]
            name = min(under, key=lambda e: e.end_us - e.start_us).name if under else "idle"
            total[name] = total.get(name, 0.0) + (b - a) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def from_profile(prof) -> Trace:
    """Device operations (not the GPU annotations) and host calls of a
    finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    trace = Trace()
    for ev in prof.events():
        e = Event(ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type != DeviceType.CUDA:
            trace.host.append(e)
        elif not getattr(ev, "is_user_annotation", False):
            trace.device.append(e)
    return trace


class Slice:
    """Profiles the iterations ``[first, first + count)`` of a loop:
    ``at(i, sync)`` before iteration ``i`` starts or stops the profiler
    and returns the seconds that took, which an open loop adds to its
    schedule. Both ends are synchronized, so the slice's device work lies
    inside it. ``host`` records the host's calls too."""

    def __init__(self, first: int, count: int, enabled: bool, host: bool = False):
        self.first, self.count, self.enabled, self.host = first, count, enabled, host
        self.trace: Optional[Trace] = None
        self.opened_at: Optional[float] = None  # host clock, the iterations before it done
        self._prof = None
        self._t0 = 0.0

    def at(self, i: int, sync) -> float:
        t = clock()
        if self.enabled and i == self.first and self.trace is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            sync()
            self.opened_at = clock()
            acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
            if self.host or not acts:  # without a card only the host can be recorded
                acts.append(ProfilerActivity.CPU)
            self._prof = profile(activities=acts)
            self._prof.start()
            sync()
            self._t0 = clock()
        elif i >= self.first + self.count:
            self.close(sync, i)
        return clock() - t

    def close(self, sync, i: int) -> None:
        if self._prof is None:
            return
        sync()
        wall = clock() - self._t0
        self._prof.stop()
        self.trace = from_profile(self._prof)
        self.trace.wall_s, self.trace.units = wall, i - self.first
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def pending(self) -> bool:
        """Enabled and not finished: a traced run goes on until it is."""
        return self.enabled and self.trace is None


def sync_fn(device):
    """A function that waits for ``device``'s work (nothing on the CPU)."""
    import torch

    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)


def slices(spec, enabled: bool) -> Tuple[Slice, Slice]:
    """The device slice and the host slice after it, from a traffic
    file's ``trace``: [first iteration, device count, host count]."""
    first, count, host = spec
    return Slice(first, count, enabled), Slice(first + count, host, enabled, host=True)


@contextlib.contextmanager
def span(store: Dict[str, List[float]], name: str):
    """Host seconds of the block, appended to ``store[name]``."""
    t0 = clock()
    try:
        yield
    finally:
        store.setdefault(name, []).append(clock() - t0)
