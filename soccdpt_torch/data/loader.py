"""Dataset splitting, batching and feeding the card.

The port of ``soccdpt_tpu/data/loader.py``: the same seeded splits and
epoch orders (numpy permutations, so both packages pick the same samples
in the same order), ``prefetch`` (a host thread that pulls from a slow
source ahead of its consumer) and ``device_prefetch`` (``depth`` copies
to the device in flight). ``pinned_put`` is a ``put_fn`` for
``device_prefetch``: pinned host memory, a copy on a side stream, and the
copy handed over through a CUDA event.

One departure from the JAX package: when the source raises, ``prefetch``
raises the same exception in its consumer, where the JAX version ends
the stream silently (its ``finally`` puts the end marker either way), so
a failing frame source looked like a short stream there.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class Subset:
    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def random_split(dataset, lengths: Sequence[int], seed: int = 0) -> List[Subset]:
    """Deterministic split (same role as torch random_split with a seeded
    generator, reference train_SOccDPT.py:209-226)."""
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError(f"lengths {lengths} must sum to dataset size {n}")
    perm = np.random.default_rng(seed).permutation(n)
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start : start + ln].tolist()))
        start += ln
    return out


def split_train_val(
    dataset, val_percent: float, dataset_percentage: float = 1.0, seed: int = 0
) -> Tuple[Subset, Subset]:
    """dataset_percentage subsample then train/val split
    (reference train_SOccDPT.py:206-229)."""
    total = len(dataset)
    use = int(round(total * dataset_percentage))
    used, _ = random_split(dataset, [use, total - use], seed=seed)
    n_val = max(1, int(len(used) * val_percent))
    n_train = len(used) - n_val
    if n_train <= 0:
        raise ValueError("dataset too small for the requested split")
    train, val = random_split(used, [n_train, n_val], seed=seed)
    return train, val


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into a batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def iterate_batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield collated batches; each host sees its own index shard."""
    n = len(dataset)
    order = (
        np.random.default_rng(seed + epoch).permutation(n)
        if shuffle
        else np.arange(n)
    )
    order = order[process_index::process_count]
    stop = len(order) - (len(order) % batch_size if drop_last else 0)
    for start in range(0, stop, batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([dataset[int(i)] for i in idx])


def device_prefetch(iterator: Iterable, put_fn: Callable, depth: int = 2) -> Iterator:
    """Keep ``depth`` puts in flight: ``put_fn`` of item N + depth - 1 is
    started before item N is yielded, so an asynchronous copy overlaps the
    consumer's work on the items before it. Yields ``put_fn``'s results in
    order."""
    q: collections.deque = collections.deque()
    for item in iterator:
        q.append(put_fn(item))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Pull from ``iterator`` on a background thread, at most ``size``
    items ahead (``size`` 0 or less: no bound, as ``queue.Queue``), so a
    slow host source overlaps its consumer. An exception of the source is
    raised in the consumer after the items before it."""
    q: queue.Queue = queue.Queue(maxsize=size)
    done = object()
    failure: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            failure.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item


class DeviceCopy:
    """A host-to-device copy started on a side stream. ``result()`` makes
    the calling thread's current stream wait for it (a CUDA event, no host
    wait) and marks the tensor as used there, so the allocator never hands
    its memory to another tensor while that stream may still read it."""

    def __init__(self, tensor: torch.Tensor, event: Optional["torch.cuda.Event"]) -> None:
        self.tensor = tensor
        self.event = event

    def result(self) -> torch.Tensor:
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


def pinned_put(
    device: Union[str, torch.device]
) -> Callable[[Union[np.ndarray, torch.Tensor]], DeviceCopy]:
    """A ``put_fn`` for ``device_prefetch`` that moves host arrays (uint8
    frames) to ``device``.

    On a card, each array is copied into pinned host memory (a host
    memcpy; the caching host allocator keeps the block until the copy has
    read it), then to the device with ``non_blocking=True`` on a side
    stream of its own, and an event marks the copy's end; the consumer
    takes it with ``DeviceCopy.result()``. A tensor already on the card
    passes through. Elsewhere the array is moved with ``.to(device)`` and
    needs no event."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda item: DeviceCopy(torch.as_tensor(item).to(dev), None)
    side = torch.cuda.Stream(dev)

    def put(item) -> DeviceCopy:
        host = torch.as_tensor(item)
        if host.device.type == "cuda":
            return DeviceCopy(host, None)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(side):
            out = torch.empty(host.shape, dtype=host.dtype, device=dev)
            out.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return DeviceCopy(out, event)

    return put
