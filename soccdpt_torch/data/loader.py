"""Dataset splitting and batching.

The port of ``soccdpt_tpu/data/loader.py``'s splits and batches: the same
seeded splits and epoch orders (numpy permutations, so both packages pick
the same samples in the same order). Its host thread (``prefetch``) and
``device_prefetch`` are not ported: the occupancy trainer, the one caller
so far, feeds serially, as the JAX CLI does (ROADMAP.md keeps what the
card measured of both for the slice that needs them).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


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
