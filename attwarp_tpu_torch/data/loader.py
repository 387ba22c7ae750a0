"""Batching and collation for training (counterpart of
``attwarp_tpu/data/loader.py``).

Collation parity with ``data.py:10-24`` (string fields pass through as
lists), extended with the numeric transform masks the train step consumes
(the reference computes them inside the hot loop from strings,
trainer.py:177-194; they are computed here on the host).

Two pipelines yield the same batches in the same order: the one-deep
background-thread prefetcher of the JAX package (``"thread"``), and a
``torch.utils.data.DataLoader`` over the same index order (``"grain"``,
the name of the JAX pipeline it stands in for, optionally with worker
processes). JAX's ``data/grain_pipeline.py`` itself is not ported.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from attwarp_tpu_torch.data.manifests import load_gqa_transform_map, transform_for_sample
from attwarp_tpu_torch.parallel.mesh import current_mesh


def collate(items: Sequence[Dict]) -> Dict:
    """Stack numeric fields; pass strings through; add sqrt/none masks."""
    mapping = load_gqa_transform_map()
    tfms = [
        transform_for_sample(b.get("dataset"), b.get("bucket"), mapping)
        for b in items
    ]
    out = {
        "image": np.stack([b["image"] for b in items]).astype(np.float32, copy=False),
        "attention_map": np.stack([b["attention_map"] for b in items]).astype(np.float32,
                                                                            copy=False),
        "q_str": [b["question"] for b in items],
        "answer": [b.get("answer", "") for b in items],
        "dataset": [b.get("dataset") for b in items],
        "bucket": [b.get("bucket") for b in items],
        "sqrt_mask": np.asarray([1.0 if t == "sqrt" else 0.0 for t in tfms], np.float32),
        "none_mask": np.asarray([1.0 if t == "none" else 0.0 for t in tfms], np.float32),
    }
    return out


def split_indices(n: int, val_frac: float, seed: int):
    """Seeded 90/10-style split (trainer.py:75-81)."""
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    n_val = n - int((1.0 - val_frac) * n)
    return idx[: n - n_val], idx[n - n_val :]


def host_local_indices(
    indices: Sequence[int],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[int]:
    """Input sharding: each process reads a disjoint strided slice of the
    index list. One process feeds one device, so the defaults are this
    rank's index on the ``data`` axis and that axis's size (of the mesh
    ``parallel/mesh.py::make_mesh`` built last; 0 and 1 without one)."""
    if process_index is None or process_count is None:
        mesh = current_mesh()
        pi, pc = (0, 1) if mesh is None else (mesh.data.rank, mesh.data.size)
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    return list(indices)[process_index::process_count]


def _order(indices: Sequence[int], shuffle: bool, seed: int) -> List[int]:
    order = list(indices)
    if shuffle:
        random.Random(seed).shuffle(order)
    return order


def batch_iterator(
    dataset,
    indices: Sequence[int],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    prefetch: int = 2,
) -> Iterator[Dict]:
    """Yield collated batches with background prefetch."""
    order = _order(indices, shuffle, seed)
    n = len(order)
    batches: List[List[int]] = []
    start = 0
    while start < n:
        end = min(start + batch_size, n)
        if end - start < batch_size and drop_last:
            break
        batches.append(order[start:end])
        start = end

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = object()

    def producer():
        try:
            for b in batches:
                q.put(collate([dataset[i] for i in b]))
            q.put(stop)
        except BaseException as e:  # propagate — a swallowed loader error
            q.put(e)                # would silently truncate every epoch

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def loader_iterator(
    dataset,
    indices: Sequence[int],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 0,
) -> Iterator[Dict]:
    """The batches of ``batch_iterator``, in its order, from a
    ``torch.utils.data.DataLoader``; ``num_workers`` > 0 reads the samples
    in that many spawned worker processes (the dataset must pickle)."""
    from torch.utils.data import DataLoader

    return iter(DataLoader(
        dataset, batch_size=batch_size, sampler=_order(indices, shuffle, seed),
        collate_fn=collate, drop_last=drop_last, num_workers=num_workers,
        multiprocessing_context="spawn" if num_workers > 0 else None,
    ))


def make_batch_iterator(
    dataset,
    indices: Sequence[int],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    pipeline: str = "auto",
    num_workers: int = 0,
) -> Iterator[Dict]:
    """Select the input pipeline: ``"grain"`` (the ``DataLoader``),
    ``"thread"`` (the in-process prefetcher), or ``"auto"`` (the
    ``DataLoader``). Both yield the same collated batches in the same
    order."""
    if pipeline not in ("auto", "grain", "thread"):
        raise ValueError(f"unknown data pipeline {pipeline!r}")
    if pipeline == "thread":
        return batch_iterator(dataset, indices, batch_size, shuffle=shuffle, seed=seed,
                              drop_last=drop_last)
    return loader_iterator(dataset, indices, batch_size, shuffle=shuffle, seed=seed,
                           drop_last=drop_last, num_workers=num_workers)
