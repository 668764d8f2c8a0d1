"""Parallel host loading for `cli train`: port of `mvropose_tpu/data/grain_loader.py`.

The reference decodes in grain worker processes. The card has no grain, so
the workers here are `torch.utils.data.DataLoader` workers. They run the
datasets' own per-sample maps (`data/dataset.py::SampleMap`,
`GroupSampleMap`: decode, ROI crop, host undistortion, shape gate, the
fixed-shape sample dict), the preparation `batches()` runs in-process, and
stack a batch. Everything else happens once, in the parent, when the map is
made: the GT keypoints (FK and projection in torch), the extrinsic fields
and the cv2 remap tables, which the map carries to the workers. The
workers see numpy only and never touch CUDA. They are forked from a fork
server, a clean process started once per program that imports this module
(and so torch) once, not from the parent: a process forked from a parent
whose cv2 thread pool has run can deadlock in cv2 (its first call,
`cv2.setNumThreads`, does), and a fork would copy the parent's CUDA state.
Spawned workers are clean too, but each imports the program's main module
afresh before its first sample.

The stream is grain's: a flat sequence of per-epoch permutations of the
dataset, cut into batches of `batch_size` (`batch_indices`); with a finite
number of epochs the last partial batch is dropped, an endless stream
(`num_epochs=None`) drops nothing. The permutation of epoch e is the port's
own (`torch.randperm` from a generator seeded `seed + e`), not grain's
`index_shuffle`; `order` replaces it (a test passes grain's). The parent
draws the order, and the DataLoader returns batches in that order whatever
the workers' timing, so every batch is the same for any number of workers
(0 maps in-process). A worker that fails raises in the parent.
"""

from __future__ import annotations

import multiprocessing
from typing import Callable, Iterator

import numpy as np
import torch

from mvropose_torch.data.dataset import (
    GroupSampleMap,
    MultiViewDataset,
    SampleMap,
    SingleViewDataset,
    stack_samples,
)


def sample_map(dataset: SingleViewDataset | MultiViewDataset) -> SampleMap | GroupSampleMap:
    """The dataset's per-sample map (groups for a multi-view dataset)."""
    return GroupSampleMap(dataset) if isinstance(dataset, MultiViewDataset) else SampleMap(dataset)


def collate(samples: list) -> dict:
    """Sample dicts -> one batch of CPU tensors, each key stacked."""
    return {k: torch.from_numpy(v) for k, v in stack_samples(samples).items()}


def permutations(n: int, seed: int) -> Callable[[int], np.ndarray]:
    """epoch -> the order of that epoch: a permutation of range(n) drawn
    from a torch generator seeded `seed + epoch` (the epoch's seed as
    grain's)."""
    def order(epoch: int) -> np.ndarray:
        gen = torch.Generator().manual_seed(seed + epoch)
        return torch.randperm(n, generator=gen).numpy()
    return order


def batch_indices(order: Callable[[int], np.ndarray], batch_size: int,
                  num_epochs: int | None) -> Iterator[np.ndarray]:
    """The epochs' orders as one flat stream cut into batches: a batch may
    span two epochs; a finite stream's last partial batch is dropped."""
    buf: list = []
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        for i in order(epoch):
            buf.append(int(i))
            if len(buf) == batch_size:
                yield np.asarray(buf)
                buf = []
        epoch += 1


class _Batches(torch.utils.data.Dataset):
    """A batch's indices -> the collated batch (what each worker runs)."""

    def __init__(self, fn):
        self.fn = fn

    def __getitem__(self, indices) -> dict:
        return collate([self.fn(int(i)) for i in indices])


def _single_thread_worker(_worker_id: int) -> None:
    """A worker decodes one image at a time: no cv2 or torch thread pool
    of its own beside the other workers'."""
    import cv2

    cv2.setNumThreads(1)
    torch.set_num_threads(1)


def _first(batch):
    return batch


class WorkerStream:
    """Iterator of host batches (dicts of CPU tensors, pinned with
    `pin_memory`), from `num_workers` worker processes or in-process at 0.
    `indices` is the last batch's dataset indices. `close()` stops the
    workers."""

    def __init__(self, fn, batch_indices_iter: Iterator[np.ndarray], num_workers: int,
                 pin_memory: bool = False):
        self.indices = None
        self._order = _Recorded(batch_indices_iter)
        if num_workers > 0:
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            loader = torch.utils.data.DataLoader(
                _Batches(fn), batch_size=None, sampler=self._order, num_workers=num_workers,
                collate_fn=_first, pin_memory=pin_memory, worker_init_fn=_single_thread_worker,
                multiprocessing_context=ctx)
            self._it = iter(loader)
        else:
            batches = _Batches(fn)
            self._it = (self._pinned(batches[ix]) if pin_memory else batches[ix]
                        for ix in self._order)

    @staticmethod
    def _pinned(batch: dict) -> dict:
        return {k: v.pin_memory() for k, v in batch.items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self._it)
        # The sampler runs ahead of the batches by the workers' prefetch.
        self.indices = self._order.issued.pop(0)
        return batch

    def close(self) -> None:
        shutdown = getattr(self._it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()
        self._it = iter(())


class _Recorded:
    """The batch-index stream, keeping each batch's indices until its batch
    is handed out (the DataLoader draws ahead of what it returns)."""

    def __init__(self, it: Iterator[np.ndarray]):
        self.it, self.issued = it, []

    def __iter__(self):
        for ix in self.it:
            self.issued.append(ix)
            yield ix


def make_worker_loader(dataset: SingleViewDataset | MultiViewDataset, batch_size: int,
                       seed: int = 0, num_workers: int = 0, num_epochs: int | None = 1,
                       order: Callable[[int], np.ndarray] | None = None,
                       pin_memory: bool = False) -> WorkerStream:
    """-> a shuffled stream of fixed-shape host batches with the dataset's
    own `batches()` keys (single-view or multi-view, the with_extrinsics
    fields included), as the reference's `make_grain_loader(shuffle=True)`:
    `num_epochs` None is an endless stream, an int n passes; the last
    partial batch is dropped. `order(epoch)` replaces the port's
    permutations."""
    fn = sample_map(dataset)
    order = order or permutations(len(fn), seed)
    return WorkerStream(fn, batch_indices(order, batch_size, num_epochs), num_workers,
                        pin_memory)
