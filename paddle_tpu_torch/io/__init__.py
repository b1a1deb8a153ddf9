"""Datasets and data loading (the counterpart of ``paddle_tpu/io``).

Samples and batches are assembled on the host as numpy arrays; only the
process that trains turns a batch into paddle Tensors on the device
(``set_device``'s choice, else the current CUDA device), one synchronous
host-to-device copy a leaf, on the stream the step then runs on.

- ``num_workers=0``: the batches are built on the caller's thread.
- ``num_workers>0`` with ``use_shared_memory=True`` (the default): worker
  processes (:mod:`.multiprocess`) build numpy batches and hand them over
  in shared memory.  Workers stay on the host: they never create a CUDA
  context, and a paddle Tensor made inside one lands on the CPU.
- ``num_workers>0`` with ``use_shared_memory=False``: a pool of threads
  in this process.  With the default collation the threads make numpy
  and the consumer makes the Tensors; a ``collate_fn`` that puts tensors
  on the card from a thread has its work waited for (a CUDA event) before
  the batch is handed out.

Every path hands its batches out through :func:`_emit_batch`, the
``dataloader.batch`` fault point."""
from __future__ import annotations

import queue
import threading
from itertools import islice
from typing import Any, List

import numpy as np
import torch

from ..core.rng import default_generator
from ..core.tensor import Tensor, wrap

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "ChainDataset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "get_worker_info", "DatasetFactory",
           "InMemoryDataset", "QueueDataset", "Tensor"]


class Dataset:
    """Map-style dataset (reference: paddle/io/dataset.py)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


def _host(x) -> np.ndarray:
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return torch.Tensor.numpy(x.detach().cpu())
    return np.asarray(x)


class TensorDataset(Dataset):
    """Rows of equally long tensors (kept on the host)."""

    def __init__(self, tensors):
        self.tensors = [_host(t) for t in tensors]
        n = len(self.tensors[0])
        assert all(len(t) == n for t in self.tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else int(self.cum[di - 1])
        return self.datasets[di][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths over one permutation drawn from
    ``RandomState(paddle.seed)`` (paddle_tpu's draw: the same seed gives
    the same split in both packages)."""
    n = len(dataset)
    assert sum(lengths) == n
    g = np.random.RandomState(default_generator().initial_seed or None)
    perm = g.permutation(n)
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln].tolist()))
        ofs += ln
    return out


# -- samplers (reference: python/paddle/io/sampler.py, batch_sampler.py) ----

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or draws with replacement) from a numpy
    ``RandomState`` seeded by one host draw of :mod:`..core.rng` per
    epoch (paddle_tpu seeds it from a threefry key: the orders differ
    between the packages)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rs = np.random.RandomState(default_generator().next_key() % (2 ** 31))
        if self.replacement:
            return iter(rs.randint(0, n, self.num_samples).tolist())
        return iter(rs.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.RandomState().choice(
            len(p), self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        assert (dataset is None) != (sampler is None), \
            "exactly one of dataset/sampler"
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's share of the index space: an epoch-seeded global
    permutation (``shuffle``), padded to a multiple of the replicas, cut
    every ``num_replicas``-th index from ``rank``.  The rank and world
    default to the process group's (0 and 1 before one exists)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed.env import get_rank, get_world_size
            num_replicas = num_replicas or get_world_size()
            rank = rank if rank is not None else get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n)
        pad = self.total_size - n
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        shard = indices[self.local_rank::self.nranks]
        batch = []
        for idx in shard.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# -- collation --------------------------------------------------------------

def _to_numpy(obj):
    """A sample's leaves as numpy arrays (tensors copied to the host;
    Python floats take float32, Python ints int64, as ``to_tensor``)."""
    if isinstance(obj, torch.Tensor):
        return _host(obj)
    if isinstance(obj, float):
        return np.asarray(obj, np.float32)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def _np_collate(batch: List[Any]):
    """Stack numpy samples into batch arrays, keeping numpy's dtypes
    (reference: fluid/dataloader/collate.py)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        if sample.dtype.kind in "OUS":
            raise TypeError(f"cannot collate arrays of {sample.dtype}")
        return np.stack(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(_np_collate(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    raise TypeError(f"cannot collate type {type(sample)}")


def _device_tensor(a: np.ndarray) -> Tensor:
    """One host array (owned by the caller) as a paddle Tensor on the
    default device: a synchronous copy, so the step that reads it on
    this stream sees it whole."""
    from ..core import placement
    dev = placement.device(None)
    t = torch.from_numpy(a)
    return wrap(t if dev.type == "cpu" else t.to(dev))


def _tensorize(tree):
    if isinstance(tree, np.ndarray):
        return _device_tensor(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensorize(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tensorize(v) for k, v in tree.items()}
    return tree


def default_collate_fn(batch: List[Any]):
    """Stack samples (numpy arrays, numbers, tensors, or tuples and dicts
    of them) into batch Tensors on the default device."""
    return _tensorize(_np_collate([_to_numpy(s) for s in batch]))


def _emit_batch(batch, index: int):
    """Every DataLoader path hands its batches out through here — the
    ``dataloader.batch`` fault point.  An armed ``action=corrupt`` rule
    (``testing.fault``) poisons the handed-out copy (nan/inf/bitflip) so
    chaos drills can prove the anomaly sentry catches a bad batch;
    disarmed, this is one bool check."""
    from ..testing import fault
    if fault.is_armed():
        batch = fault.corrupt_host("dataloader.batch", batch,
                                   f"batch={index}")
    return batch


def _cuda_leaves(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_cuda_leaves(t) for t in tree)
    if isinstance(tree, dict):
        return any(_cuda_leaves(t) for t in tree.values())
    return False


class _PrefetchIterator:
    """Batches built by a pool of threads, handed out in order.  With the
    default collation the threads make numpy and :meth:`__next__` makes
    the Tensors on the consumer's thread; a custom ``collate_fn`` runs on
    the thread, and when its batch holds CUDA tensors the thread records
    an event on its stream, which the consumer's stream waits on."""

    def __init__(self, loader, sampler_iter):
        self.loader = loader
        self.q: queue.Queue = queue.Queue(maxsize=max(
            2, loader.prefetch_factor))
        self.idx_q: queue.Queue = queue.Queue()
        self.out = {}
        self.next_emit = 0
        self.lock = threading.Lock()
        for i, idxs in enumerate(sampler_iter):
            self.idx_q.put((i, idxs))
        self.total = self.idx_q.qsize()
        self.threads = []
        for _ in range(max(1, loader.num_workers)):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self):
        while True:
            try:
                i, idxs = self.idx_q.get_nowait()
            except queue.Empty:
                return
            ds = self.loader.dataset
            samples = [ds[j] for j in idxs]
            ready = None
            if self.loader.collate_fn is None:
                batch = _np_collate([_to_numpy(s) for s in samples])
            else:
                batch = self.loader.collate_fn(samples)
                if _cuda_leaves(batch):
                    ready = torch.cuda.Event()
                    ready.record()
            self.q.put((i, batch, ready))

    def __iter__(self):
        return self

    def __next__(self):
        if self.next_emit >= self.total:
            raise StopIteration
        from ..core import flags as _flags
        timeout = (getattr(self.loader, "timeout", 0)
                   or _flags.get_flag("dataloader_timeout"))
        while True:
            with self.lock:
                if self.next_emit in self.out:
                    b, ready = self.out.pop(self.next_emit)
                    self.next_emit += 1
                    if ready is not None:
                        torch.cuda.current_stream().wait_event(ready)
                    if self.loader.collate_fn is None:
                        b = _tensorize(b)
                    return _emit_batch(b, self.next_emit - 1)
            try:
                i, batch, ready = self.q.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(
                    f"DataLoader stalled: no batch for {timeout}s from "
                    f"the thread pool — raise DataLoader(timeout=...) or "
                    f"FLAGS_dataloader_timeout for slow datasets") \
                    from None
            with self.lock:
                self.out[i] = (batch, ready)


class DataLoader:
    """reference: paddle.io.DataLoader (fluid/reader.py).

    ``num_workers>0`` with ``use_shared_memory=True`` (default) runs
    worker processes with shared-memory batch transport
    (:mod:`.multiprocess`); ``use_shared_memory=False`` the in-process
    thread pool.  ``places`` and ``use_buffer_reader`` are accepted for
    API parity."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if isinstance(self.dataset, IterableDataset):
            return self._iter_iterable()
        if self.batch_sampler is None:
            return (self.dataset[i] for i in range(len(self.dataset)))
        if self.num_workers > 0:
            if self.use_shared_memory:
                from .multiprocess import MultiprocessIterator
                return MultiprocessIterator(self, iter(self.batch_sampler))
            return _PrefetchIterator(self, iter(self.batch_sampler))
        return self._iter_sync()

    def _collate(self, samples):
        return (self.collate_fn or default_collate_fn)(samples)

    def _iter_sync(self):
        for i, idxs in enumerate(self.batch_sampler):
            yield _emit_batch(self._collate([self.dataset[j]
                                             for j in idxs]), i)

    def _iter_iterable(self):
        batch = []
        i = 0
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield _emit_batch(self._collate(batch), i)
                i += 1
                batch = []
        if batch and not self.drop_last:
            yield _emit_batch(self._collate(batch), i)

    def fetch_batch(self, i: int):
        """Assemble batch ``i`` of this (map-style, batch-sampled) loader
        on demand — the re-delivery path after the anomaly sentry skips a
        corrupted delivery.  It goes through the same ``dataloader.batch``
        fault point, so a transient corruption clears on retry.  A
        ``shuffle=True`` sampler is drawn anew per call; deterministic
        re-delivery wants ``shuffle=False`` or a fixed
        ``batch_sampler``."""
        if self.batch_sampler is None:
            raise TypeError("fetch_batch needs a map-style dataset "
                            "with a batch sampler")
        idxs = next(islice(iter(self.batch_sampler), i, i + 1), None)
        if idxs is None:
            raise IndexError(f"fetch_batch({i}): the sampler yields "
                             f"fewer than {i + 1} batches")
        return _emit_batch(self._collate([self.dataset[j] for j in idxs]),
                           i)


def get_worker_info():
    return None  # as in paddle_tpu: no worker context is published


# the distributed dataset family (reference: fluid/dataset.py)
from .dataset_dist import (DatasetFactory, InMemoryDataset,  # noqa: E402
                           QueueDataset)
