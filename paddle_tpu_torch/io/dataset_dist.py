"""The fleet dataset family with a cross-worker global shuffle (the
counterpart of ``paddle_tpu/io/dataset_dist.py``; reference:
``paddle/fluid/framework/data_set.h`` InMemoryDataset and QueueDataset,
``python/paddle/fluid/dataset.py`` DatasetFactory).

After :meth:`InMemoryDataset.global_shuffle` every worker holds a
disjoint contiguous chunk of one seed-determined permutation of all the
records, with no coordinator:

1. every worker computes the same permutation
   ``RandomState(seed).permutation(total)`` and the same contiguous
   position-to-worker chunking, so routing needs no messages;
2. the records travel through a spool directory every worker can read
   and write (a shared filesystem; a temporary directory in tests): each
   worker writes one pickle per destination rank behind sentinel files,
   then reads the pickles addressed to it.

``load_into_memory`` reads the fleet file shard (``files[rank::world]``),
so the load is already disjoint across workers.  The rank and world come
from the arguments, else the launcher's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``, else ``distributed.env`` (0 and 1 before a
process group exists).  The protocol, the spool layout and the draws are
paddle_tpu's, so both packages shuffle the same records into the same
shards."""
from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import pickle
import subprocess
import time

import numpy as np


__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


def _resolve_rank_world(rank=None, world_size=None):
    """Explicit args > launcher env > distributed.env helpers.

    The launcher env is checked first because datasets are often built
    before ``init_parallel_env``; past that point the two sources agree
    by construction (the launcher sets both)."""
    if rank is not None and world_size is not None:
        return int(rank), int(world_size)
    env_r = os.environ.get("PADDLE_TRAINER_ID")
    env_w = os.environ.get("PADDLE_TRAINERS_NUM")
    if env_r is not None and env_w is not None:
        return int(env_r), int(env_w)
    from ..distributed.env import get_rank, get_world_size
    return get_rank(), get_world_size()


def _wait_for(paths, timeout, what):
    deadline = time.monotonic() + timeout
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"global_shuffle: timed out waiting for {what}: "
                f"{missing[:4]}{'...' if len(missing) > 4 else ''}")
        time.sleep(0.02)


class _DatasetBase:
    """Shared config surface (reference: fluid/dataset.py DatasetBase).

    ``name`` namespaces any shared-filesystem state this dataset writes
    (InMemoryDataset's shuffle spool); QueueDataset accepts and ignores
    it (no shared state)."""

    def __init__(self, rank=None, world_size=None, name=None):
        if name is not None and (set(str(name)) & set("*?[]")
                                 or os.sep in str(name)
                                 or str(name).startswith(".")):
            # the name becomes a spool directory prefix AND a glob
            # pattern (reaping); separators would nest roots, glob
            # metachars would break cleanup forever
            raise ValueError(
                f"dataset name {name!r} must not contain path "
                f"separators, leading dots, or glob characters *?[]")
        self._name = name
        self._filelist = []
        self._batch_size = 1
        self._thread_num = 1
        self._parse_fn = None
        self._pipe_command = None
        self._use_vars = []
        self._rank, self._world = _resolve_rank_world(rank, world_size)

    # -- reference config setters ------------------------------------
    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = int(thread_num)

    def set_use_var(self, var_list):
        """Kept for API parity; the pipeline feeds arrays positionally
        so the slot->Variable binding is a no-op here."""
        self._use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        """Reference semantics (data_feed.h pipe reader): each file's bytes
        are piped through this shell command; one output line = one
        record (before ``set_parse_fn`` post-processing)."""
        self._pipe_command = pipe_command

    def set_parse_fn(self, fn):
        """Replaces the protobuf DataFeedDesc: maps one raw text line ->
        one record object (any picklable value)."""
        self._parse_fn = fn

    # -- loading ------------------------------------------------------
    def _my_files(self):
        return self._filelist[self._rank::self._world]

    def _read_file(self, path):
        if self._pipe_command:
            with open(path, "rb") as f:
                out = subprocess.run(
                    self._pipe_command, shell=True, stdin=f,
                    capture_output=True, check=True)
            lines = out.stdout.decode("utf-8").splitlines()
        else:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        parse = self._parse_fn or (lambda s: s)
        return [parse(ln) for ln in lines if ln]


class InMemoryDataset(_DatasetBase):
    """reference: data_set.h InMemoryDataset (global/local shuffle)."""

    def __init__(self, rank=None, world_size=None, name=None):
        super().__init__(rank, world_size, name=name)
        self._records = []
        self._loaded = False
        self._epoch = 0
        self._generation = 0  # per-instance global_shuffle call counter
        self._prev_ns = None  # namespace the PREVIOUS generation used

    def _spool_namespace(self) -> str:
        """Deterministic, SPMD-agreeing namespace isolating this
        dataset's spool files from other datasets sharing the same
        spool_dir: the explicit ``name=`` when given, else a fingerprint
        of the filelist (every rank sets the identical full filelist, so
        the hash agrees without coordination).  Two datasets with the
        SAME filelist sharing one spool_dir must be given distinct
        names."""
        if self._name:
            return str(self._name)
        h = hashlib.md5("\n".join(self._filelist).encode()).hexdigest()
        return f"ds{h[:8]}"

    # -- reference API -------------------------------------------------
    def load_into_memory(self):
        self._records = []
        for path in self._my_files():
            self._records.extend(self._read_file(path))
        self._loaded = True

    def set_epoch(self, epoch):
        self._epoch = int(epoch)

    def local_shuffle(self, seed=None):
        seed = self._effective_seed(seed)
        # decorrelate ranks: same epoch seed must not give every worker
        # the same permutation pattern
        rs = np.random.RandomState((seed * 1000003 + self._rank)
                                   % (2 ** 31))
        order = rs.permutation(len(self._records))
        self._records = [self._records[i] for i in order]

    def global_shuffle(self, fleet=None, thread_num=None, seed=None,
                      spool_dir=None, timeout=120.0):
        """Seed-deterministic cross-worker shuffle; see module docstring.

        After this call each worker holds a disjoint contiguous chunk of
        the global permutation; the union over workers is the full
        dataset exactly once.  ``spool_dir`` must be a directory all
        workers can read/write (defaults to $PADDLE_TPU_SPOOL_DIR).
        ``fleet``/``thread_num`` are accepted for reference parity.
        """
        if not self._loaded:
            raise RuntimeError("call load_into_memory() before "
                               "global_shuffle() (reference semantics)")
        seed = self._effective_seed(seed)
        if self._world == 1:
            rs = np.random.RandomState(seed % (2 ** 31))
            order = rs.permutation(len(self._records))
            self._records = [self._records[i] for i in order]
            return

        spool_dir = spool_dir or os.environ.get("PADDLE_TPU_SPOOL_DIR")
        if not spool_dir:
            raise ValueError(
                "global_shuffle with world_size > 1 needs a shared "
                "spool_dir (arg or $PADDLE_TPU_SPOOL_DIR)")
        # generation counter in the root: every worker makes the same
        # sequence of global_shuffle calls (SPMD discipline), so the
        # counter agrees without coordination — and a repeated seed can
        # never satisfy the barriers with a previous call's sentinels.
        # Different jobs must still use distinct spool dirs.
        gen = self._generation
        self._generation += 1
        ns = self._spool_namespace()
        prev_ns, self._prev_ns = self._prev_ns, ns
        root = os.path.join(spool_dir, f"{ns}_gs_{gen}_{seed}")
        os.makedirs(root, exist_ok=True)

        # phase 1: publish local counts; derive global offsets
        n_local = len(self._records)
        with open(os.path.join(root, f"count_{self._rank}.json.tmp"),
                  "w") as f:
            json.dump(n_local, f)
        os.replace(os.path.join(root, f"count_{self._rank}.json.tmp"),
                   os.path.join(root, f"count_{self._rank}.json"))
        count_files = [os.path.join(root, f"count_{r}.json")
                       for r in range(self._world)]
        _wait_for(count_files, timeout, "record counts")
        counts = [json.load(open(p)) for p in count_files]
        total = sum(counts)
        my_off = sum(counts[:self._rank])

        # phase 2: identical global permutation + contiguous chunking
        rs = np.random.RandomState(seed % (2 ** 31))
        pi = rs.permutation(total)          # position p holds record pi[p]
        pos_of = np.argsort(pi)             # record g sits at position
        base, rem = divmod(total, self._world)
        starts = [r * base + min(r, rem) for r in range(self._world + 1)]

        def owner(pos):
            # inverse of the contiguous chunking above (first `rem`
            # ranks hold base+1 records; when base == 0 every position
            # falls in the first branch since hi == total)
            hi = (base + 1) * rem
            if pos < hi:
                return pos // (base + 1)
            return rem + (pos - hi) // base

        # phase 3: bucket my records by destination, spool, barrier
        outgoing = [[] for _ in range(self._world)]
        for i, rec in enumerate(self._records):
            g = my_off + i
            pos = int(pos_of[g])
            outgoing[owner(pos)].append((pos, rec))
        for t in range(self._world):
            tmp = os.path.join(root, f"data_{self._rank}_to_{t}.pkl.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(outgoing[t], f)
            os.replace(tmp, os.path.join(root,
                                         f"data_{self._rank}_to_{t}.pkl"))

        # phase 4: gather my chunk, order by global position
        inbox = [os.path.join(root, f"data_{s}_to_{self._rank}.pkl")
                 for s in range(self._world)]
        _wait_for(inbox, timeout, "spooled shards")
        mine = []
        for p in inbox:
            with open(p, "rb") as f:
                mine.extend(pickle.load(f))
        mine.sort(key=lambda t: t[0])
        expect = starts[self._rank + 1] - starts[self._rank]
        if len(mine) != expect:  # protocol invariant, not data-dependent
            raise RuntimeError(
                f"global_shuffle: rank {self._rank} received {len(mine)} "
                f"records, expected {expect}")
        self._records = [rec for _, rec in mine]
        # done sentinel: proves this worker finished READING, which is
        # what makes the deferred cleanup below safe
        open(os.path.join(root, f"done_{self._rank}"), "w").close()
        self._reap_previous_generation(spool_dir, gen, prev_ns)

    def _reap_previous_generation(self, spool_dir, gen, prev_ns):
        """Delete generation ``gen - 1``'s spool once every worker's done
        sentinel proves no one still reads it (rank 0 only, best effort:
        a missing sentinel just defers cleanup).  ``prev_ns`` is the
        namespace that generation was WRITTEN under — set_filelist
        between shuffles changes the fingerprint, and reaping under the
        new one would orphan the old dirs."""
        if self._rank != 0 or gen == 0 or prev_ns is None:
            return
        prev = _glob.glob(os.path.join(
            spool_dir, f"{prev_ns}_gs_{gen - 1}_*"))
        for d in prev:
            if all(os.path.exists(os.path.join(d, f"done_{r}"))
                   for r in range(self._world)):
                try:
                    for f in _glob.glob(os.path.join(d, "*")):
                        os.unlink(f)
                    os.rmdir(d)
                except OSError:  # pragma: no cover - concurrent reap
                    pass

    def release_memory(self):
        self._records = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._records)

    def _effective_seed(self, seed):
        if seed is not None:
            return int(seed)
        # epoch-folded default: one reshuffle per epoch, same on every
        # worker (reference: fleet.global_shuffle called per epoch)
        return 9973 * self._epoch + 17

    # -- python dataset protocol (DataLoader interop) -----------------
    def __len__(self):
        return len(self._records)

    def __getitem__(self, idx):
        return self._records[idx]

    def __iter__(self):
        return iter(self._records)


class QueueDataset(_DatasetBase):
    """Streaming file-shard reader (reference: data_set.h QueueDataset —
    no global shuffle support, single pass)."""

    def global_shuffle(self, *a, **kw):
        raise RuntimeError("QueueDataset does not support global_shuffle "
                           "(reference parity: data_set.h QueueDataset)")

    def local_shuffle(self, *a, **kw):
        raise RuntimeError("QueueDataset does not support local_shuffle "
                           "(reference parity)")

    def __iter__(self):
        for path in self._my_files():
            yield from self._read_file(path)


class DatasetFactory:
    """reference: fluid/dataset.py DatasetFactory.create_dataset."""

    _KINDS = {"InMemoryDataset": InMemoryDataset,
              "QueueDataset": QueueDataset}

    def create_dataset(self, datafeed_class="QueueDataset", rank=None,
                       world_size=None, name=None):
        if datafeed_class not in self._KINDS:
            raise ValueError(
                f"unknown dataset class {datafeed_class!r}; expected one "
                f"of {sorted(self._KINDS)}")
        return self._KINDS[datafeed_class](rank=rank, world_size=world_size,
                                           name=name)


