"""The DataLoader's worker processes (the twins of
``tests/test_dataloader_mp.py`` and of the self-healing DataLoader cases
of ``tests/test_fault_tolerance.py``): batches over shared memory equal
paddle_tpu's synchronous loader's, worker errors surface, a custom
collation crosses, a killed worker is respawned and its batches dealt
again exactly once in order, a batch that keeps killing workers
exhausts its budget, the stall timeout, the crash loop; and what only
the port has to hold: a worker makes no CUDA context and a paddle
Tensor made in one lands on the CPU.

The port runs the worker path; paddle_tpu's synchronous loader over the
same numpy dataset is the reference (its own worker processes are its
tests').  The workers are 1-2 a loader and the datasets tiny."""
import functools
import json
import os
import time

import numpy as np
import pytest

from paddle_tpu import io as jio

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.io.multiprocess import WorkerCrashLoop
from paddle_tpu_torch.testing import fault
from paddle_tpu_torch.utils import monitor


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    fault.disarm()
    monitor.stat_reset()
    flags = tpaddle.get_flags(["dataloader_batch_retries",
                               "dataloader_crashloop_budget",
                               "dataloader_respawn_backoff_s"])
    yield
    fault.disarm()
    tpaddle.set_flags(flags)
    placement.set_default(None)


def _close(loader):
    pool = getattr(loader, "_mp_pool", None)
    if pool is not None:
        pool.close()
        loader._mp_pool = None


class _ArrayDs(tio.Dataset):
    def __init__(self, n=64, d=8):
        self.x = np.arange(n * d, dtype=np.float32).reshape(n, d)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


class _SlowPythonDs(tio.Dataset):
    """A GIL-bound ``__getitem__``."""

    def __init__(self, n=16, work=20000):
        self.n = n
        self.work = work

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        acc = 0
        for k in range(self.work):
            acc += (i * k) % 7
        return np.asarray([float(acc), float(i)], np.float32)


class _FailingDs(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(2, np.float32)


class _SleepyDs(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(30)
        return np.zeros(2, np.float32)


class _TensorDs(tio.Dataset):
    """Samples made as paddle Tensors inside the worker, with the
    worker's CUDA state beside them."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        import torch
        t = tpaddle.to_tensor(np.full(3, i, np.float32))
        return t, np.int64(torch.cuda.is_initialized()), \
            np.int64(t.place == "cpu")


def _record(d, worker_id):
    import torch
    with open(os.path.join(d, f"w{worker_id}-{os.getpid()}.json"), "w") as f:
        json.dump({"cuda": torch.cuda.is_initialized()}, f)


def _collect(batches):
    return [(b[0].numpy(), b[1].numpy()) for b in batches]


def test_mp_loader_matches_paddle_tpu_sync_loader():
    ds = _ArrayDs()
    ref = [(np.asarray(x.numpy()), np.asarray(i.numpy()))
           for x, i in jio.DataLoader(ds, batch_size=16, num_workers=0)]
    loader = tio.DataLoader(ds, batch_size=16, num_workers=2)
    try:
        for _ in range(2):              # the pool serves a second epoch
            got = _collect(loader)
            assert len(got) == len(ref) == 4
            for (x, i), (rx, ri) in zip(got, ref):
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(i, ri)
                assert i.dtype == np.int64
    finally:
        _close(loader)


def test_mp_and_thread_paths_agree_on_python_transforms():
    """Processes and threads give the same batches on a GIL-bound
    ``__getitem__`` (the reference test's timing claim is not held
    here: ROADMAP §C lists it as timing-sensitive)."""
    ds = _SlowPythonDs()
    ref = [np.asarray(b.numpy()) for b in jio.DataLoader(ds, batch_size=4)]
    out = {}
    for shm in (False, True):
        loader = tio.DataLoader(ds, batch_size=4, num_workers=2,
                                use_shared_memory=shm)
        try:
            assert sum(1 for _ in loader) == 4
            out[shm] = [b.numpy() for b in loader]
        finally:
            _close(loader)
    for a, b, r in zip(out[False], out[True], ref):
        np.testing.assert_array_equal(a, r)
        np.testing.assert_array_equal(b, r)


def test_mp_loader_surfaces_worker_errors():
    loader = tio.DataLoader(_FailingDs(), batch_size=4, num_workers=2)
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(loader)
    assert loader._mp_pool is None        # torn down, not leaked


def _dict_collate(samples):
    xs = np.stack([s[0] for s in samples])
    return {"x2": xs * 2.0, "n": np.int64(len(samples))}


def test_mp_loader_custom_collate():
    ds = _ArrayDs(n=8)
    ref = list(jio.DataLoader(ds, batch_size=4, collate_fn=_dict_collate))
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2,
                            collate_fn=_dict_collate)
    try:
        got = list(loader)
    finally:
        _close(loader)
    assert len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["x2"].numpy(), r["x2"])
        assert int(g["n"]) == int(r["n"]) == 4


def test_workers_stay_on_the_host(tmp_path):
    """A worker makes no CUDA context (``worker_init_fn`` and the
    samples report it), and a paddle Tensor it makes lands on the CPU
    with no ``set_device`` of its own."""
    loader = tio.DataLoader(_TensorDs(), batch_size=3, num_workers=2,
                            worker_init_fn=functools.partial(
                                _record, str(tmp_path)))
    try:
        batches = list(loader)
    finally:
        _close(loader)
    xs = np.concatenate([b[0].numpy() for b in batches])
    np.testing.assert_array_equal(xs[:, 0], np.arange(6))
    assert all(int(v) == 0 for b in batches for v in b[1].numpy())
    assert all(int(v) == 1 for b in batches for v in b[2].numpy())
    reports = [json.load(open(tmp_path / n)) for n in os.listdir(tmp_path)]
    assert len(reports) == 2 and not any(r["cuda"] for r in reports)


def test_killed_worker_respawned_every_batch_once_in_order():
    ds = _ArrayDs(n=32)
    fault.arm("mp.worker_batch:count=1,action=exit,code=43,"
              "match=batch=3", seed=0)
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2)
    try:
        ids = np.concatenate([i.numpy() for _, i in loader])
        fault.disarm()
        assert list(ids) == list(range(32))
        assert monitor.get_stat("dataloader.worker_restarts") >= 1
        assert monitor.get_stat("dataloader.batch_retries") >= 1
        assert any(code == 43 for _, code in loader._mp_pool.exit_history)
        assert len(list(loader)) == 8     # the healed pool, next epoch
    finally:
        _close(loader)


def test_batch_that_keeps_killing_workers_exhausts_budget():
    tpaddle.set_flags({"dataloader_batch_retries": 1})
    fault.arm("mp.worker_batch:action=exit,code=9,respawn=1", seed=0)
    loader = tio.DataLoader(_ArrayDs(n=16), batch_size=8, num_workers=1)
    try:
        with pytest.raises(RuntimeError,
                           match="worker-death retries.*exit codes"):
            list(loader)
    finally:
        fault.disarm()
        _close(loader)
    assert monitor.get_stat("dataloader.worker_restarts") >= 1


def test_dataloader_timeout_configurable_and_diagnostic():
    loader = tio.DataLoader(_SleepyDs(), batch_size=2, num_workers=1,
                            timeout=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stalled.*alive"):
        list(loader)
    assert time.monotonic() - t0 < 20


def test_dataloader_crash_loop_gives_up_with_exit_history():
    tpaddle.set_flags({"dataloader_crashloop_budget": 2,
                       "dataloader_respawn_backoff_s": 0.01,
                       "dataloader_batch_retries": 50})
    loader = tio.DataLoader(_ArrayDs(n=16), batch_size=8, shuffle=False,
                            num_workers=2)
    fault.arm("mp.worker_batch:action=exit,code=9,respawn=1")
    try:
        with pytest.raises(WorkerCrashLoop, match="crash-looping") as ei:
            for _ in loader:
                pass
        assert len(ei.value.exit_history) >= 3
        assert monitor.get_stat("dataloader.worker_restarts") <= 2
    finally:
        fault.disarm()
        _close(loader)
