"""``io`` held to paddle_tpu's: datasets, samplers, collation, the
synchronous and thread-pool DataLoader paths, ``fetch_batch`` and the
``dataloader.batch`` fault point (the io cases of
``tests/test_highlevel.py``, the sampler case of
``tests/test_dataloader_mp.py``, the thread-path timeout of
``tests/test_fault_tolerance.py`` and ``tests/test_anomaly.py``'s
``test_dataloader_corrupt_point_and_fetch_batch_redelivery``).

Every case feeds the same numpy data to both packages and compares what
comes out exactly (the loaders move data, they compute nothing).  Kept
differences: the port keeps int64 where paddle_tpu's batches are int32
(JAX without x64), and ``RandomSampler``'s order comes from the port's
own generator."""
import time

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import io as jio
from paddle_tpu.testing import fault as jfault

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.testing import fault as tfault

SIDES = {"jax": (jpaddle, jio, jfault), "torch": (tpaddle, tio, tfault)}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    tpaddle.seed(2024)
    for _, _, fault in SIDES.values():
        fault.disarm()
    yield
    for _, _, fault in SIDES.values():
        fault.disarm()
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


def _tree(batch):
    """A batch as nested lists of numpy arrays."""
    if isinstance(batch, (list, tuple)):
        return [_tree(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _tree(v) for k, v in batch.items()}
    return _np(batch)


def _same(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def _both(make):
    return {side: [_tree(b) for b in make(io)]
            for side, (_, io, _) in SIDES.items()}


def test_tensor_dataset_dataloader():
    X = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    Y = np.arange(20).astype(np.int64)
    out = _both(lambda io: io.DataLoader(io.TensorDataset([X, Y]),
                                         batch_size=6, shuffle=False))
    _same(out["torch"], out["jax"])
    assert len(out["torch"]) == 4 and out["torch"][-1][0].shape == (2, 3)
    np.testing.assert_array_equal(out["torch"][0][1], [0, 1, 2, 3, 4, 5])


def test_tensor_dataset_takes_tensors():
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    ds = tio.TensorDataset([tpaddle.to_tensor(X), np.arange(6)])
    x, y = ds[4]
    np.testing.assert_array_equal(x, X[4])
    assert int(y) == 4 and len(ds) == 6


@pytest.mark.parametrize("side", sorted(SIDES))
def test_dataloader_shuffle_covers_all(side):
    _, io, _ = SIDES[side]
    ds = io.TensorDataset([np.arange(10).astype(np.float32)])
    seen = np.concatenate([_np(b[0]) for b in io.DataLoader(
        ds, batch_size=3, shuffle=True)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(10))


def test_random_sampler_draws_from_the_seed():
    ds = tio.TensorDataset([np.arange(50).astype(np.float32)])

    def order():
        tpaddle.seed(11)
        return [i for i in tio.RandomSampler(ds)]
    a, b = order(), order()
    assert a == b and sorted(a) == list(range(50)) and a != sorted(a)
    tpaddle.seed(11)
    s = tio.RandomSampler(ds)
    assert list(s) != list(s)            # a new draw each epoch
    r = tio.RandomSampler(ds, replacement=True, num_samples=7)
    assert len(list(r)) == 7 == len(r)


def test_dataloader_thread_workers_ordered():
    ds_np = np.arange(30).astype(np.float32)
    out = _both(lambda io: io.DataLoader(
        io.TensorDataset([ds_np]), batch_size=5, shuffle=False,
        num_workers=3, use_shared_memory=False))
    _same(out["torch"], out["jax"])
    np.testing.assert_array_equal(np.concatenate(
        [b[0] for b in out["torch"]]), ds_np)


class _DictDs:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return {"x": np.full(2, i, np.float32), "y": i,
                "w": float(i) / 2}


def test_custom_dataset_and_dict_collate():
    out = _both(lambda io: io.DataLoader(_DictDs(), batch_size=4))
    _same(out["torch"], out["jax"])
    b = out["torch"][0]
    assert b["x"].shape == (4, 2) and b["w"].dtype == np.float32
    assert b["y"].dtype == np.int64 and out["jax"][0]["y"].dtype == np.int32


def test_collate_keeps_numpy_dtypes():
    """The port keeps a sample's numpy dtype (int32 ids stay int32,
    int64 labels int64); Python floats take float32 and Python ints
    int64, as ``to_tensor`` makes them."""
    samples = [(np.arange(3, dtype=np.int32) + i, np.int64(i), 0.5, i)
               for i in range(4)]
    ids, lab, f, n = tio.default_collate_fn(samples)
    assert (ids.dtype, lab.dtype, f.dtype, n.dtype) == (
        tpaddle.int32, tpaddle.int64, tpaddle.float32, tpaddle.int64)
    np.testing.assert_array_equal(_np(ids)[:, 0], [0, 1, 2, 3])
    with pytest.raises(TypeError):
        tio.default_collate_fn([("a",), ("b",)])


def test_distributed_batch_sampler_shards():
    got = {}
    for side, (_, io, _) in SIDES.items():
        ds = io.TensorDataset([np.arange(10).astype(np.float32)])
        s0 = io.DistributedBatchSampler(ds, 2, num_replicas=2, rank=0)
        s1 = io.DistributedBatchSampler(ds, 2, num_replicas=2, rank=1)
        i0 = [i for b in s0 for i in b]
        i1 = [i for b in s1 for i in b]
        assert len(i0) == len(i1) == 5 and len(s0) == 3
        assert set(i0) | set(i1) == set(range(10))
        got[side] = (i0, i1)
    assert got["torch"] == got["jax"]


def test_distributed_global_shuffle_epochs():
    """``shuffle=True`` is one epoch-seeded global permutation cut per
    rank: samples move between ranks across epochs, the ranks agree,
    and the cut is paddle_tpu's."""
    per = {}
    for side, (_, io, _) in SIDES.items():
        ds = io.TensorDataset([np.arange(32).astype(np.float32)])
        epochs = {}
        for epoch in (0, 1, 3):
            owners = {}
            for rank in range(4):
                s = io.DistributedBatchSampler(
                    ds, batch_size=4, num_replicas=4, rank=rank,
                    shuffle=True)
                s.set_epoch(epoch)
                for batch in s:
                    for idx in batch:
                        owners[idx] = rank
            assert len(owners) == 32
            epochs[epoch] = owners
        moved = sum(epochs[0][i] != epochs[1][i] for i in range(32))
        assert moved > 8
        per[side] = epochs
    assert per["torch"] == per["jax"]


def test_random_split_matches_paddle_tpu():
    """The split's permutation is ``RandomState(seed)``'s in both."""
    parts = {}
    for side, (paddle, io, _) in SIDES.items():
        paddle.seed(77)
        ds = io.TensorDataset([np.arange(10).astype(np.float32)])
        a, b = io.random_split(ds, [7, 3])
        assert len(a) == 7 and len(b) == 3
        parts[side] = (a.indices, b.indices)
    assert parts["torch"] == parts["jax"]


def test_concat_chain_subset_and_iterable():
    class Stream:
        def __init__(self, io, lo, hi):
            self.cls = type("S", (io.IterableDataset,), {
                "__iter__": lambda s: iter(
                    np.arange(lo, hi, dtype=np.float32)[:, None])})

    got = {}
    for side, (_, io, _) in SIDES.items():
        a = io.TensorDataset([np.arange(5).astype(np.float32)])
        b = io.TensorDataset([np.arange(5, 9).astype(np.float32)])
        cat = io.ConcatDataset([a, b])
        sub = io.Subset(cat, [8, 0, 5])
        chain = io.ChainDataset([Stream(io, 0, 3).cls(),
                                 Stream(io, 10, 12).cls()])
        got[side] = (len(cat), [float(cat[i][0]) for i in range(9)],
                     [float(sub[i][0]) for i in range(3)],
                     [_tree(x) for x in io.DataLoader(chain, batch_size=2)],
                     [_tree(x) for x in io.DataLoader(chain, batch_size=2,
                                                      drop_last=True)])
    t, j = got["torch"], got["jax"]
    assert t[:3] == j[:3]
    _same(t[3], j[3])
    _same(t[4], j[4])
    assert len(t[3]) == 3 and len(t[4]) == 2
    with pytest.raises(TypeError):
        len(tio.DataLoader(tio.ChainDataset([]), batch_size=2))


def test_samplers_and_batch_sampler_lengths():
    for side, (_, io, _) in SIDES.items():
        ds = io.TensorDataset([np.arange(10).astype(np.float32)])
        assert list(io.SequenceSampler(ds)) == list(range(10))
        for drop, n in ((False, 4), (True, 3)):
            bs = io.BatchSampler(ds, batch_size=3, drop_last=drop)
            assert len(bs) == n == len(list(bs))
        w = io.WeightedRandomSampler([0.0, 0.0, 1.0], 5)
        assert list(w) == [2] * 5 and len(w) == 5
        bs = io.BatchSampler(sampler=io.SequenceSampler(ds), batch_size=4)
        loader = io.DataLoader(ds, batch_sampler=bs)
        assert len(loader) == 3
        assert io.get_worker_info() is None


def test_thread_path_collate_fn_returning_tensors():
    def collate(samples):
        return tpaddle.to_tensor(np.stack([s[0] for s in samples])) * 2
    ds = tio.TensorDataset([np.arange(8).astype(np.float32)])
    out = [_np(b) for b in tio.DataLoader(ds, batch_size=4, num_workers=2,
                                          use_shared_memory=False,
                                          collate_fn=collate)]
    np.testing.assert_array_equal(np.concatenate(out), np.arange(8) * 2)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_dataloader_corrupt_point_and_fetch_batch_redelivery(side):
    _, io, fault = SIDES[side]

    class DS:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full(2, float(i), np.float32)

    loader = io.DataLoader(DS(), batch_size=2, shuffle=False)
    fault.arm("dataloader.batch:action=corrupt,mode=nan,count=1,"
              "match=batch=1")
    batches = [_np(b) for b in loader]
    assert np.isnan(batches[1]).any() and not np.isnan(batches[0]).any()
    assert not np.isnan(batches[2]).any()
    again = _np(loader.fetch_batch(1))
    assert not np.isnan(again).any()
    np.testing.assert_array_equal(again, [[2.0, 2.0], [3.0, 3.0]])
    assert fault.fire_count("dataloader.batch") == 1
    with pytest.raises(IndexError):
        loader.fetch_batch(9)


class _SleepyDs:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(5)
        return np.zeros(2, np.float32)


def test_dataloader_timeout_flag_thread_path():
    tpaddle.set_flags({"dataloader_timeout": 1})
    try:
        loader = tio.DataLoader(_SleepyDs(), batch_size=2, num_workers=1,
                                use_shared_memory=False)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stalled"):
            list(loader)
        assert time.monotonic() - t0 < 4
    finally:
        tpaddle.set_flags({"dataloader_timeout": 120})
