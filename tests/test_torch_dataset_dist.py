"""The fleet dataset family held to paddle_tpu's (the twins of
``tests/test_dataset_dist.py``): the factory, the seeded global shuffle
over a spool directory on simulated workers (threads), the generation
counter and reaping, the epoch-folded seed, the pipe command, the
queue dataset and the DataLoader interop.

Every case runs on both packages; where the shuffle is seeded the two
packages' shards are held equal (the protocol and the draws are
paddle_tpu's)."""
import os
import threading

import numpy as np
import pytest

from paddle_tpu import io as jio

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import placement

IO = {"jax": jio, "torch": tio}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _write_files(d, n_files=4, per_file=5):
    files, recs = [], []
    for i in range(n_files):
        p = os.path.join(str(d), f"part-{i:03d}.txt")
        lines = [f"f{i}r{j}" for j in range(per_file)]
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(p)
        recs.extend(lines)
    return files, recs


@pytest.mark.parametrize("side", sorted(IO))
def test_factory_and_load(tmp_path, side):
    io = IO[side]
    files, recs = _write_files(tmp_path)
    ds = io.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_filelist(files)
    ds.load_into_memory()
    assert list(ds) == recs
    assert len(ds) == len(recs) and ds[0] == "f0r0"
    assert ds.get_memory_data_size() == len(recs)
    with pytest.raises(ValueError):
        io.DatasetFactory().create_dataset("NopeDataset")


def test_single_worker_global_shuffle_matches_paddle_tpu(tmp_path):
    files, recs = _write_files(tmp_path)
    out = {}
    for side, io in IO.items():
        ds = io.InMemoryDataset()
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.global_shuffle(seed=3)
        first = list(ds)
        assert first != recs and sorted(first) == sorted(recs)
        ds.release_memory()
        ds.load_into_memory()
        ds.global_shuffle(seed=3)
        assert list(ds) == first
        ds.load_into_memory()
        ds.global_shuffle(seed=4)
        assert list(ds) != first
        out[side] = first
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("side", sorted(IO))
def test_requires_load_before_shuffle(side):
    ds = IO[side].InMemoryDataset()
    ds.set_filelist([])
    with pytest.raises(RuntimeError):
        ds.global_shuffle(seed=0)


def _run_workers(io, files, spool, world, seed, epoch=None):
    """``world`` simulated workers in threads (the spool protocol has
    real sentinel-file barriers); each worker's records."""
    results = [None] * world
    errors = []

    def work(rank):
        try:
            ds = io.InMemoryDataset(rank=rank, world_size=world)
            ds.set_filelist(files)
            ds.load_into_memory()
            if epoch is not None:
                ds.set_epoch(epoch)
                ds.global_shuffle(spool_dir=str(spool))
            else:
                ds.global_shuffle(seed=seed, spool_dir=str(spool))
            results[rank] = list(ds)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert all(r is not None for r in results)
    return results


@pytest.mark.parametrize("world", [2, 3])
def test_multiworker_global_shuffle_exact_once(tmp_path, world):
    files, recs = _write_files(tmp_path, n_files=5, per_file=4)
    got = {}
    for side, io in IO.items():
        spools = [tmp_path / f"{side}{k}" for k in range(3)]
        for sp in spools:
            sp.mkdir()
        shards = _run_workers(io, files, spools[0], world, seed=11)
        union = [r for shard in shards for r in shard]
        assert sorted(union) == sorted(recs)
        assert len(set(union)) == len(recs)
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1
        assert _run_workers(io, files, spools[1], world, seed=11) == shards
        other = _run_workers(io, files, spools[2], world, seed=12)
        assert other != shards
        assert sorted(r for s in other for r in s) == sorted(recs)
        got[side] = shards
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("side", sorted(IO))
def test_repeated_shuffle_same_spool_same_seed(tmp_path, side):
    io = IO[side]
    files, recs = _write_files(tmp_path, n_files=4, per_file=3)
    spool = tmp_path / "spool"
    spool.mkdir()
    world = 2
    dss = [io.InMemoryDataset(rank=r, world_size=world)
           for r in range(world)]
    for ds in dss:
        ds.set_filelist(files)
    rounds = []
    for _ in range(3):
        results = [None] * world

        def work(rank):
            dss[rank].load_into_memory()
            dss[rank].global_shuffle(seed=42, spool_dir=str(spool))
            results[rank] = list(dss[rank])
        ts = [threading.Thread(target=work, args=(r,))
              for r in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        assert sorted(x for s in results for x in s) == sorted(recs)
        rounds.append(results)
    assert rounds[0] == rounds[1] == rounds[2]
    left = sorted(os.listdir(spool))
    assert len(left) == 1 and left[0].endswith("_gs_2_42"), left


@pytest.mark.parametrize("side", sorted(IO))
def test_reap_follows_namespace_across_filelist_change(tmp_path, side):
    io = IO[side]
    files_a, _ = _write_files(tmp_path, n_files=2, per_file=3)
    d2 = tmp_path / "second"
    d2.mkdir()
    files_b, _ = _write_files(d2, n_files=2, per_file=3)
    spool = tmp_path / "spool"
    spool.mkdir()
    world = 2
    dss = [io.InMemoryDataset(rank=r, world_size=world)
           for r in range(world)]

    def shuffle_round(files):
        def work(rank):
            dss[rank].set_filelist(files)
            dss[rank].load_into_memory()
            dss[rank].global_shuffle(seed=9, spool_dir=str(spool))
        ts = [threading.Thread(target=work, args=(r,))
              for r in range(world)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)

    shuffle_round(files_a)
    ns_a = dss[0]._spool_namespace()
    shuffle_round(files_b)
    left = sorted(os.listdir(spool))
    assert not any(d.startswith(f"{ns_a}_gs_0_") for d in left), left
    assert len(left) == 1 and left[0].endswith("_gs_1_9"), left


def test_epoch_folded_seed(tmp_path):
    files, recs = _write_files(tmp_path, n_files=4, per_file=3)
    got = {}
    for side, io in IO.items():
        sa, sb = tmp_path / f"{side}a", tmp_path / f"{side}b"
        sa.mkdir()
        sb.mkdir()
        e0 = _run_workers(io, files, sa, 2, seed=None, epoch=0)
        e1 = _run_workers(io, files, sb, 2, seed=None, epoch=1)
        assert e0 != e1
        assert sorted(r for s in e1 for r in s) == sorted(recs)
        got[side] = (e0, e1)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("side", sorted(IO))
def test_pipe_command_and_parse_fn(tmp_path, side):
    files, _ = _write_files(tmp_path, n_files=1, per_file=3)
    ds = IO[side].InMemoryDataset()
    ds.set_filelist(files)
    ds.set_pipe_command("sed s/^f/F/")
    ds.set_parse_fn(lambda ln: ln.upper())
    ds.load_into_memory()
    assert list(ds) == ["F0R0", "F0R1", "F0R2"]


@pytest.mark.parametrize("side", sorted(IO))
def test_queue_dataset_streams_shard(tmp_path, side):
    io = IO[side]
    files, recs = _write_files(tmp_path, n_files=4, per_file=2)
    a = io.QueueDataset(rank=0, world_size=2)
    b = io.QueueDataset(rank=1, world_size=2)
    for ds in (a, b):
        ds.set_filelist(files)
    assert sorted(list(a) + list(b)) == sorted(recs)
    with pytest.raises(RuntimeError):
        a.global_shuffle()
    with pytest.raises(RuntimeError):
        a.local_shuffle()


def test_local_shuffle_decorrelates_ranks(tmp_path):
    files, _ = _write_files(tmp_path, n_files=2, per_file=50)
    got = {}
    for side, io in IO.items():
        a = io.InMemoryDataset(rank=0, world_size=2)
        b = io.InMemoryDataset(rank=1, world_size=2)
        for ds in (a, b):
            ds.set_filelist(files)
            ds.load_into_memory()
            ds.local_shuffle(seed=5)
        assert [r[1:] for r in a] != [r[1:] for r in b]
        got[side] = (list(a), list(b))
    assert got["torch"] == got["jax"]


def test_dataloader_interop(tmp_path):
    files, recs = _write_files(tmp_path, n_files=2, per_file=8)
    totals = {}
    for side, io in IO.items():
        ds = io.InMemoryDataset()
        ds.set_filelist(files)
        ds.set_parse_fn(lambda ln: np.float32(len(ln)))
        ds.load_into_memory()
        ds.global_shuffle(seed=1)
        batches = list(io.DataLoader(ds, batch_size=4, shuffle=False))
        assert len(batches) == 4
        totals[side] = [np.asarray(b.numpy()).tolist() for b in batches]
    assert totals["torch"] == totals["jax"]
    assert sum(sum(b) for b in totals["torch"]) == sum(float(len(r))
                                                        for r in recs)


def test_rank_defaults_before_a_process_group():
    """The rank and world come from the launcher's environment, else
    ``distributed.env``: 0 and 1 before ``init_parallel_env``."""
    ds = tio.InMemoryDataset()
    assert (ds._rank, ds._world) == (0, 1)
    import importlib
    fleet = importlib.import_module("paddle_tpu_torch.distributed.fleet")
    assert fleet.InMemoryDataset is tio.InMemoryDataset
    assert isinstance(fleet.DatasetFactory().create_dataset(
        "QueueDataset"), tio.QueueDataset)
