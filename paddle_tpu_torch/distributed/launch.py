"""Start the ranks of a job on this host (the ``spawn`` part of
``paddle_tpu/distributed/launch.py``).

:func:`spawn` runs ``func(*args)`` in ``nprocs`` fresh processes
(``multiprocessing``'s spawn context: ``func`` must be importable), one
per card, or one per CPU process under gloo.  Each child gets ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE``, and the rendezvous: ``init_method``
as ``DIST_INIT_METHOD`` when given (a ``file://`` store, or
``tcp://localhost:<port>``), else ``MASTER_ADDR`` / ``MASTER_PORT`` on
a free local port.
``init_parallel_env`` in the child reads them.  The parent watches the
children and ends the rest when one exits non-zero.
"""
from __future__ import annotations

import multiprocessing
import os
import socket
import time
from typing import Optional

__all__ = ["spawn", "free_port"]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, nprocs, env, func, args):
    # module level: the spawn context pickles the target
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    func(*args)


def _stop(procs, alive):
    for i in alive:
        procs[i].terminate()
    for i in alive:
        procs[i].join(10)
        if procs[i].is_alive():
            procs[i].kill()
            procs[i].join()


def spawn(func, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, init_method: Optional[str] = None,
          timeout: Optional[float] = None):
    """``paddle.distributed.spawn`` parity.  Returns the processes; with
    ``join`` it waits for all of them and raises ``RuntimeError`` if one
    failed (the rest are ended) or ``timeout`` seconds pass."""
    ctx = multiprocessing.get_context("spawn")
    if init_method is not None:
        child_env = {"DIST_INIT_METHOD": init_method}
    else:
        child_env = {"MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": str(free_port())}
    procs = [ctx.Process(target=_entry,
                         args=(rank, nprocs, child_env, func, args),
                         daemon=daemon) for rank in range(nprocs)]
    for p in procs:
        p.start()
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    alive = set(range(nprocs))
    failed = None
    try:
        while alive:
            for i in list(alive):
                code = procs[i].exitcode
                if code is None:
                    continue
                alive.discard(i)
                if code != 0 and failed is None:
                    failed = (i, code)
            if failed is not None:
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = (None, "timeout")
                break
            time.sleep(0.05)
    finally:
        _stop(procs, alive)
    if failed is not None:
        rank, code = failed
        raise RuntimeError(f"spawned rank {rank} failed: {code}"
                           if rank is not None else
                           f"spawned ranks did not finish in {timeout} s")
    return procs
