"""Start the ranks of a job (the counterpart of
``paddle_tpu/distributed/launch.py``): :func:`launch` and its command
line, ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
N script.py ...``, and :func:`spawn`.

:func:`launch` starts ``nproc_per_node`` local processes of a script,
each with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (and paddle's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``), the ``torch.distributed`` rendezvous that
``init_parallel_env`` reads where paddle_tpu sets the JAX coordinator
variables.  Several hosts: run it on each host of ``--ips`` with its
``--node_rank``; a rank is ``node_rank * nproc_per_node + local`` of a
world of ``len(ips) * nproc_per_node`` and the first host is the
master.  The launcher watches its processes: when one exits non-zero
the rest are ended, and ``timeout`` ends them all (exit 124).

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

import argparse
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main", "spawn", "free_port"]


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


def _worker_env(rank: int, local: int, world: int, master: str,
                port: int) -> dict:
    env = dict(os.environ)
    env.update({
        "RANK": str(rank), "LOCAL_RANK": str(local),
        "WORLD_SIZE": str(world), "MASTER_ADDR": master,
        "MASTER_PORT": str(port),
        # paddle's names, for scripts that read them
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
    })
    return env


def launch(training_script: str, script_args: Optional[List[str]] = None,
           nproc_per_node: int = 1, ips: Optional[str] = None,
           node_rank: int = 0, master_port: int = 6170,
           log_dir: Optional[str] = None,
           timeout: Optional[float] = None) -> int:
    """Start ``nproc_per_node`` local processes of ``training_script``
    with the rendezvous environment set, watch them, and end the rest
    when one fails (or all when ``timeout`` seconds pass: exit 124).
    Returns the first non-zero exit code, or 0.  ``log_dir`` sends each
    rank's output to ``worker.<rank>.log`` there."""
    script_args = list(script_args or [])
    hosts = ips.split(",") if ips else ["127.0.0.1"]
    if not 0 <= node_rank < len(hosts):
        raise ValueError(f"node_rank {node_rank} out of range for "
                         f"{len(hosts)} hosts")
    world = len(hosts) * nproc_per_node
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs: List[subprocess.Popen] = []
    logs = []
    try:
        for local in range(nproc_per_node):
            rank = node_rank * nproc_per_node + local
            out = (open(os.path.join(log_dir, f"worker.{rank}.log"), "w")
                   if log_dir else None)
            if out is not None:
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, training_script, *script_args],
                env=_worker_env(rank, local, world, hosts[0], master_port),
                stdout=out, stderr=subprocess.STDOUT if out else None))
        rc = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        alive = set(range(len(procs)))
        while alive:
            if deadline is not None and time.monotonic() > deadline:
                rc = rc or 124          # the job's deadline (a hung rank)
                break
            for i in list(alive):
                code = procs[i].poll()
                if code is None:
                    continue
                alive.discard(i)
                if code != 0:
                    rc = rc or code
            if rc:
                break                   # one rank failed: end the rest
            time.sleep(0.1)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        rc = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return rc


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="start the ranks of a torch.distributed job with "
                    "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT set")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--ips", type=str, default=None,
                    help="comma-separated hosts; the first is the master")
    ap.add_argument("--node_rank", type=int, default=0,
                    help="this host's index into --ips")
    ap.add_argument("--master_port", type=int, default=6170)
    ap.add_argument("--log_dir", type=str, default=None)
    ap.add_argument("--timeout", type=float, default=None,
                    help="end every rank after this many seconds (exit "
                         "124)")
    ap.add_argument("training_script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    sys.exit(launch(ns.training_script, ns.script_args,
                    nproc_per_node=ns.nproc_per_node, ips=ns.ips,
                    node_rank=ns.node_rank, master_port=ns.master_port,
                    log_dir=ns.log_dir, timeout=ns.timeout))


if __name__ == "__main__":
    main()
