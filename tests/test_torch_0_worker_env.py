"""The OpenMP wait policy of a test process, set before torch loads.

pytest imports every test file of a run, in name order, before it runs
any test, and with ``-p xdist`` each worker process does so itself.
This file's name sorts first among the port's test files and no test
file before it imports torch, so in a run of the whole suite the line
below runs in each process before torch's OpenMP runtime reads its
environment (it does so once, when torch is imported).

Why: tier-1 runs six workers on one machine, each with torch's default
intra-op pool (one thread a core).  OpenMP's default policy keeps an
idle thread spinning at each barrier, so six pools spin against each
other and against the JAX workers: the port's heaviest test files took
2.5x their worker-seconds.  ``PASSIVE`` puts idle threads to sleep
instead.  The pools keep their size, so every reduction keeps its order
and every result its bits.  A policy the caller's environment sets is
kept."""
import os
import sys

_TORCH_LOADED_BEFORE = "torch" in sys.modules
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")


def test_torch_loads_after_the_wait_policy_is_set():
    """No test file collected before this one loaded torch, so the policy
    was in the environment when torch's OpenMP runtime read it."""
    assert not _TORCH_LOADED_BEFORE, (
        "torch was imported before this file: the wait policy came too "
        "late for this process")
    assert os.environ["OMP_WAIT_POLICY"]
