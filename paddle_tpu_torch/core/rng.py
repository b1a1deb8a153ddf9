"""Seeding and random draws (the counterpart of ``paddle_tpu.core.rng``).

- :func:`seed` sets the one global seed; :func:`generator` hands out a
  ``torch.Generator`` per device, seeded from it, for the random ops
  that draw on the device (``F.dropout``).  The streams differ from the
  JAX package's threefry keys: the same seed gives other masks.
- :func:`next_seed` draws the int32 seed of one flash-attention dropout
  call from a host generator, so a training step never waits on the
  card for it.  Every call draws anew, so dropout differs from step to
  step.
- :func:`fold_in` switches every draw (both kinds above) to a stream of
  its own, one per key and enclosing stream, for the duration of a
  ``with`` block; the stream carries on where it stopped at the next
  entry.  The data parallel step draws from the stream of its 'dp' rank
  (the JAX package folds ``axis_index('dp')`` into its dropout key), so
  the dp ranks' masks differ and the ranks of one dp group share
  theirs; ``TrainStep``'s microbatches each draw from a stream of their
  own inside it.
- :func:`seed_scope` runs a block on the stream of one seed and puts
  the state back after it (``StaticFunction.concrete``'s pure function
  takes its draws from the int key it is given).
- :func:`get_rng_state` / :func:`set_rng_state` take and put back every
  draw's state: the active stream, the host generator's and every
  device generator's state, and the fold_in streams not in use.
  ``parallel.recompute`` runs its second forward between a
  ``set_rng_state`` of the state taken before the first and one of the
  state it found, so the recomputed forward draws the first one's
  dropout (the counterpart of the JAX package's ``StableDraw``).
- :func:`mul32` / :func:`fmix32`: uint32 arithmetic emulated exactly in
  int64, for the counter-based hashes whose CUDA versions work in
  uint32 (the serving sampler, the flash-attention dropout mask).
- :func:`dropout_threshold`: the 16-bit quantised dropout rule shared by
  ``F.dropout`` and the flash-attention kernels.
- :class:`StableDraw`: one :func:`next_seed` drawn when it is made and
  handed out by every ``key()`` after (the counterpart of the JAX
  package's ``stable_draw``, whose key is a threefry key, not an int).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state",
           "RngState", "generator", "next_seed", "next_key", "seed_scope",
           "fold_in",
           "mul32", "fmix32", "dropout_threshold", "StableDraw"]

M32 = 0xFFFFFFFF

_lock = threading.Lock()
_seed = 0
# the stream draws come from: its seed (``_seed`` itself outside any
# fold_in), next_seed calls since the last seed(), and its generators
_active = 0
_draws = 0
_host: Optional[torch.Generator] = None
_devices: Dict[torch.device, torch.Generator] = {}
# (enclosing stream's seed, fold_in key) -> that stream while unused
_stash: Dict[Tuple[int, int], tuple] = {}


def seed(s: int) -> int:
    """``paddle.seed`` parity: reseed every generator of this module."""
    global _seed, _active, _draws, _host, _devices
    with _lock:
        _seed = _active = int(s)
        _draws, _host, _devices = 0, None, {}
        _stash.clear()
    return _seed


class RngState(NamedTuple):
    """Every draw's state (:func:`get_rng_state`): generator states are
    copies (``torch.Generator.get_state()``), None where a generator
    was not created yet."""
    seed: int
    active: int
    draws: int
    host: Optional[torch.Tensor]
    devices: Dict[torch.device, torch.Tensor]
    stash: Dict[Tuple[int, int], tuple]


def _stream_state(host, devices):
    return (None if host is None else host.get_state(),
            {d: g.get_state() for d, g in devices.items()})


def _generators(host_state, device_states):
    def made(dev, state):
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        return gen
    host = None if host_state is None else made("cpu", host_state)
    return host, {d: made(d, st) for d, st in device_states.items()}


def get_rng_state() -> RngState:
    """The state of every draw this module hands out: the seed, the
    active stream (its seed and host draws so far), the host generator
    and every device generator, and the fold_in streams not in use.
    Reads no device memory: a generator's state is its seed and offset,
    kept on the host."""
    with _lock:
        stash = {k: (a, n) + _stream_state(h, ds)
                 for k, (a, n, h, ds) in _stash.items()}
        return RngState(_seed, _active, _draws,
                        *_stream_state(_host, _devices), stash)


def set_rng_state(state: RngState) -> None:
    """Put back a :func:`get_rng_state`: the next draws are the ones
    that followed it.  Fresh generators carry the states, so a state
    can be put back any number of times."""
    global _seed, _active, _draws, _host, _devices
    host, devices = _generators(state.host, state.devices)
    stash = {}
    for k, (a, n, hs, ds) in state.stash.items():
        stash[k] = (a, n) + _generators(hs, ds)
    with _lock:
        _seed, _active, _draws = state.seed, state.active, state.draws
        _host, _devices = host, devices
        _stash.clear()
        _stash.update(stash)


class _GlobalGenerator:
    """paddle_tpu's ``default_generator()`` over this module's one
    stream: ``initial_seed`` is the seed :func:`seed` last set,
    ``next_key`` a :func:`next_seed` draw."""

    @property
    def initial_seed(self) -> int:
        return _seed

    def manual_seed(self, s: int):
        seed(s)
        return self

    def next_key(self) -> int:
        return next_seed()


_global_generator = _GlobalGenerator()


def default_generator() -> _GlobalGenerator:
    return _global_generator


def generator(device: Union[str, torch.device]) -> torch.Generator:
    """The generator of ``device``, created and seeded at first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _devices.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_active)
            _devices[dev] = gen
        return gen


def next_seed() -> int:
    """A fresh int32 seed, drawn on the host."""
    global _draws, _host
    with _lock:
        if _host is None:
            _host = torch.Generator()
            _host.manual_seed(_active + 0x5EED)
        _draws += 1
        return int(torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                                 generator=_host).item())


# the JAX package's name (its ``next_key`` gives a threefry key, the
# port an int32 seed)
next_key = next_seed


@contextlib.contextmanager
def seed_scope(key: int) -> Iterator[None]:
    """Inside the block every draw comes from the stream :func:`seed`
    starts at ``key``; every draw's state from before is put back on
    exit (the counterpart of paddle_tpu's ``seed_scope``, which routes
    draws through a threefry key): one ``key`` gives one set of draws."""
    saved = get_rng_state()
    seed(int(key))
    try:
        yield
    finally:
        set_rng_state(saved)


@contextlib.contextmanager
def fold_in(key: int) -> Iterator[None]:
    """Inside the block, :func:`generator` and :func:`next_seed` draw
    from stream ``key`` of the enclosing stream (the seed's own outside
    any fold_in): deterministic per (seed, keys), distinct across keys
    and from the enclosing stream, and continued where it stopped at
    the next entry with the same key from the same enclosing stream."""
    global _active, _draws, _host, _devices
    key = int(key)
    with _lock:
        outer = (_active, _draws, _host, _devices)
        slot = (_active, key)
        inner = _stash.pop(slot, None)
        if inner is None:
            mixed = (_active * 0x9E3779B97F4A7C15
                     + (key + 1) * 0xBF58476D1CE4E5B9)
            inner = (mixed % (2 ** 63 - 1), 0, None, {})
        _active, _draws, _host, _devices = inner
    try:
        yield
    finally:
        with _lock:
            _stash[slot] = (_active, _draws, _host, _devices)
            _active, _draws, _host, _devices = outer


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32): the product
    is split at 16 bits so no intermediate leaves int64's range."""
    return ((a & 0xFFFF) * c + ((a >> 16) * (c & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(p: float) -> Tuple[int, float]:
    """``p`` quantised to 1/65536: ``(t, scale)``.  A 16-bit draw is
    kept iff it is ``>= t``, and kept values are scaled by ``scale`` so
    the expectation is unchanged exactly.  ``t == 0`` keeps everything
    (scale 1), ``t == 65536`` drops everything (scale 0)."""
    t = min(max(int(round(float(p) * 65536.0)), 0), 65536)
    return t, (0.0 if t >= 65536 else 65536.0 / (65536 - t))


class StableDraw:
    """A seed fixed when the draw is made: ``key()`` gives the same int32
    seed every call, so a replayed op draws what it drew the first
    time."""

    __slots__ = ("_seed",)

    def __init__(self):
        self._seed = next_seed()

    def key(self) -> int:
        return self._seed
