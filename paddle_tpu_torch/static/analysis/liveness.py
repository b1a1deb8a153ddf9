"""Liveness-based peak-memory estimate over a recorded Program (the
counterpart of ``paddle_tpu/static/analysis/liveness.py``).

Interval liveness over the topologically ordered op list predicts what
the card holds before anything runs.  Two bounds:

- ``peak_bytes_donated``: parameters and optimizer slots counted once
  (the port's Executor updates them in place, which is what the JAX
  package's donation buys), plus the gradients and the activations
  kept for the backward;
- ``peak_bytes_no_donation``: the bound where old and new parameters
  and slots coexist at the update.

For a program with no optimizer the two coincide, and the activation
term is the true interval peak (intermediates die at their last reader).

A parameter is read as it is: the Executor updates it in place, so
there is no executor-held copy to look through (the JAX package's
``param_array`` and its escape bookkeeping have no counterpart).

Bytes are the port's own dtypes: an int64 op output (a reshape of int64
labels) is 8 bytes an element here, where paddle_tpu without x64 runs
it as int32; feeds count their declared dtype in both (ROADMAP §C, kept
differences).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..program import Program, Variable, param_aval, to_meta
from .graph import DefUseGraph

__all__ = ["MemoryEstimate", "estimate_memory", "aval_bytes"]


def aval_bytes(aval) -> int:
    """Bytes of one array of ``aval``'s shape and dtype (a tensor, a
    ``meta`` tensor or a numpy array)."""
    n = 1
    for s in aval.shape:
        n *= int(s)
    if isinstance(aval, torch.Tensor):
        return n * aval.element_size()
    return n * np.dtype(aval.dtype).itemsize


def _opt_unpack(program: Program):
    """(optimizer, trainable params) of an attached optimizer, chosen as
    the Executor chooses them (``requires_grad``, ``minimize``'s
    ``parameters=`` and ``no_grad_set=``)."""
    pack = program._optimizer
    if pack is None:
        return None, []
    opt, _loss, param_filter, no_grad_set = (tuple(pack) + (None, None))[:4]
    allow = None if param_filter is None else {id(p) for p in param_filter}
    deny = {id(p) for p in no_grad_set} if no_grad_set else set()
    trainable = [p for p in program.parameters()
                 if p.requires_grad and id(p) not in deny
                 and (allow is None or id(p) in allow)]
    return opt, trainable


def _slot_bytes_list(opt, trainable) -> Optional[List[int]]:
    """Each trainable parameter's slot bytes, from the optimizer's
    ``functional_init`` on ``meta`` tensors (nothing is allocated); None
    when the optimizer cannot run on them."""
    if opt is None or not trainable:
        return []
    try:
        state = opt.functional_init(
            [to_meta(p) for p in trainable])
    except Exception:  # noqa: BLE001 - estimation must not raise
        return None
    return [sum(aval_bytes(t) for t in s.values()
                if isinstance(t, torch.Tensor)) for s in state]


class MemoryEstimate:
    """The byte breakdown of one Program's predicted residency."""

    __slots__ = ("activation_peak_bytes", "peak_op_index",
                 "retained_activation_bytes", "feed_bytes", "param_bytes",
                 "trainable_param_bytes", "grad_bytes", "slot_bytes",
                 "slots_estimated", "peak_bytes_donated",
                 "peak_bytes_no_donation", "training")

    def to_dict(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}

    def __repr__(self):
        return (f"MemoryEstimate(peak_donated={self.peak_bytes_donated}, "
                f"peak_no_donation={self.peak_bytes_no_donation}, "
                f"activation_peak={self.activation_peak_bytes})")


def estimate_memory(graph: DefUseGraph,
                    fetch_vars: Sequence[Variable] = (),
                    avals: Optional[Dict[int, object]] = None,
                    param_div: Optional[Dict[int, int]] = None,
                    act_div: int = 1) -> MemoryEstimate:
    """Interval liveness over the op list.  ``avals`` (id(var) -> meta
    tensor) overrides the recorded shapes, e.g. under a concrete batch
    size; ``fetch_vars`` stay live to the end.

    ``param_div`` (``id(param) -> n``) and ``act_div`` switch to
    per-shard accounting under a sharding plan: each parameter's bytes
    (and its gradient's and slots', which shard like it) divide by its
    spec's axis-size product, activation and feed bytes by the batch
    axes' product.  Divisions round up."""
    avals = avals or {}
    nodes = graph.nodes
    n = len(nodes)
    param_div = param_div or {}

    def _ceil_div(b: int, d: int) -> int:
        return -(-int(b) // max(int(d), 1))

    def bytes_of(v: Variable) -> int:
        return _ceil_div(aval_bytes(avals.get(id(v), v.meta)), act_div)

    def pbytes(p) -> int:
        return _ceil_div(aval_bytes(param_aval(p)), param_div.get(id(p), 1))

    fetched = {id(v) for v in fetch_vars}
    # a var is resident for ops birth..death inclusive: feeds from op 0,
    # a var nobody reads dies after its producer, a fetch lives to the end
    birth: Dict[int, int] = {}
    death: Dict[int, int] = {}
    every: Dict[int, Variable] = {}
    for v in graph.feeds.values():
        birth[id(v)] = 0
        every[id(v)] = v
    for i, node in enumerate(nodes):
        for v in node.out_vars:
            birth.setdefault(id(v), i)
            every.setdefault(id(v), v)
    for vid, b in birth.items():
        cons = graph.consumers_of.get(vid, ())
        death[vid] = max(cons) if cons else b
        if vid in fetched:
            death[vid] = n - 1 if n else 0

    start_at: Dict[int, List[int]] = {}
    end_at: Dict[int, List[int]] = {}
    for vid in birth:
        start_at.setdefault(birth[vid], []).append(vid)
        end_at.setdefault(death[vid], []).append(vid)
    live = peak = peak_i = 0
    for i in range(n):
        for vid in start_at.get(i, ()):
            live += bytes_of(every[vid])
        if live > peak:
            peak, peak_i = live, i
        for vid in end_at.get(i, ()):
            live -= bytes_of(every[vid])
    if n == 0:
        peak = sum(bytes_of(v) for v in graph.feeds.values())

    est = MemoryEstimate()
    est.activation_peak_bytes = peak
    est.peak_op_index = peak_i
    # retained: op outputs only (the feeds are feed_bytes, once)
    feed_ids = {id(v) for v in graph.feeds.values()}
    est.retained_activation_bytes = sum(
        bytes_of(v) for vid, v in every.items() if vid not in feed_ids)
    est.feed_bytes = sum(bytes_of(v) for v in graph.feeds.values())

    params, seen = [], set()
    for plist in graph.params_of.values():
        for p in plist:
            if id(p) not in seen:
                seen.add(id(p))
                params.append(p)
    est.param_bytes = sum(pbytes(p) for p in params)

    opt, trainable = _opt_unpack(graph.program)
    est.training = opt is not None
    est.trainable_param_bytes = sum(pbytes(p) for p in trainable)
    est.grad_bytes = est.trainable_param_bytes if est.training else 0
    slots = _slot_bytes_list(opt, trainable)
    if slots is None:            # assume Adam's two slots
        est.slot_bytes = 2 * est.trainable_param_bytes
        est.slots_estimated = True
    else:
        est.slot_bytes = sum(_ceil_div(b, param_div.get(id(p), 1))
                             for b, p in zip(slots, trainable))
        est.slots_estimated = False

    if est.training:
        # the backward keeps the forward's activations: the retained sum
        # (and the feeds, resident throughout), not the interval peak
        act = est.retained_activation_bytes + est.feed_bytes
        est.peak_bytes_donated = (est.param_bytes + est.slot_bytes
                                  + est.grad_bytes + act)
        est.peak_bytes_no_donation = (est.peak_bytes_donated
                                      + est.trainable_param_bytes
                                      + est.slot_bytes)
    else:
        est.peak_bytes_donated = est.param_bytes + est.activation_peak_bytes
        est.peak_bytes_no_donation = est.peak_bytes_donated
    return est
