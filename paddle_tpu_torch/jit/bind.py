"""Parameter and buffer binding for one call (the counterpart of
``paddle_tpu/jit/bind.py``).

:func:`bind` puts given tensors in the place of a layer's parameters and
buffers for the duration of a ``with`` block, as
``torch.func.functional_call`` does for one call: the module's
``_parameters`` / ``_buffers`` slots are swapped and put back on exit.
``jit.save`` binds the tensors ``torch.export`` traces with, so the
saved graph takes the weights as inputs and the weights live in the
``.pdiparams`` file beside it.  Buffers the call replaced (a batch
norm's running statistics in training mode) are collected on exit."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["bind", "param_arrays", "buffer_arrays", "param_list",
           "buffer_names", "BindResult"]


class BindResult:
    """Filled on context exit with the buffers the call replaced."""

    def __init__(self):
        self.new_buffers: Dict[str, torch.Tensor] = {}


def _slots(layer, kind: str):
    """For each parameter (or buffer) in ``named_parameters()`` /
    ``named_buffers()`` order: ``(name, [(module, slot name), ...])``,
    every slot that holds it (a tied weight has several)."""
    named = (torch.nn.Module.named_parameters if kind == "_parameters"
             else torch.nn.Module.named_buffers)
    order, where = [], {}
    for name, t in named(layer, remove_duplicate=False):
        mod = layer
        *path, leaf = name.split(".")
        for p in path:
            mod = getattr(mod, p)
        if id(t) not in where:
            where[id(t)] = []
            order.append((name, where[id(t)]))
        where[id(t)].append((mod, leaf))
    return order


@contextlib.contextmanager
def bind(layer, param_arrays: Optional[Sequence] = None,
         buffer_arrays: Optional[Sequence] = None):
    """Bind ``param_arrays`` / ``buffer_arrays`` (aligned with
    ``named_parameters()`` / ``named_buffers()``) into ``layer``.

    Yields a :class:`BindResult`; after the block ``new_buffers`` maps
    the names of buffers whose slot the call replaced to the new value.
    The original tensors are back in place on exit."""
    groups = []
    for kind, arrays in (("_parameters", param_arrays),
                         ("_buffers", buffer_arrays)):
        slots = _slots(layer, kind)
        if arrays is not None and len(arrays) != len(slots):
            raise ValueError(f"bind: {len(arrays)} tensors for "
                             f"{len(slots)} {kind[1:]}")
        groups.append((kind, slots, arrays))
    saved = [(getattr(m, kind), k, getattr(m, kind)[k])
             for kind, slots, _ in groups for _, where in slots
             for m, k in where]
    res = BindResult()
    try:
        for kind, slots, arrays in groups:
            for (_, where), t in zip(slots, arrays or ()):
                for m, k in where:
                    getattr(m, kind)[k] = t
        yield res
        kind, slots, arrays = groups[1]
        for i, (name, where) in enumerate(slots):
            m, k = where[0]
            before = (arrays[i] if arrays is not None
                      else next(t for d, kk, t in saved
                                if d is m._buffers and kk == k))
            if m._buffers[k] is not before:
                res.new_buffers[name] = m._buffers[k]
    finally:
        for d, k, t in saved:
            d[k] = t


def param_arrays(layer) -> List[torch.Tensor]:
    return [p.detach() for _, p in layer.named_parameters()]


def buffer_arrays(layer) -> List[torch.Tensor]:
    return [b.detach() for _, b in layer.named_buffers()]


def param_list(layer) -> List[torch.nn.Parameter]:
    return [p for _, p in layer.named_parameters()]


def buffer_names(layer) -> List[str]:
    return [n for n, _ in layer.named_buffers()]
