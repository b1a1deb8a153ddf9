"""Control flow: cond, case, switch_case and while_loop
(paddle_tpu.ops.control_flow).

Two regimes, as in paddle_tpu:

- **Eager** (a tensor or Python predicate): the predicate is read on the
  host and only the chosen branch runs, recorded by torch's autograd as
  any other code, so it is differentiable; ``while_loop`` is a Python
  loop whose every iteration the tape sees.
- **In a static Program** (a predicate, index or loop variable is a
  static ``Variable``, or a loop's ``cond`` closes over one): each call
  records ONE node whose function re-runs the user's closures when the
  node executes (a single branch, or the loop), under the replay scope
  that resolves the Variables and Parameters they name
  (``core.static_hooks``; ``static.program`` for the recording).

The port has no traced regime: PyTorch runs ``jit.TrainStep`` eagerly,
so there the eager path runs (a Python ``if`` on a tensor works where
paddle_tpu raises), and a ``while_loop`` inside ``TrainStep`` or a
static training program has gradients, where XLA's While has none.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..core.dispatch import Symbolic

__all__ = ["cond", "case", "switch_case", "while_loop"]


def _is_static(x) -> bool:
    return isinstance(x, Symbolic)


def _truth(p) -> bool:
    """A predicate's value, read on the host."""
    if isinstance(p, torch.Tensor):
        return bool(torch.Tensor.item(p.detach()))
    return bool(p)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _same_structure(what, outs):
    """Every branch must give tensors of one structure, shapes and
    dtypes (paddle_tpu's ``lax.cond``/``lax.switch`` require it)."""
    first = outs[0]
    for other in outs[1:]:
        a, b = _outs(first), _outs(other)
        sig = lambda xs: [(tuple(x.shape), x.dtype) for x in xs]  # noqa
        if len(a) != len(b) or sig(a) != sig(b):
            raise TypeError(f"{what}: the branches return different "
                            f"structures: {sig(a)} and {sig(b)}")
    return first


class _Cond:
    """A static ``cond`` node's function: the chosen branch at run time;
    both branches at record time (``trace``)."""

    def __init__(self, true_fn, false_fn):
        self.true_fn, self.false_fn = true_fn, false_fn

    def __call__(self, pred):
        return self.true_fn() if _truth(pred) else self.false_fn()

    def trace(self, pred):
        return _same_structure("cond", [self.true_fn(), self.false_fn()])


class _Case:
    def __init__(self, fns, default):
        self.fns, self.default = fns, default

    def __call__(self, *preds):
        for p, fn in zip(preds, self.fns):
            if _truth(p):
                return fn()
        return self.default()

    def trace(self, *preds):
        return _same_structure("case", [fn() for fn in self.fns]
                               + [self.default()])


class _Switch:
    def __init__(self, pairs, default):
        self.table, self.default = dict(pairs), default

    def __call__(self, index):
        return self.table.get(int(_as_int(index)), self.default)()

    def trace(self, index):
        return _same_structure("switch_case",
                               [fn() for fn in self.table.values()]
                               + [self.default()])


def _as_int(i):
    if isinstance(i, torch.Tensor):
        return int(torch.Tensor.item(i.detach()))
    return int(i)


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name=None,
         return_names=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``; both must return
    the same structure of tensors."""
    true_fn = true_fn if true_fn is not None else (lambda: None)
    false_fn = false_fn if false_fn is not None else (lambda: None)
    if _is_static(pred):
        op = _Cond(true_fn, false_fn)
        return pred.program.record(op, [pred], "cond", {}, trace=op.trace)
    return true_fn() if _truth(pred) else false_fn()


def case(pred_fn_pairs: Sequence[Tuple[Any, Callable]],
         default: Optional[Callable] = None, name=None):
    """The first pair whose predicate is true runs; none true runs
    ``default``, or the last pair's function without one."""
    if not pred_fn_pairs:
        raise ValueError("case() expects at least one (pred, fn) pair")
    preds = [p for p, _ in pred_fn_pairs]
    fns = [fn for _, fn in pred_fn_pairs]
    tail = default if default is not None else fns[-1]
    static = [p for p in preds if _is_static(p)]
    if static:
        op = _Case(fns, tail)
        return static[0].program.record(op, preds, "case", {},
                                        trace=op.trace)
    for p, fn in pred_fn_pairs:
        if _truth(p):
            return fn()
    return tail()


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name=None):
    """Run the branch keyed by an integer index.  ``branch_fns`` is a
    list of functions (keys 0, 1, ...), a list of ``(key, fn)`` pairs or
    a ``{key: fn}`` dict; an index with no branch runs ``default``, or
    the last branch without one."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        branch_fns = list(branch_fns)
        if branch_fns and not callable(branch_fns[0]):
            pairs = sorted((int(k), fn) for k, fn in branch_fns)
        else:
            pairs = list(enumerate(branch_fns))
    if default is None:
        default = pairs[-1][1]
    if _is_static(branch_index):
        op = _Switch(pairs, default)
        return branch_index.program.record(op, [branch_index],
                                           "switch_case", {},
                                           trace=op.trace)
    return dict(pairs).get(_as_int(branch_index), default)()


class _While:
    """A static ``while_loop`` node's function: the loop at run time;
    one ``cond`` and one ``body`` at record time, whose outputs must
    keep the loop variables' shapes and dtypes."""

    def __init__(self, cond, body):
        self.cond, self.body = cond, body

    def __call__(self, *loop_vars):
        loop_vars = list(loop_vars)
        while _truth(self.cond(*loop_vars)):
            loop_vars = _outs(self.body(*loop_vars))
        return tuple(loop_vars)

    def trace(self, *loop_vars):
        self.cond(*loop_vars)
        out = _outs(self.body(*loop_vars))
        _same_structure("while_loop", [list(loop_vars), out])
        return tuple(v.clone() if isinstance(v, torch.Tensor) else v
                     for v in loop_vars)


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name=None) -> List:
    """``while cond(*vars): vars = body(*vars)``; returns the final
    variables as a list."""
    if not callable(cond) or not callable(body):
        raise TypeError("while_loop expects callables for cond and body")
    loop_vars = list(loop_vars)
    program = next((v.program for v in loop_vars if _is_static(v)), None)
    probe = None
    if program is None:
        probe = cond(*loop_vars)
        if _is_static(probe):
            # cond closes over a Program Variable (the probe recorded a
            # dead node, as in paddle_tpu): the loop is a node too
            program = probe.program
    if program is not None:
        op = _While(cond, body)
        return list(program.record(op, loop_vars, "while_loop", {},
                                   trace=op.trace))
    while _truth(probe):
        loop_vars = _outs(body(*loop_vars))
        probe = cond(*loop_vars)
    return loop_vars
