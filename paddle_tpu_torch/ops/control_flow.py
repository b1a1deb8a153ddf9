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

- **While ``torch.export`` captures a graph** (``jit.save``,
  ``static.save_inference_model``; ``torch.compiler.is_exporting()``):
  a tensor predicate lowers ``cond`` to ``torch.cond``, ``case`` and
  ``switch_case`` to nested ``torch.cond``s, and ``while_loop`` to
  torch's ``while_loop``, so the saved graph keeps every branch and a
  data-dependent trip count instead of the one the example took.  Each
  branch's and the body's outputs are copied (torch's control-flow ops
  refuse an output that aliases an input), and Python numbers among the
  loop variables become 0-d tensors.

PyTorch runs ``jit.TrainStep`` and ``jit.to_static`` eagerly, so there
the eager path runs, and a ``while_loop`` inside ``TrainStep`` or a
static training program has gradients, where XLA's While has none.
Inside ``to_static`` a Python ``if`` on a tensor raises, as in
paddle_tpu (``core.tensor``); inside ``TrainStep`` it works.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..core.dispatch import Symbolic

__all__ = ["cond", "case", "switch_case", "while_loop"]


def _is_static(x) -> bool:
    return isinstance(x, Symbolic)


def _exporting(*xs) -> bool:
    """Is ``torch.export`` capturing a graph with a tensor among ``xs``
    deciding the control flow?"""
    return (torch.compiler.is_exporting()
            and any(isinstance(x, torch.Tensor) for x in xs))


def _pred(p):
    return p.reshape(()).bool()


def scalar_tensor(v, device=None) -> torch.Tensor:
    """A Python number as a 0-d tensor made by an op (bool, int64 or
    the default float dtype), never a captured constant: a branch
    traced for ``torch.cond`` cannot serialize a constant of its own."""
    dtype = (torch.bool if isinstance(v, bool) else torch.int64
             if isinstance(v, int) else torch.get_default_dtype())
    return torch.scalar_tensor(v, dtype=dtype, device=device)


def _fresh(fn):
    """``fn`` for torch's control-flow ops: each tensor it returns
    copied (an output may not alias an input), Python numbers as 0-d
    tensors, in ``fn``'s structure (one value or a tuple)."""
    def run(*args):
        out = fn(*args)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        res = []
        for o in outs:
            res.append(o.clone() if isinstance(o, torch.Tensor)
                       else scalar_tensor(o))
        return res[0] if single else tuple(res)
    return run


def _export_cond(pred, true_fn, false_fn):
    return torch.cond(_pred(pred), _fresh(true_fn), _fresh(false_fn), ())


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
    if _exporting(pred):
        return _export_cond(pred, true_fn, false_fn)
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
    if _exporting(*preds):
        out = tail
        for p, fn in reversed(pred_fn_pairs):
            out = (lambda p=p, fn=fn, rest=out:
                   _export_cond(p, fn, rest) if isinstance(p, torch.Tensor)
                   else (fn() if p else rest()))
        return out()
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
    if _exporting(branch_index):
        out = default
        for key, fn in reversed(pairs):
            out = (lambda key=key, fn=fn, rest=out: _export_cond(
                branch_index == key, fn, rest))
        return out()
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
    if _exporting(probe, *loop_vars):
        return _export_while(cond, body, loop_vars, probe)
    while _truth(probe):
        loop_vars = _outs(body(*loop_vars))
        probe = cond(*loop_vars)
    return loop_vars


def _export_while(cond, body, loop_vars, probe):
    """torch's ``while_loop`` over the loop variables as tensors.  A
    loop this torch cannot export raises ``NotImplementedError`` (fault
    C10 when it happens): a saved graph never holds a fixed trip
    count."""
    try:
        from torch._higher_order_ops.while_loop import while_loop as hop
    except ImportError as e:
        raise NotImplementedError(
            f"while_loop: torch {torch.__version__} has no while_loop "
            f"operator to export it with") from e
    like = next(x for x in [probe, *loop_vars]
                if isinstance(x, torch.Tensor))
    carry = tuple(v if isinstance(v, torch.Tensor)
                  else scalar_tensor(v, like.device) for v in loop_vars)

    def test(*vs):
        c = cond(*vs)
        if not isinstance(c, torch.Tensor):
            c = scalar_tensor(bool(c), like.device)
        return _pred(c)

    step = _fresh(lambda *vs: tuple(_outs(body(*vs))))
    try:
        return list(hop(test, step, carry))
    except Exception as e:       # noqa: BLE001 - re-raised, cause chained
        raise NotImplementedError(
            f"while_loop: torch {torch.__version__} cannot export this "
            f"loop ({type(e).__name__}: {str(e).splitlines()[0]})") from e
