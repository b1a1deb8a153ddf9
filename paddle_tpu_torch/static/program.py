"""Static-graph IR: Program, Variable and op recording (the counterpart
of ``paddle_tpu/static/program.py``).

A Program is an ordered list of :class:`_OpNode` (the op's function,
its attrs, references to its inputs and its output Variables), recorded
through the dispatch point :func:`~paddle_tpu_torch.core.dispatch.apply`
whenever an input is a symbolic :class:`Variable`.  The static
``Executor`` interprets the list.

Shapes are inferred at record time by running the op on ``meta``
tensors (torch's counterpart of ``jax.eval_shape``): a Variable holds a
``meta`` tensor of its shape and dtype.  ``data(shape=[None, ...])``
declares dynamic dims; they record as 1 and take the feed's size at run
time.

Input references (``_OpNode.in_specs``): ``("v", Variable)``, ``("p",
Parameter)`` (an ``nn.Parameter``, read live at run time), ``("c",
tensor)`` (a tensor computed while recording, held as a constant) and
``("l", literal)``.

With ``FLAGS_static_verify`` or ``FLAGS_static_anchors`` on at record
time, each node keeps the ``file:line`` of the user statement that
recorded it (``_OpNode.loc``), which the verifier's diagnostics and
``Program.analyze``'s report show.

Control flow (``ops.control_flow``: ``cond``, ``case``, ``switch_case``,
``while_loop``) records ONE node whose function re-runs the user's
branch or body closures when the node executes, under a replay scope
(``core.static_hooks``) that resolves the Variables and Parameters the
closures name to their tensors in that run.  Such a node carries a
``trace`` function: its outputs cannot be inferred on ``meta`` tensors
(a closure may make tensors of its own), so recording, and the
analyses' re-derivation of shapes (:func:`infer_outputs`), run
``trace`` on zeros of the inputs' shapes on the default device, with
every branch run once; the Variables and Parameters the closures
reached are kept on the node (``extra_vars``, ``extra_params``), so the
def-use graph and :meth:`Program.parameters` see them.
"""
from __future__ import annotations

import itertools
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dispatch import Symbolic
from ..core.dtype import convert_dtype
from ..core.flags import get_flag
from ..core.placement import device as _resolve_device
from ..core.static_hooks import current_replay, replay_scope  # noqa: F401
from ..ops import symbolic_methods
from ..ops.creation import clone as _clone

__all__ = ["Program", "Variable", "data", "program_guard",
           "default_main_program", "default_startup_program",
           "reset_default_programs", "infer_outputs"]

_var_counter = itertools.count(0)
# monotonic program identity: id(program) can be recycled after GC, the
# serial never repeats within a process (it keys the Executor's state)
_program_serial = itertools.count(0)

# the package's own directory, with a trailing separator so that a
# sibling package whose name starts the same does not match
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) \
    + os.sep


def _caller_loc():
    """(file, line) of the first frame outside the package: the user
    statement that recorded the op."""
    f = sys._getframe(2)
    while f is not None:
        if not f.f_code.co_filename.startswith(_PKG_DIR):
            return (f.f_code.co_filename, f.f_lineno)
        f = f.f_back
    return None


class _NoHook:
    def remove(self):
        pass


class Variable(Symbolic):
    """Symbolic tensor inside a Program.  ``meta`` is a ``meta``-device
    tensor of its recorded shape and dtype.  The eager Tensor's methods
    and operators are paddle ops here (``ops.symbolic_methods``), each
    recording one node; comparisons record too, so a Variable hashes by
    identity."""

    __slots__ = ("meta", "program", "name", "desc_shape")

    def __init__(self, meta: torch.Tensor, program: "Program", name=None,
                 desc_shape=None):
        self.meta = meta
        self.program = program
        self.name = name or f"var_{next(_var_counter)}"
        self.desc_shape = list(desc_shape) if desc_shape is not None else None

    @property
    def shape(self) -> List[int]:
        return (list(self.desc_shape) if self.desc_shape is not None
                else list(self.meta.shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    def __bool__(self):
        raise TypeError(
            "[operator < bool > error] Python `if`/`while` tested a "
            "symbolic static.Variable while building a Program; the "
            "branch cannot be resolved at build time. Use "
            "paddle.static.nn.cond / paddle.where for branches and "
            "paddle.static.nn.while_loop for loops.")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype})")

    __hash__ = object.__hash__

    # -- the eager Tensor's members, as paddle_tpu's Variable answers them
    # (it inherits them from its Tensor, whose value is the abstract
    # shape and dtype while a Program is built).  Only ``clone`` records
    # a node; ``meta`` is the port's abstract value.
    def clone(self):
        """A ``clone`` node: the Executor runs it as a copy."""
        return _clone(self)

    def numpy(self):
        """The abstract value, as a 0-d object array holding ``meta``."""
        out = np.empty((), dtype=object)
        out[()] = self.meta
        return out

    def item(self, *args):
        return self.meta

    def tolist(self):
        return self.meta

    def _no_value(self, member):
        raise TypeError(
            f"static.Variable.{member}: {self.name} is symbolic while the "
            "Program is built and holds no value; fetch it with "
            "Executor.run")

    def detach(self):
        self._no_value("detach")

    def cpu(self):
        self._no_value("cpu")

    def backward(self, grad_tensor=None, retain_graph=False):
        """Nothing to run on a scalar (the Program's gradients come from
        ``optimizer.minimize``); a non-scalar without ``grad_tensor``
        raises, as the eager Tensor's does."""
        if grad_tensor is None and self.meta.numel() != 1:
            raise RuntimeError("grad must be provided for non-scalar "
                               "tensor.backward()")

    def clear_grad(self):
        return None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """A handle whose ``remove()`` does nothing: a symbolic Variable
        has no gradient to pass ``hook``, so it is never called, as in
        paddle_tpu."""
        return _NoHook()

    def cuda(self, *args, **kwargs):
        return self

    def pin_memory(self):
        return self

    def set_value(self, value):
        shape = tuple(np.shape(value))
        if shape != tuple(self.meta.shape):
            raise ValueError(f"set_value shape mismatch: {list(shape)} vs "
                             f"{self.shape}")
        return self

    def zero_(self):
        return self

    def fill_(self, value):
        return self


for _name, _fn in symbolic_methods().items():
    setattr(Variable, _name, _fn)


class _OpNode:
    """One recorded op; ``loc`` is its (file, line) anchor or None.  A
    control-flow node has a ``trace`` function and the Variables and
    Parameters its closures read (``extra_vars``, ``extra_params``)."""

    __slots__ = ("fn", "attrs", "op_name", "in_specs", "out_vars", "multi",
                 "loc", "trace", "extra_vars", "extra_params")

    def __init__(self, fn, attrs, op_name, in_specs, out_vars, multi,
                 loc=None, trace=None, extra_vars=(), extra_params=()):
        self.fn = fn
        self.attrs = attrs
        self.op_name = op_name
        self.in_specs = in_specs
        self.out_vars = out_vars
        self.multi = multi
        self.loc = loc
        self.trace = trace
        self.extra_vars = list(extra_vars)
        self.extra_params = list(extra_params)


def _spec(x) -> Tuple[str, object]:
    if isinstance(x, Variable):
        return ("v", x)
    if isinstance(x, torch.nn.Parameter):
        return ("p", x)
    if isinstance(x, torch.Tensor):
        return ("c", x.detach())
    return ("l", x)


def to_meta(x):
    """A ``meta`` stand-in for a record-time input (of its global shape
    for a ZeRO-3 parameter resting as this rank's rows)."""
    if isinstance(x, Variable):
        return x.meta
    if isinstance(x, torch.Tensor):
        shape = getattr(x, "global_shape", None) or x.shape
        return torch.empty(tuple(shape), dtype=x.dtype, device="meta")
    return x


def param_aval(p):
    """A parameter as the analysis reads it: itself, or a ``meta``
    stand-in of its global shape while it rests as this rank's rows
    (``distributed.sharding.ParamShards``)."""
    g = getattr(p, "global_shape", None)
    if g is None or tuple(g) == tuple(p.shape):
        return p
    return to_meta(p)


def _traced(trace, args, var_meta=None):
    """Run a control-flow node's ``trace`` on zeros standing for its
    meta ``args`` (and for the Variables its closures name: their
    recorded meta, or ``var_meta(v)``); returns (outputs as meta, the
    Variables and Parameters the closures reached)."""
    dev = _resolve_device(None)
    seen_v, seen_p = {}, {}

    def zeros(m):
        return torch.zeros(m.shape, dtype=m.dtype, device=dev)

    def lookup(v):
        if isinstance(v, torch.nn.Parameter):
            seen_p.setdefault(id(v), v)
            return v.detach()
        seen_v.setdefault(id(v), v)
        return zeros(var_meta(v) if var_meta is not None else v.meta)

    real = [zeros(a) if isinstance(a, torch.Tensor) and a.is_meta else a
            for a in args]
    with replay_scope(lookup), torch.no_grad():
        out = trace(*real)
    multi = isinstance(out, (tuple, list))
    metas = [to_meta(o) for o in (out if multi else [out])]
    return ((tuple(metas) if multi else metas[0]), list(seen_v.values()),
            list(seen_p.values()))


def infer_outputs(node, args, var_meta=None):
    """``node``'s outputs (meta tensors) for the meta ``args``: the op
    run on them, or a control-flow node's ``trace`` (:func:`_traced`;
    ``var_meta(v)`` gives the shapes of the Variables its closures
    read)."""
    with torch.no_grad():
        if node.trace is None:
            return node.fn(*args, **node.attrs)
        return _traced(node.trace, args, var_meta)[0]


class Program:
    """An ordered op list plus feed metadata and the attached optimizer.
    Built by running layer code on ``static.data`` Variables; executed
    by ``static.Executor``."""

    def __init__(self):
        self.nodes: List[_OpNode] = []
        self.feed_vars: Dict[str, Variable] = {}
        # (optimizer, loss Variable, parameters, no_grad_set)
        self._optimizer = None
        self._version = 0
        self._serial = next(_program_serial)
        self._params_cache = None      # (version, [Parameter])

    def record(self, fn: Callable, inputs: Sequence, op_name: str,
               attrs: dict, trace: Optional[Callable] = None):
        """Append one node; returns its output Variable(s).  A
        control-flow node passes its ``trace`` (see :func:`_traced`)."""
        extra_v, extra_p = (), ()
        if trace is None:
            with torch.no_grad():
                out = fn(*[to_meta(x) for x in inputs], **attrs)
        else:
            out, extra_v, extra_p = _traced(
                trace, [to_meta(x) for x in inputs])
        multi = isinstance(out, (tuple, list))
        out_vars = [Variable(o, self) for o in (out if multi else [out])]
        loc = (_caller_loc() if get_flag("static_verify")
               or get_flag("static_anchors") else None)
        self.nodes.append(_OpNode(fn, attrs, op_name,
                                  [_spec(x) for x in inputs], out_vars,
                                  multi, loc, trace, extra_v, extra_p))
        self._version += 1
        return tuple(out_vars) if multi else out_vars[0]

    def parameters(self) -> List[torch.nn.Parameter]:
        """Parameters the program reads (control-flow closures' too), in
        first-use order (cached per version: the Executor calls this
        every run)."""
        cached = self._params_cache
        if cached is not None and cached[0] == self._version:
            return cached[1]
        seen, out = set(), []
        for node in self.nodes:
            for v in [v for tag, v in node.in_specs if tag == "p"] \
                    + node.extra_params:
                if id(v) not in seen:
                    seen.add(id(v))
                    out.append(v)
        self._params_cache = (self._version, out)
        return out

    # -- analysis (static/analysis) ----------------------------------------
    def verify(self, fetch_list=None, raise_on_error=True, sharding=None,
               mesh_shape=None, sharding_rules=None, strategy=None):
        """Run the verifier and hazard passes (``static.analysis``):
        def-use order, cross-program leaks, name collisions, shape and
        dtype drift, and, with ``fetch_list`` roots, dead ops and unused
        feeds.  Raises ``core.enforce.GraphVerificationError`` on an
        error unless ``raise_on_error=False``; returns the diagnostics.
        With ``sharding=`` a plan, or ``mesh_shape=`` (and
        ``sharding_rules=`` / ``strategy=``) an abstract one, the
        shardcheck passes run too (``static.analysis.shardcheck``)."""
        from .analysis import verify as _verify
        return _verify(self, fetch_list=fetch_list,
                       raise_on_error=raise_on_error, sharding=sharding,
                       mesh_shape=mesh_shape, sharding_rules=sharding_rules,
                       strategy=strategy)

    def analyze(self, fetch_list=None, feed_shapes=None, batch_size=None,
                chip=None, top_k=5, sharding=None):
        """The cost model's report (``static.analysis.cost``): FLOPs and
        bytes per op with an explicit ``unmodeled`` bucket, donation-aware
        peak bytes, a roofline per chip spec, the hazards, and the top-k
        fusion candidates with what the Executor realizes.
        ``batch_size`` stands in for every dynamic feed dim and
        ``feed_shapes`` sets feeds exactly.  ``sharding`` (a plan)
        prices each rank's share and the plan's wire bytes."""
        from .analysis import analyze as _analyze
        return _analyze(self, fetch_list=fetch_list,
                        feed_shapes=feed_shapes, batch_size=batch_size,
                        chip=chip, top_k=top_k, sharding=sharding)

    # -- the reference's Block protocol --------------------------------------
    def global_block(self):
        return self

    @property
    def ops(self):
        return self.nodes

    def all_parameters(self):
        return self.parameters()

    def __repr__(self):
        lines = [f"Program({len(self.nodes)} ops)"]
        for n in self.nodes[:20]:
            ins = ", ".join(v.name if tag == "v" else tag
                            for tag, v in n.in_specs)
            outs = ", ".join(v.name for v in n.out_vars)
            lines.append(f"  {n.op_name}({ins}) -> {outs}")
        if len(self.nodes) > 20:
            lines.append(f"  ... {len(self.nodes) - 20} more")
        return "\n".join(lines)


_default_main = Program()
_default_startup = Program()
_guard_stack: List[Tuple[Program, Program]] = []


def default_main_program() -> Program:
    return _guard_stack[-1][0] if _guard_stack else _default_main


def default_startup_program() -> Program:
    return _guard_stack[-1][1] if _guard_stack else _default_startup


class program_guard:
    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._pair = (main_program, startup_program or Program())

    def __enter__(self):
        _guard_stack.append(self._pair)
        return self._pair[0]

    def __exit__(self, *exc):
        _guard_stack.pop()
        return False


def reset_default_programs():
    global _default_main, _default_startup
    _default_main = Program()
    _default_startup = Program()


def data(name: str, shape: Sequence[Optional[int]], dtype="float32",
         lod_level=0) -> Variable:
    """Declare a feed placeholder; ``None`` or a negative size is a
    dynamic dim (recorded as 1)."""
    concrete = tuple(1 if (s is None or s < 0) else int(s) for s in shape)
    prog = default_main_program()
    v = Variable(torch.empty(concrete, dtype=convert_dtype(dtype),
                             device="meta"), prog, name=name,
                 desc_shape=[-1 if (s is None or s < 0) else int(s)
                             for s in shape])
    prog.feed_vars[name] = v
    return v
