"""Verifier passes over the def-use graph (the counterpart of
``paddle_tpu/static/analysis/passes.py``).

Each pass is a small object with a ``name`` and ``run(graph,
fetch_list)`` that returns structured :class:`Diagnostic` records;
:func:`check` runs a pipeline (these passes, then the hazards of
:mod:`.hazards`), :func:`verify` raises
:class:`~paddle_tpu_torch.core.enforce.GraphVerificationError` when an
error survives.  The codes (``pass_name``) and severities are the JAX
package's.  The defects:

- an operand used before it is produced, or never produced (a broken
  transform, or a Variable made outside recording), and a Variable
  produced twice;
- a Variable of another Program (two programs built without resetting
  the guard);
- ops and feeds dead relative to the fetch targets;
- shape or dtype drift: a recorded output no longer reproducible from
  its inputs (a parameter re-assigned with another shape after
  recording), found by replaying every op on ``meta`` tensors;
- two distinct Variables sharing a name.

With a plan in scope (``sharding=``, or ``mesh_shape=`` with
``sharding_rules=`` / ``strategy=``), :func:`check` and :func:`verify`
add the shardcheck passes (:mod:`.shardcheck`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ...core.enforce import GraphVerificationError
from ..program import Program, Variable, infer_outputs, to_meta
from .graph import DefUseGraph

__all__ = [
    "Diagnostic", "AnalysisPass", "UseBeforeProducePass",
    "CrossProgramLeakPass", "DeadCodePass", "ShapeDtypeConsistencyPass",
    "NameCollisionPass", "check", "verify", "default_passes",
    "PASS_REGISTRY",
]


class Diagnostic:
    """One finding: severity, pass, message and its op / var anchors.
    ``loc`` is a ``file:line`` string when the op recorded an anchor."""

    __slots__ = ("severity", "pass_name", "message", "op_index",
                 "op_name", "var_name", "loc")

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    def __init__(self, severity: str, pass_name: str, message: str,
                 op_index: Optional[int] = None,
                 op_name: Optional[str] = None,
                 var_name: Optional[str] = None,
                 loc: Optional[str] = None):
        self.severity = severity
        self.pass_name = pass_name
        self.message = message
        self.op_index = op_index
        self.op_name = op_name
        self.var_name = var_name
        self.loc = loc

    def __str__(self):
        anchor = ""
        if self.op_index is not None:
            anchor = f" (op #{self.op_index}"
            if self.op_name:
                anchor += f" {self.op_name}"
            if self.loc:
                anchor += f" @ {self.loc}"
            anchor += ")"
        elif self.loc:
            anchor = f" (@ {self.loc})"
        return f"[{self.pass_name}] {self.severity}: {self.message}{anchor}"

    def __repr__(self):
        return f"Diagnostic({self!s})"

    def to_dict(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}


class AnalysisPass:
    """A pass: ``run(graph, fetch_list)`` -> diagnostics."""

    name = "analysis-pass"

    def run(self, graph: DefUseGraph,
            fetch_list: Optional[Sequence] = None) -> List[Diagnostic]:
        raise NotImplementedError

    def _diag(self, graph, severity, message, op_index=None,
              var_name=None):
        op_name = (graph.nodes[op_index].op_name
                   if op_index is not None else None)
        loc = graph.loc_of(op_index) if op_index is not None else None
        return Diagnostic(severity, self.name, message, op_index=op_index,
                          op_name=op_name, var_name=var_name, loc=loc)


class UseBeforeProducePass(AnalysisPass):
    """Every operand is a feed or the output of an earlier op."""

    name = "use-before-produce"

    def run(self, graph, fetch_list=None):
        out: List[Diagnostic] = []
        prog = graph.program
        for v, first, dup in graph.duplicate_producers:
            out.append(self._diag(
                graph, Diagnostic.ERROR,
                f"Variable '{v.name}' is produced twice (also by op "
                f"#{first} '{graph.nodes[first].op_name}'); the later "
                f"write silently shadows the earlier one",
                op_index=dup, var_name=v.name))
        for i in range(len(graph.nodes)):
            for v, _kind in graph.node_inputs(i):
                if v.program is not prog or graph.is_feed(v):
                    continue        # a leak is CrossProgramLeakPass's
                p = graph.producer_of.get(id(v))
                if p is None:
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"Variable '{v.name}' is consumed but never "
                        f"produced by any op and is not a feed",
                        op_index=i, var_name=v.name))
                elif p >= i:
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"Variable '{v.name}' is used before it is "
                        f"produced (producer is op #{p} "
                        f"'{graph.nodes[p].op_name}')",
                        op_index=i, var_name=v.name))
        return out


class CrossProgramLeakPass(AnalysisPass):
    """No operand, output or feed belongs to another Program."""

    name = "cross-program-leak"

    def run(self, graph, fetch_list=None):
        out: List[Diagnostic] = []
        prog = graph.program
        for i, node in enumerate(graph.nodes):
            for v, kind in graph.node_inputs(i):
                if v.program is not prog:
                    how = ("replay closure" if kind == "extra"
                           else "operand")
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"Variable '{v.name}' belongs to a different "
                        f"Program (leaked across program boundaries as "
                        f"an op {how})", op_index=i, var_name=v.name))
            for v in node.out_vars:
                if v.program is not prog:
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"output Variable '{v.name}' belongs to a "
                        f"different Program", op_index=i,
                        var_name=v.name))
        for name, v in graph.feeds.items():
            if v.program is not prog:
                out.append(Diagnostic(
                    Diagnostic.ERROR, self.name,
                    f"feed Variable '{name}' belongs to a different "
                    f"Program", var_name=name))
        return out


class DeadCodePass(AnalysisPass):
    """Ops unreachable backwards from the fetch targets, and feeds no
    live op reads.  Without fetch targets liveness is undefined, so the
    pass only checks that explicit fetch entries resolve; an attached
    optimizer's loss is a root."""

    name = "dead-code"

    def run(self, graph, fetch_list=None):
        out: List[Diagnostic] = []
        roots: List[Variable] = []
        for f in fetch_list or []:
            v = graph.resolve_fetch(f)
            if v is None:
                out.append(Diagnostic(
                    Diagnostic.ERROR, self.name,
                    f"fetch target {f!r} does not name any Variable in "
                    f"the program",
                    var_name=f if isinstance(f, str) else None))
            elif v.program is not graph.program:
                out.append(Diagnostic(
                    Diagnostic.ERROR, self.name,
                    f"fetch target '{v.name}' belongs to a different "
                    f"Program", var_name=v.name))
            else:
                roots.append(v)
        opt = graph.program._optimizer
        if opt is not None and isinstance(opt[1], Variable):
            roots.append(opt[1])
        if not roots:
            return out
        live = graph.live_nodes(roots)
        for i in range(len(graph.nodes)):
            if i not in live:
                outs = ", ".join(v.name for v in graph.nodes[i].out_vars)
                out.append(self._diag(
                    graph, Diagnostic.WARNING,
                    f"op is dead relative to the fetch targets (outputs "
                    f"[{outs}] are never fetched nor consumed by a live "
                    f"op)", op_index=i))
        for name, v in graph.feeds.items():
            used = any(i in live for i in graph.consumers_of.get(id(v), ())
                       ) or any(v is r for r in roots)
            if not used:
                out.append(Diagnostic(
                    Diagnostic.WARNING, self.name,
                    f"feed '{name}' is never consumed by a live op "
                    f"(unused relative to the fetch targets)",
                    var_name=name))
        return out


class ShapeDtypeConsistencyPass(AnalysisPass):
    """Replay every op on ``meta`` tensors of its recorded inputs (a
    control-flow node through its ``trace``) and compare with what
    recording stored on its outputs."""

    name = "shape-dtype"

    def run(self, graph, fetch_list=None):
        out: List[Diagnostic] = []
        for i, node in enumerate(graph.nodes):
            args = [x.meta if tag == "v" else to_meta(x)
                    for tag, x in node.in_specs]
            try:
                got = infer_outputs(node, args)
            except Exception as e:  # noqa: BLE001 - any replay failure
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"op no longer traces against its recorded input "
                    f"specs: {type(e).__name__}: {e}", op_index=i))
                continue
            got = list(got) if node.multi else [got]
            if len(got) != len(node.out_vars):
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"op now produces {len(got)} outputs; "
                    f"{len(node.out_vars)} were recorded", op_index=i))
                continue
            for v, a in zip(node.out_vars, got):
                want = (list(v.meta.shape), v.meta.dtype)
                now = (list(a.shape), a.dtype)
                if want != now:
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"Variable '{v.name}' was recorded as "
                        f"shape={want[0]} dtype={_dt(want[1])} but now "
                        f"traces to shape={now[0]} dtype={_dt(now[1])} "
                        f"(inputs changed after recording?)",
                        op_index=i, var_name=v.name))
        return out


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


class NameCollisionPass(AnalysisPass):
    """Two distinct Variables of the program sharing one name (fetches
    by name would read the wrong one)."""

    name = "name-collision"

    def run(self, graph, fetch_list=None):
        out: List[Diagnostic] = []
        by_name: dict = {}
        for v in graph.vars.values():
            if v.program is graph.program:
                by_name.setdefault(v.name, []).append(v)
        for name, vs in sorted(by_name.items()):
            if len(vs) > 1:
                where = []
                for v in vs:
                    p = graph.producer_of.get(id(v))
                    if p is not None:
                        where.append(f"op #{p} {graph.nodes[p].op_name}")
                    elif graph.is_feed(v):
                        where.append("feed")
                    else:
                        where.append("unproduced")
                out.append(Diagnostic(
                    Diagnostic.ERROR, self.name,
                    f"{len(vs)} distinct Variables share the name "
                    f"{name!r} ({', '.join(where)}); the name-keyed "
                    f"executor env would silently alias them",
                    var_name=name))
        return out


def default_passes() -> List[AnalysisPass]:
    return [UseBeforeProducePass(), CrossProgramLeakPass(),
            NameCollisionPass(), ShapeDtypeConsistencyPass(),
            DeadCodePass()]


PASS_REGISTRY = {cls.name: cls for cls in (
    UseBeforeProducePass, CrossProgramLeakPass, DeadCodePass,
    ShapeDtypeConsistencyPass, NameCollisionPass)}


def check(program: Program, fetch_list: Optional[Sequence] = None,
          passes: Optional[Sequence[AnalysisPass]] = None,
          sharding=None, mesh_shape=None, sharding_rules=None,
          strategy=None) -> List[Diagnostic]:
    """Run the verifier and hazard passes (or ``passes``, which replace
    the whole pipeline, shardcheck's too); return every diagnostic
    without raising.  Shardcheck (:mod:`.shardcheck`) runs when a plan
    is in scope: ``sharding=`` a concrete or abstract plan, or
    ``mesh_shape=`` an ``{axis: size}`` dict (with ``sharding_rules=`` /
    ``strategy=``) resolved as an abstract plan, with no devices."""
    from .hazards import hazard_passes
    graph = DefUseGraph(program)
    plan = sharding
    shard_pipeline: List[AnalysisPass] = []
    if passes is None:
        if plan is None and mesh_shape is not None:
            from .shardcheck import build_abstract_plan
            plan = build_abstract_plan(program, mesh_shape,
                                       rules=sharding_rules,
                                       strategy=strategy)
        if plan is not None:
            from .shardcheck import shardcheck_passes
            shard_pipeline = shardcheck_passes(plan)
    pipeline = (passes if passes is not None
                else default_passes() + hazard_passes() + shard_pipeline)
    out: List[Diagnostic] = []
    for p in pipeline:
        out.extend(p.run(graph, fetch_list))
    return out


def verify(program: Program, fetch_list: Optional[Sequence] = None,
           passes: Optional[Sequence[AnalysisPass]] = None,
           raise_on_error: bool = True, sharding=None, mesh_shape=None,
           sharding_rules=None, strategy=None) -> List[Diagnostic]:
    """:func:`check`, raising :class:`GraphVerificationError` when an
    error-severity diagnostic is found; returns the diagnostics."""
    diags = check(program, fetch_list, passes, sharding=sharding,
                  mesh_shape=mesh_shape, sharding_rules=sharding_rules,
                  strategy=strategy)
    errors = [d for d in diags if d.severity == Diagnostic.ERROR]
    if errors and raise_on_error:
        lines = [f"Program verification failed (program "
                 f"#{program._serial}, {len(errors)} error(s), "
                 f"{len(diags) - len(errors)} warning(s)):"]
        lines += [f"  {d}" for d in diags]
        raise GraphVerificationError("\n".join(lines), diagnostics=diags)
    return diags
