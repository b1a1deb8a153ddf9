"""Def-use graph over a Program's recorded op list (the counterpart of
``paddle_tpu/static/analysis/graph.py``).

The op list is topologically ordered by construction (append-only
recording); the graph indexes who produces each Variable, who consumes
it, which parameters each op reads, and which ops are reachable
backwards from a set of fetch roots: what the verifier passes, the
cost model and the fusion pass need.  Variables are keyed by identity,
not by name: name collisions are one of the defects the verifier
reports, so the graph cannot assume names are unique.

A control-flow node also reads the Variables and Parameters its replay
closures reached when it was recorded (``extra_vars``,
``extra_params``): they count as its inputs, of kind "extra".
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..program import Program, Variable

__all__ = ["DefUseGraph"]


class DefUseGraph:
    """- ``producer_of[id(v)]``: the node index whose outputs hold v;
    - ``consumers_of[id(v)]``: the node indexes that read v (as an
      operand or from a control-flow closure);
    - ``feeds``: name -> Variable declared by ``static.data``;
    - ``params_of[i]``: the parameters node i reads;
    - ``duplicate_producers``: (var, first, later) where a later node
      re-emits a Variable an earlier one produced (a broken transform).
    """

    def __init__(self, program: Program):
        self.program = program
        self.nodes = list(program.nodes)
        self.feeds: Dict[str, Variable] = dict(program.feed_vars)
        self.producer_of: Dict[int, int] = {}
        self.consumers_of: Dict[int, List[int]] = {}
        self.params_of: Dict[int, list] = {}
        self.duplicate_producers: List[Tuple[Variable, int, int]] = []
        self.vars: Dict[int, Variable] = {id(v): v
                                          for v in self.feeds.values()}
        for i, node in enumerate(self.nodes):
            for v in node.out_vars:
                self.vars[id(v)] = v
                first = self.producer_of.setdefault(id(v), i)
                if first != i:
                    self.duplicate_producers.append((v, first, i))
            params = []
            for tag, x in node.in_specs:
                if tag == "v":
                    self.vars[id(x)] = x
                    self.consumers_of.setdefault(id(x), []).append(i)
                elif tag == "p":
                    params.append(x)
            for x in node.extra_vars:
                self.vars[id(x)] = x
                self.consumers_of.setdefault(id(x), []).append(i)
            params.extend(node.extra_params)
            self.params_of[i] = params

    def node_inputs(self, i: int) -> List[Tuple[Variable, str]]:
        """The Variables node ``i`` reads, as (var, kind): "in" for an
        operand, "extra" for a control-flow closure's read."""
        node = self.nodes[i]
        return ([(x, "in") for tag, x in node.in_specs if tag == "v"]
                + [(x, "extra") for x in node.extra_vars])

    def is_feed(self, v: Variable) -> bool:
        return any(f is v for f in self.feeds.values())

    def resolve_fetch(self, f) -> Optional[Variable]:
        """A fetch_list entry (Variable or name) -> a Variable of this
        graph; None when a name resolves nowhere."""
        if isinstance(f, Variable):
            return f
        if isinstance(f, str):
            for v in self.vars.values():
                if v.name == f:
                    return v
        return None

    def live_nodes(self, fetch_vars: Sequence[Variable]) -> Set[int]:
        """Node indexes reachable backwards from ``fetch_vars``."""
        live: Set[int] = set()
        stack = [self.producer_of[id(v)] for v in fetch_vars
                 if id(v) in self.producer_of]
        while stack:
            i = stack.pop()
            if i in live:
                continue
            live.add(i)
            for v, _kind in self.node_inputs(i):
                p = self.producer_of.get(id(v))
                if p is not None and p not in live:
                    stack.append(p)
        return live

    def loc_of(self, i: int) -> Optional[str]:
        """The ``file:line`` anchor recorded for node ``i`` (present when
        FLAGS_static_verify or FLAGS_static_anchors was on at record
        time)."""
        loc = self.nodes[i].loc
        return None if loc is None else f"{loc[0]}:{loc[1]}"
