"""Def-use graph over a Program's recorded op list (the subset of
``paddle_tpu/static/analysis/graph.py`` the fusion pass needs).

The op list is topologically ordered by construction (append-only
recording); the graph indexes who produces each Variable and who
consumes it.  Variables are keyed by identity, not by name."""
from __future__ import annotations

from typing import Dict, List, Optional

from ..program import Program, Variable

__all__ = ["DefUseGraph"]


class DefUseGraph:
    """- ``producer_of[id(v)]``: the node index whose outputs hold v;
    - ``consumers_of[id(v)]``: the node indexes that read v;
    - ``feeds``: name -> Variable declared by ``static.data``."""

    def __init__(self, program: Program):
        self.program = program
        self.nodes = list(program.nodes)
        self.feeds: Dict[str, Variable] = dict(program.feed_vars)
        self.producer_of: Dict[int, int] = {}
        self.consumers_of: Dict[int, List[int]] = {}
        self.vars: Dict[int, Variable] = {id(v): v
                                          for v in self.feeds.values()}
        for i, node in enumerate(self.nodes):
            for v in node.out_vars:
                self.vars[id(v)] = v
                self.producer_of.setdefault(id(v), i)
            for tag, x in node.in_specs:
                if tag == "v":
                    self.vars[id(x)] = x
                    self.consumers_of.setdefault(id(x), []).append(i)

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
