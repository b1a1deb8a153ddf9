"""Epilogue-fusion pass: realize the cost model's ranked candidates (the
counterpart of ``paddle_tpu/static/analysis/fusion.py``).

The pass walks the fusion candidates of a recorded Program, matches the
prefix of each chain against the recipes
:func:`~paddle_tpu_torch.ops.fused_epilogue.fused_linear_epilogue`
implements (a ``linear`` anchor, then bias / gelu / relu / residual add
/ layer_norm stages), checks the kernel's gate against the run-time
shapes, and hands the static Executor a rewrite plan: the matched nodes
collapse into one node that calls the fused kernels (K2f forward, K2b
backward).

Stage parameters are read from the nodes' attrs (``approximate`` of
``gelu``, ``n`` and ``epsilon`` of ``layer_norm``).  A chain the matcher
cannot take (another op, other attrs, a gate decline) is left on the
composite path; an exception is never swallowed: it would otherwise run
the composite without a word on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..program import _OpNode, param_aval
from .cost import _fusion_candidates, _propagate_avals
from .graph import DefUseGraph

__all__ = ["FusionPlan", "plan_fusions", "apply_plans",
           "annotate_candidates"]


class FusionPlan:
    """One matched chain prefix -> one fused-kernel node."""

    __slots__ = ("node_indices", "stages", "x_spec", "w_spec", "b_spec",
                 "operand_specs", "out_var", "label")

    def __init__(self, node_indices, stages, x_spec, w_spec, b_spec,
                 operand_specs, out_var, label):
        self.node_indices = list(node_indices)
        self.stages = tuple(stages)
        self.x_spec = x_spec
        self.w_spec = w_spec
        self.b_spec = b_spec
        self.operand_specs = list(operand_specs)
        self.out_var = out_var
        self.label = label


def _aval_of(spec, avals) -> Optional[torch.Tensor]:
    """A tensor carrying the spec's run-time shape and dtype (meta for
    Variables, the tensor itself for parameters and constants)."""
    tag, x = spec
    if tag == "v":
        return avals.get(id(x), x.meta)
    if tag == "p":
        return param_aval(x)
    if tag == "c":
        return x
    return None


def _shape(t) -> tuple:
    return tuple(int(s) for s in t.shape)


def _match_chain(nodes, chain, avals) -> Optional[FusionPlan]:
    """The longest realizable prefix of one candidate chain, or None."""
    from ...ops.fused_epilogue import fused_epilogue_supported, stage_label

    anchor = nodes[chain[0]]
    if anchor.op_name != "linear" or anchor.attrs \
            or len(anchor.in_specs) not in (2, 3):
        return None
    x_spec, w_spec = anchor.in_specs[0], anchor.in_specs[1]
    b_spec = anchor.in_specs[2] if len(anchor.in_specs) == 3 else None
    x_aval, w_aval = _aval_of(x_spec, avals), _aval_of(w_spec, avals)
    if x_aval is None or w_aval is None or w_aval.dim() != 2:
        return None
    n = int(w_aval.shape[1])
    out_shape = _shape(avals.get(id(anchor.out_vars[0]),
                                 anchor.out_vars[0].meta))

    stages: List[tuple] = []
    operand_specs: List[tuple] = []
    operand_shapes: List[tuple] = []
    fused = [chain[0]]
    chain_var = anchor.out_vars[0]

    for idx in chain[1:]:
        node = nodes[idx]
        name, attrs = node.op_name, node.attrs
        if not any(s[0] == "v" and s[1] is chain_var for s in node.in_specs):
            break
        st, ops = None, []
        if name == "relu" and len(node.in_specs) == 1 and not attrs:
            st = ("relu",)
        elif name == "gelu" and len(node.in_specs) == 1 \
                and set(attrs) == {"approximate"} \
                and isinstance(attrs["approximate"], bool):
            st = ("gelu", attrs["approximate"])
        elif name == "add" and len(node.in_specs) == 2 and not attrs:
            other = [s for s in node.in_specs
                     if not (s[0] == "v" and s[1] is chain_var)]
            o_aval = _aval_of(other[0], avals) if len(other) == 1 else None
            if o_aval is not None:
                shp = _shape(o_aval)
                if shp == out_shape or shp in ((n,), (1, n)):
                    st = ("add",) if shp == out_shape else ("bias",)
                    ops = [other[0]]
        elif name == "layer_norm" and set(attrs) == {"n", "epsilon"} \
                and attrs["n"] == 1 and isinstance(attrs["epsilon"], float) \
                and 1 <= len(node.in_specs) <= 3 \
                and node.in_specs[0][0] == "v" \
                and node.in_specs[0][1] is chain_var:
            affine = node.in_specs[1:]
            avs = [_aval_of(sp, avals) for sp in affine]
            if all(a is not None and _shape(a) in ((n,), (1, n))
                   for a in avs):
                st = ("layer_norm", attrs["epsilon"], len(affine) >= 1,
                      len(affine) >= 2)
                ops = list(affine)
        if st is None:
            break
        stages.append(st)
        operand_specs.extend(ops)
        operand_shapes.extend(_shape(_aval_of(sp, avals)) for sp in ops)
        fused.append(idx)
        chain_var = node.out_vars[0]
        out_shape = _shape(avals.get(id(chain_var), chain_var.meta))

    if len(fused) < 2:
        return None             # a bare matmul saves nothing
    if w_aval.dtype != x_aval.dtype:
        return None             # the kernels take one dtype for x and w
    gate_stages = ((("bias",),) if b_spec is not None else ()) + tuple(stages)
    gate_ops = ([_shape(_aval_of(b_spec, avals))] if b_spec is not None
                else []) + operand_shapes
    if not fused_epilogue_supported(_shape(x_aval), _shape(w_aval),
                                    x_aval.dtype, gate_stages, gate_ops):
        return None
    return FusionPlan(fused, stages, x_spec, w_spec, b_spec, operand_specs,
                      nodes[fused[-1]].out_vars[0], stage_label(gate_stages))


def plan_fusions(program, fetch_list=None,
                 feed_shapes: Optional[Dict[str, Sequence[int]]] = None
                 ) -> List[FusionPlan]:
    """The realizable plans of ``program`` under the run's feed shapes
    (the recorded placeholder of 1 for a dynamic dim would fail the
    row gate), in the candidates' order."""
    graph = DefUseGraph(program)
    avals = _propagate_avals(graph, dict(feed_shapes or {}))
    fetched = set()
    for f in fetch_list or []:
        v = graph.resolve_fetch(f)
        if v is not None:
            fetched.add(id(v))
    plans = []
    for cand in _fusion_candidates(graph, avals, fetched):
        plan = _match_chain(graph.nodes, cand["ops"], avals)
        if plan is not None:
            plans.append(plan)
    return plans


def _fused_node_fn(x, w, *rest, stages, has_bias):
    from ...ops.fused_epilogue import fused_linear_epilogue
    bias = rest[0] if has_bias else None
    return fused_linear_epilogue(x, w, bias, stages,
                                 rest[1:] if has_bias else rest)


def apply_plans(nodes: Sequence[_OpNode], plans: Sequence[FusionPlan]
                ) -> List[_OpNode]:
    """The node list with each plan's nodes collapsed into one fused node
    at the position of the chain's last member (every input is produced
    at or before it; the dropped intermediates have no consumer outside
    the chain by construction)."""
    drop = {i for p in plans for i in p.node_indices}
    last = {p.node_indices[-1]: p for p in plans}
    out: List[_OpNode] = []
    for i, node in enumerate(nodes):
        p = last.get(i)
        if p is not None:
            in_specs = [p.x_spec, p.w_spec] + (
                [p.b_spec] if p.b_spec is not None else []) + p.operand_specs
            out.append(_OpNode(_fused_node_fn,
                               {"stages": p.stages,
                                "has_bias": p.b_spec is not None},
                               "fused_epilogue", in_specs, [p.out_var],
                               False, node.loc))
        elif i not in drop:
            out.append(node)
    return out


def annotate_candidates(program, candidates, graph, avals,
                        plan_active: bool = False) -> None:
    """Mark each reported candidate dict with what the Executor's pass
    would realize for it now: ``realized`` (the kernel's label or None)
    and ``realized_ops`` (the fused prefix), gated like the Executor by
    ``FLAGS_use_pallas_kernels`` and, as there, off under a sharding
    plan (``plan_active``)."""
    from ...core.flags import get_flag
    active = bool(get_flag("use_pallas_kernels")) and not plan_active
    for cand in candidates:
        plan = _match_chain(graph.nodes, cand["ops"], avals) if active \
            else None
        cand["realized"] = None if plan is None else plan.label
        cand["realized_ops"] = [] if plan is None else list(plan.node_indices)
