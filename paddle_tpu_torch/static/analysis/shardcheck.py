"""Shardcheck: static SPMD safety analysis for (program, mesh, plan)
(the counterpart of ``paddle_tpu/static/analysis/shardcheck.py``).

Every sharding mistake this module catches otherwise surfaces only as a
runtime raise (or a silent wrong answer) on a live job: a spec whose
axis the mesh doesn't carry, a collective guarded by a device-varying
predicate (a static deadlock), a SUM-reduced fetch under the dp-mean
grad stage, a mis-priced wire byte.  Shardcheck proves the triple on
the CPU with no devices and no process group: an :class:`AbstractMesh`
is an ordered ``{axis: size}`` dict, so a ``{dp: 4, mp: 2}`` plan lints
in one process.

Four pass families, all emitting the PR-1 :class:`Diagnostic` records:

==================  =====================================================
pass                proves
==================  =====================================================
shard-plan          every param covered, every spec axis present and
                    divisible, optimizer slots inherit specs, feeds
                    batch-divisible; ``_fit_spec_to_mesh`` silent
                    downgrades promoted to WARN naming the matched rule
shard-choreography  every replica executes the identical collective
                    sequence: known-bad grad_comm configs (pp/sp mesh
                    axes, param specs outside the FSDP/mp forms) via
                    :func:`grad_comm.plan_status` — hybrid {dp, mp} and
                    ZeRO-3 layouts are first-class and report their
                    gather choreography — sum-classified fetches,
                    collectives under device-varying predicates,
                    overlap-knob resolution
shard-taint         device-varying values (axis_index, shard-local
                    collectives, per-shard RNG) reaching fetches,
                    host-sync ops, or step control flow without a
                    cross-replica reduction; unfolded RNG keys
shard-wire          per-bucket wire bytes re-derived INDEPENDENTLY of
                    ``grad_comm._wire_bytes`` and cross-checked against
                    ``cost._comm_block`` — the measured==predicted gate's
                    third, compile-free leg
==================  =====================================================

The cause strings for configs the Executor refuses at compile time come
from the SAME functions the Executor raises with
(``grad_comm.plan_status`` / ``incompatibility`` /
``sum_fetch_message``), so the static and runtime gates can never
disagree.  Surface: ``Program.verify(sharding=plan)`` /
``analysis.check(program, mesh_shape={"dp": 4, "mp": 2})`` and the
``FLAGS_shard_verify`` Executor preflight.  In the port a recorded
node's keyword arguments are its ``attrs``, and an optimizer's slots
are shaped by its ``functional_init`` on ``meta`` tensors.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import DefUseGraph
from .passes import AnalysisPass, Diagnostic

__all__ = [
    "AbstractMesh", "AbstractPlan", "build_abstract_plan",
    "parse_mesh_shape", "device_varying_taint", "classify_reduction",
    "audit_wire_bytes", "PlanCoveragePass", "CollectiveChoreographyPass",
    "DeviceVaryingTaintPass", "WireByteAuditPass", "shardcheck_passes",
    "SHARDCHECK_PASS_REGISTRY",
]


# ---------------------------------------------------------------------------
# abstract mesh / plan — lint a topology you don't have hardware for
# ---------------------------------------------------------------------------

class AbstractMesh:
    """The slice of ``distributed.mesh.Mesh`` the analyses consume: an
    ordered ``{axis: size}`` dict and nothing else.  No devices: a
    {dp: 4, mp: 2} plan is certified in one CPU process."""

    __slots__ = ("shape",)

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(a): int(s) for a, s in dict(shape).items()}

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @property
    def ranks(self) -> np.ndarray:
        """The rank grid in row-major order (``Mesh.ranks``), which a
        concrete plan's fingerprint reads."""
        return np.arange(self.size).reshape(tuple(self.shape.values()))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def parse_mesh_shape(text: str) -> Dict[str, int]:
    """``'dp=4,mp=2'`` -> ``{'dp': 4, 'mp': 2}`` (the lint CLI's
    --mesh-shape syntax).  A bare integer means a 1-axis dp mesh."""
    text = str(text).strip()
    if not text:
        return {}
    if re.fullmatch(r"\d+", text):
        return {"dp": int(text)}
    shape: Dict[str, int] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"([A-Za-z_]\w*)\s*=\s*(\d+)", part)
        if m is None:
            raise ValueError(
                f"mesh shape entry {part!r} is not axis=size "
                f"(expected e.g. 'dp=4,mp=2')")
        shape[m.group(1)] = int(m.group(2))
    return shape


class AbstractPlan:
    """A :class:`ShardingPlan` look-alike resolved against an
    :class:`AbstractMesh`, carrying the resolution trail the coverage
    pass reports from: which rule matched each param (``sources``),
    what ``_fit_spec_to_mesh`` downgraded (``downgrades``), and which
    non-scalar params no rule matched (``unmatched``).  Duck-types the
    plan surface the analyses use (``mesh.shape``, ``param_names``,
    ``param_specs``, ``batch_axes``, ``grad_comm``,
    ``spec_by_name``)."""

    __slots__ = ("mesh", "param_names", "param_specs", "batch_axes",
                 "label", "grad_comm", "sources", "downgrades",
                 "unmatched")

    def __init__(self, mesh: AbstractMesh, param_names, param_specs,
                 batch_axes=("dp",), label: str = "", grad_comm=None,
                 sources=None, downgrades=None, unmatched=None):
        self.mesh = mesh
        self.param_names = list(param_names)
        self.param_specs = list(param_specs)
        self.batch_axes = tuple(a for a in batch_axes
                                if a in mesh.shape)
        self.label = label
        self.grad_comm = grad_comm
        self.sources = dict(sources or {})      # name -> how it resolved
        self.downgrades = list(downgrades or [])
        self.unmatched = list(unmatched or [])

    def batch_divisor(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a]
        return n

    def spec_by_name(self, name: str):
        try:
            return self.param_specs[self.param_names.index(name)]
        except ValueError:
            return None

    def __repr__(self):
        return (f"AbstractPlan(mesh={self.mesh.shape}, "
                f"params={len(self.param_names)}, "
                f"unmatched={len(self.unmatched)})")


def build_abstract_plan(program, mesh_shape, rules=None, strategy=None,
                        label: str = "abstract") -> AbstractPlan:
    """Resolve ``program``'s parameters against a mesh SHAPE (no
    devices) with the same per-param precedence as
    ``sharding.plan_for_params``: placement metadata, then partition
    rules (first ``re.search`` match wins), then the ZeRO-3 default,
    then replicated — except that an unmatched non-scalar param is
    RECORDED for the coverage pass instead of raising, so one lint run
    reports every hole at once."""
    from ...distributed import grad_comm as _gc
    from ...distributed.mesh import DP_AXIS
    from ...distributed.sharding import (
        _as_spec, _fit_spec_to_mesh, _is_scalar, _nearest_rule)
    from ...distributed.mesh import PartitionSpec
    from ...parallel.tp_layers import get_placement
    from ..program import param_aval as param_array

    mesh = AbstractMesh(mesh_shape)
    if rules is None and strategy is not None:
        rules = getattr(strategy, "sharding_rules", None)
    rules_c = [(p, _as_spec(s)) for p, s in (rules or [])]

    z3 = (strategy is not None and getattr(strategy, "sharding", False)
          and strategy.sharding_configs.stage >= 3
          and DP_AXIS in mesh.shape)
    min_numel = strategy.sharding_configs.min_shard_numel if z3 else 0
    dp = mesh.shape.get(DP_AXIS, 1)

    names, specs = [], []
    sources: Dict[str, str] = {}
    downgrades: List[tuple] = []
    unmatched: List[tuple] = []
    for p in program.parameters():
        arr = param_array(p)
        shape = tuple(int(d) for d in getattr(arr, "shape", ()))
        name = p.name
        pl = get_placement(p)
        if pl is not None:
            spec, source = _as_spec(pl), "placement"
        elif rules_c and not _is_scalar(arr):
            for pat, rspec in rules_c:
                if re.search(pat, name) is not None:
                    spec, source = rspec, f"rule r'{pat}'"
                    break
            else:
                unmatched.append((name, shape,
                                  _nearest_rule(name, rules_c),
                                  len(rules_c)))
                spec, source = PartitionSpec(), "unmatched"
        elif rules_c:
            spec, source = PartitionSpec(), "scalar"
        elif (z3 and shape and not _is_scalar(arr)
              and int(np.prod(shape)) >= min_numel
              and shape[0] % max(dp, 1) == 0):
            spec, source = PartitionSpec(DP_AXIS), "zero3-default"
        else:
            spec, source = PartitionSpec(), "default-replicated"
        dg: List[tuple] = []
        fitted = _fit_spec_to_mesh(spec, shape, mesh.shape, name,
                                   downgrades=dg)
        downgrades.extend((name, source) + rec for rec in dg)
        names.append(name)
        specs.append(fitted)
        sources[name] = source
    return AbstractPlan(mesh, names, specs, batch_axes=(DP_AXIS,),
                        label=label, grad_comm=_gc.resolve(strategy),
                        sources=sources, downgrades=downgrades,
                        unmatched=unmatched)


# ---------------------------------------------------------------------------
# shared graph analyses (used by more than one pass)
# ---------------------------------------------------------------------------

# ops whose OUTPUT differs per device even when inputs are replicated
_DEVICE_VARYING_OPS = frozenset({
    "axis_index", "get_rank", "scatter", "reduce_scatter", "alltoall",
    "all_to_all", "collective_permute", "ppermute",
})
# cross-replica reductions: outputs are replica-identical again
_RESYNC_OPS = frozenset({
    "all_reduce", "all_gather", "broadcast", "psum", "pmean", "pmax",
    "pmin",
})
_CONTROL_FLOW_OPS = frozenset({"cond", "case", "switch_case",
                               "while_loop"})
_RNG_OPS = frozenset({"dropout", "alpha_dropout"})
# unary shape/scale wrappers the reduction classifier sees through
_TRANSPARENT_OPS = frozenset({
    "cast", "astype", "scale", "identity", "assign", "reshape",
    "squeeze", "unsqueeze", "clone", "detach",
})
_SUM_OPS = frozenset({"sum", "reduce_sum", "add_n"})
_MEAN_OPS = frozenset({"mean", "reduce_mean"})
# tokens inside a closure that imply a collective runs when it's called
_COLLECTIVE_TOKENS = frozenset({
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_to_all", "ppermute", "all_reduce", "reduce_scatter",
    "broadcast", "alltoall", "collective_permute", "axis_index",
})


def device_varying_taint(graph: DefUseGraph) -> Dict[int, Tuple[int, str]]:
    """Forward taint over the recorded op list: ``id(var) -> (source op
    index, source op name)`` for every Variable whose value can differ
    across devices of the mesh.  Collectives that REDUCE over the axis
    (all_reduce/all_gather/broadcast) clear taint — their outputs are
    replica-identical by construction."""
    taint: Dict[int, Tuple[int, str]] = {}
    for i, node in enumerate(graph.nodes):
        if node.op_name in _DEVICE_VARYING_OPS:
            src: Optional[Tuple[int, str]] = (i, node.op_name)
        elif node.op_name in _RESYNC_OPS:
            src = None
        else:
            src = None
            for v, _kind in graph.node_inputs(i):
                if id(v) in taint:
                    src = taint[id(v)]
                    break
        for v in node.out_vars:
            if src is not None:
                taint[id(v)] = src
            else:
                taint.pop(id(v), None)
    return taint


def classify_reduction(graph: DefUseGraph, v,
                       _limit: int = 64) -> Tuple[Optional[str],
                                                  Optional[int]]:
    """How ``v`` was reduced over the batch: ``('sum', op_index)`` /
    ``('mean', op_index)`` / ``(None, None)`` (unknown — the Executor's
    runtime numeric probe still guards that case).  Walks the producer
    chain through transparent unary wrappers; a reduction over
    explicitly non-batch axes is not classified."""
    seen = 0
    while v is not None and seen < _limit:
        seen += 1
        i = graph.producer_of.get(id(v))
        if i is None:
            return None, None
        node = graph.nodes[i]
        kw = dict(getattr(node, "attrs", None) or {})
        red = kw.get("reduction")
        if red == "sum":
            return "sum", i
        if red == "mean":
            return "mean", i
        if red == "none":
            return None, None
        if node.op_name in _SUM_OPS or node.op_name in _MEAN_OPS:
            axis = kw.get("axis", kw.get("dim"))
            axes = (axis if isinstance(axis, (tuple, list))
                    else None if axis is None else [axis])
            if axes is not None and 0 not in [int(a) for a in axes]:
                return None, None  # reduces non-batch dims only
            return (("sum" if node.op_name in _SUM_OPS else "mean"), i)
        if node.op_name in _TRANSPARENT_OPS:
            ins = [x for x, kind in graph.node_inputs(i)
                   if kind == "in"]
            if len(ins) == 1:
                v = ins[0]
                continue
        return None, None
    return None, None


def _mentions_collective(fn, _depth: int = 0) -> Optional[str]:
    """First collective token referenced by ``fn``'s code object, its
    nested code constants, or its closure cells — how the choreography
    pass sees into control-flow branch closures, which are replayed
    closures, not recorded nodes."""
    if _depth > 4 or fn is None:
        return None
    code = getattr(fn, "__code__", None)
    if code is not None:
        hit = _COLLECTIVE_TOKENS.intersection(code.co_names)
        if hit:
            return sorted(hit)[0]
        for const in code.co_consts:
            if hasattr(const, "co_names"):
                sub = _COLLECTIVE_TOKENS.intersection(const.co_names)
                if sub:
                    return sorted(sub)[0]
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            inner = cell.cell_contents
        except ValueError:  # empty cell
            continue
        if callable(inner) and inner is not fn:
            tok = _mentions_collective(inner, _depth + 1)
            if tok:
                return tok
    return None


def _derive_gplan(program, plan, graph: Optional[DefUseGraph] = None):
    """The GradCommPlan the Executor would compile for (program, plan),
    derived with the SAME production order and bucketer — or None when
    grad_comm is off/error or no optimizer is attached."""
    from ...distributed import grad_comm as _gc
    from ...distributed.mesh import DP_AXIS
    from ..program import param_aval as param_array
    from .liveness import _opt_unpack
    status, _msg = _gc.plan_status(plan)
    if status != "active" or program._optimizer is None:
        return None
    _opt, trainable = _opt_unpack(program)
    if not trainable:
        return None
    shapes = [tuple(param_array(p).shape) for p in trainable]
    loss = program._optimizer[1]
    order = _gc.production_order(program, trainable, loss, graph=graph)
    dp = dict(plan.mesh.shape).get(DP_AXIS, 1)
    # the SAME hybrid layout the Executor compiles: FSDP positions take
    # rscatter buckets, sharded params get forward gathers
    named = [(p.name, s) for p, s in zip(trainable, shapes)]
    _kinds, fsdp, gathers = _gc.hybrid_layout(plan, named, order=order)
    return _gc.plan_reduction(shapes, dp=dp, cfg=plan.grad_comm,
                              order=order, fsdp=fsdp, gathers=gathers)


def audit_wire_bytes(gplan) -> dict:
    """Independent re-derivation of every bucket's wire bytes from
    first principles — ring all-reduce moves ``2(dp-1)/dp`` of the
    payload, an int8 block adds a 4-byte fp32 scale, scatter pads to a
    dp multiple.  Deliberately does NOT call ``grad_comm._wire_bytes``
    (auditing a formula with itself proves nothing); the shard-wire
    pass cross-checks this against the schedule, ``cost._comm_block``
    and the ``comm.bucket.<i>.wire_bytes`` runtime stats."""
    from ...distributed.mesh import DP_AXIS
    dp, cfg = gplan.dp, gplan.cfg
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}
    scale_bytes = 4
    ring = 2.0 * (dp - 1) / dp if dp > 1 else 0.0
    one_dir = (dp - 1) / dp if dp > 1 else 0.0
    buckets = []
    for b in gplan.buckets:
        if dp <= 1 or b.algorithm == "none":
            wire, ncoll = 0, 0
        elif b.algorithm == "rscatter":
            # FSDP reduce-scatter only: no all-gather leg, the payload
            # rides ONE ring direction; int8 pads to dp*block so each
            # shard row holds whole blocks (one-shot: no requantize,
            # so half the two-shot collective count too)
            if b.wire_dtype == "int8":
                blk = int(cfg.block_size)
                padded = -(-b.numel // (dp * blk)) * (dp * blk)
                payload = padded * itemsize["int8"]
                payload += (padded // blk) * scale_bytes
                wire, ncoll = int(round(one_dir * payload)), 2
            else:
                padded = -(-b.numel // dp) * dp
                wire = int(round(one_dir * padded
                                 * itemsize[b.wire_dtype]))
                ncoll = 1
        elif b.wire_dtype == "int8":
            # pad to dp*block so every shard holds whole blocks
            blk = int(cfg.block_size)
            padded = -(-b.numel // (dp * blk)) * (dp * blk)
            payload = padded * itemsize["int8"]
            payload += (padded // blk) * scale_bytes
            wire, ncoll = int(round(ring * payload)), 4
        elif b.algorithm == "scatter":
            padded = -(-b.numel // dp) * dp
            wire = int(round(ring * padded * itemsize[b.wire_dtype]))
            ncoll = 2
        else:  # fused psum
            wire = int(round(ring * b.numel * itemsize[b.wire_dtype]))
            ncoll = 1
        buckets.append({
            "wire_bytes": wire, "collectives": ncoll,
            "numel": b.numel, "algorithm": b.algorithm,
            "wire_dtype": b.wire_dtype,
        })
    total_numel = sum(b.numel for b in gplan.buckets)
    # forward param gathers (hybrid meshes): each moves (size-1)/size
    # of the f32 payload through every device's links, per axis
    gathers = []
    for g in getattr(gplan, "gathers", ()) or ():
        size = int(g["size"])
        frac = (size - 1) / size if size > 1 else 0.0
        gathers.append({
            "axis": str(g["axis"]),
            "wire_bytes": int(round(frac * int(g["numel"]) * 4))})
    bucket_wire = sum(x["wire_bytes"] for x in buckets)
    axis_wire = {DP_AXIS: bucket_wire}
    for g in gathers:
        axis_wire[g["axis"]] = axis_wire.get(g["axis"], 0) \
            + g["wire_bytes"]
    return {
        "dp": dp,
        "buckets": buckets,
        "wire_bytes_per_step": bucket_wire,
        "collectives_per_step": sum(x["collectives"] for x in buckets),
        "fp32_wire_bytes_per_step": int(round(ring * total_numel * 4)),
        "gathers": gathers,
        "gather_wire_bytes_per_step": sum(x["wire_bytes"]
                                          for x in gathers),
        "axis_wire_bytes": axis_wire,
    }


# ---------------------------------------------------------------------------
# (a) plan coverage & divisibility
# ---------------------------------------------------------------------------

class PlanCoveragePass(AnalysisPass):
    """Every parameter covered by a spec, every spec axis present in
    the mesh and dividing its dim, optimizer slots shaped to inherit
    their param's spec, feeds batch-divisible.  For an
    :class:`AbstractPlan` the ``_fit_spec_to_mesh`` downgrades are
    promoted to WARN diagnostics naming the rule that matched — the
    scrollback ``warnings.warn`` becomes a structured, greppable
    record."""

    name = "shard-plan"

    def __init__(self, plan):
        self.plan = plan

    def run(self, graph, fetch_list=None):
        plan = self.plan
        mesh_shape = dict(plan.mesh.shape)
        out: List[Diagnostic] = []

        # 1) coverage + axis presence + divisibility for every param
        from ..program import param_aval as param_array
        for p in graph.program.parameters():
            arr = param_array(p)
            shape = tuple(int(d) for d in getattr(arr, "shape", ()))
            numel = int(np.prod(shape)) if shape else 1
            spec = plan.spec_by_name(p.name)
            if spec is None:
                if numel > 1:
                    out.append(self._diag(
                        graph, Diagnostic.WARNING,
                        f"parameter '{p.name}' {list(shape)} is not "
                        f"covered by the sharding plan ({len(plan.param_names)} "
                        f"param spec(s)); it would be replicated by "
                        f"default", var_name=p.name))
                continue
            for d, entry in enumerate(tuple(spec)):
                axes = ([entry] if isinstance(entry, str)
                        else list(entry)
                        if isinstance(entry, (tuple, list)) else [])
                if not axes:
                    continue
                if d >= len(shape):
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"spec {spec} of '{p.name}' names dim {d} but "
                        f"the parameter has rank {len(shape)}",
                        var_name=p.name))
                    continue
                div = 1
                for a in axes:
                    size = mesh_shape.get(a)
                    if size is None:
                        out.append(self._diag(
                            graph, Diagnostic.ERROR,
                            f"spec {spec} of '{p.name}' shards dim {d} "
                            f"over mesh axis '{a}' which mesh "
                            f"{mesh_shape} does not carry",
                            var_name=p.name))
                    else:
                        div *= int(size)
                if div > 1 and shape[d] % div != 0:
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        f"'{p.name}' dim {d} ({shape[d]}) is not "
                        f"divisible by the {div}-way sharding of spec "
                        f"{spec} on mesh {mesh_shape}",
                        var_name=p.name))

        # 2) the abstract resolution trail: downgrades + unmatched
        if isinstance(plan, AbstractPlan):
            for (name, source, d, axis, size, reason) in plan.downgrades:
                out.append(self._diag(
                    graph, Diagnostic.WARNING,
                    f"{reason} (resolved via {source})", var_name=name))
            for (name, shape, hint, n_rules) in plan.unmatched:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"no partition rule matches parameter '{name}' "
                    f"({n_rules} rule(s) tried)"
                    + (f"; nearest rule: r'{hint}'" if hint else "")
                    + " — add an explicit (regex, PartitionSpec) rule "
                    "for it (use r'.*' -> PartitionSpec() as a final "
                    "catch-all to replicate everything unmatched)",
                    var_name=name))

        # 3) optimizer slots must inherit the param's spec (same
        # eval_shape trace the Executor shards state with): a slot
        # whose shape differs from its param replicates instead, and
        # the ZeRO memory saving silently evaporates for it
        out.extend(self._slot_diags(graph))

        # 4) feeds: a static batch dim not divisible by the batch axes
        # makes feed_spec fall back to replicated (correct, not
        # parallel) — worth a WARN at lint time, not a runtime surprise
        bd = plan.batch_divisor() if hasattr(plan, "batch_divisor") else 1
        if bd > 1:
            for fname, v in graph.feeds.items():
                desc = getattr(v, "desc_shape", None)
                dims = (list(desc) if desc is not None
                        else list(getattr(v, "shape", ())))
                if not dims or int(dims[0]) < 0:
                    continue  # dynamic batch dim: resolved per feed
                if int(dims[0]) % bd != 0:
                    out.append(self._diag(
                        graph, Diagnostic.WARNING,
                        f"feed '{fname}' batch dim ({dims[0]}) is not "
                        f"divisible by the batch-axes product ({bd}); "
                        f"feed_spec will replicate it — every device "
                        f"computes the full batch", var_name=fname))
        return out

    def _slot_diags(self, graph) -> List[Diagnostic]:
        from ...distributed.sharding import spec_axes
        from ..program import to_meta
        from .liveness import _opt_unpack
        plan = self.plan
        opt, trainable = _opt_unpack(graph.program)
        if opt is None or not trainable:
            return []
        if not hasattr(opt, "functional_init"):
            return []
        try:
            avals = [to_meta(p) for p in trainable]
            state = opt.functional_init(avals)
        except Exception:  # noqa: BLE001 - analysis must not raise
            return []
        if not (isinstance(state, (list, tuple))
                and len(state) == len(trainable)):
            return []
        out: List[Diagnostic] = []
        for p, aval, slots in zip(trainable, avals, state):
            spec = plan.spec_by_name(p.name)
            if spec is None or not spec_axes(spec):
                continue  # replicated params: nothing to inherit
            if not isinstance(slots, dict):
                continue
            for k, s in slots.items():
                sshape = tuple(getattr(s, "shape", ()))
                if not sshape:
                    continue  # scalar slots (step counts) replicate
                if sshape != tuple(aval.shape):
                    out.append(self._diag(
                        graph, Diagnostic.WARNING,
                        f"optimizer slot '{k}' of '{p.name}' has shape "
                        f"{list(sshape)} != param {list(aval.shape)} — "
                        f"it cannot inherit spec {spec} and replicates "
                        f"instead; the sharded-state memory saving is "
                        f"lost for this slot", var_name=p.name))
        return out


# ---------------------------------------------------------------------------
# (b) collective choreography
# ---------------------------------------------------------------------------

class CollectiveChoreographyPass(AnalysisPass):
    """Prove every replica executes the identical collective sequence.
    Known-bad grad_comm configs (pp/sp meshes, param specs fitting
    neither the FSDP nor the mp form) become ERROR diagnostics with the
    EXACT string the Executor raises (one function:
    ``grad_comm.incompatibility``, hybrid form); hybrid/FSDP plans get
    their forward param-gather choreography (count, prefetch order,
    per-axis wire) reported as INFO; sum-classified fetches get
    ``sum_fetch_message`` statically, before the runtime numeric probe;
    a collective inside a control-flow branch guarded by a
    device-varying predicate is a static deadlock."""

    name = "shard-choreography"

    def __init__(self, plan, backend: Optional[str] = None):
        self.plan = plan
        self.backend = backend      # kept for paddle_tpu's signature

    def run(self, graph, fetch_list=None):
        from ...distributed import grad_comm as _gc
        plan = self.plan
        out: List[Diagnostic] = []

        status, msg = _gc.plan_status(plan)
        if status == "error":
            out.append(self._diag(graph, Diagnostic.ERROR, msg))
        elif status == "active":
            cfg = plan.grad_comm
            # how the overlap knob resolves (auto -> 'xla'), the text
            # the cost model prints
            out.append(self._diag(
                graph, Diagnostic.INFO,
                _gc.overlap_note(cfg)))
            # static sum-classification of the loss and every fetch:
            # the dp-mean stage silently scales SUM reductions by 1/dp
            pack = graph.program._optimizer
            roots = []
            if pack is not None and pack[1] is not None:
                roots.append(("loss", pack[1]))
            for f in (fetch_list or []):
                v = graph.resolve_fetch(f)
                if v is not None:
                    roots.append(("fetch", v))
            seen_ids = set()
            for what, v in roots:
                if id(v) in seen_ids:
                    continue
                seen_ids.add(id(v))
                verdict, op_i = classify_reduction(graph, v)
                if verdict == "sum":
                    out.append(self._diag(
                        graph, Diagnostic.ERROR,
                        _gc.sum_fetch_message(what, v.name),
                        op_index=op_i, var_name=v.name))
            # the bucket schedule itself: statically identical on every
            # replica by construction — report it so the lint output
            # shows WHAT choreography was certified
            gplan = _derive_gplan(graph.program, plan, graph)
            if gplan is not None:
                algos = ", ".join(
                    f"{a}x{n}" for a, n in
                    sorted(gplan.algo_counts().items()))
                out.append(self._diag(
                    graph, Diagnostic.INFO,
                    f"choreography: {len(gplan.buckets)} bucket(s), "
                    f"{gplan.collectives_per_step} collective(s)/step "
                    f"[{algos}] in a static schedule identical on "
                    f"every replica; "
                    f"{len(gplan.residual_buckets)} bucket(s) carry "
                    f"error-feedback residuals; overlap path "
                    f"'{gplan.overlap_path}'"))
                if gplan.gathers:
                    per_axis = ", ".join(
                        f"{a}={v} B" for a, v in
                        sorted(gplan.axis_wire_bytes.items()))
                    out.append(self._diag(
                        graph, Diagnostic.INFO,
                        f"hybrid choreography: "
                        f"{len(gplan.gathers)} forward param "
                        f"gather(s) in production (prefetch) order, "
                        f"{gplan.gather_wire_bytes_per_step} B/step; "
                        f"per-axis wire [{per_axis}]"))

        # collectives under device-varying predicates: replicas take
        # different branches and the collective deadlocks the mesh.
        # Branch bodies are replay closures (not recorded nodes), so
        # look inside the closure's code objects for collective tokens.
        taint = device_varying_taint(graph)
        for i, node in enumerate(graph.nodes):
            if node.op_name not in _CONTROL_FLOW_OPS:
                continue
            tainted = [v for v, _kind in graph.node_inputs(i)
                       if id(v) in taint]
            if not tainted:
                continue
            tok = _mentions_collective(getattr(node, "fn", None))
            for x in getattr(node, "extra_vars", ()) or ():
                if tok:
                    break
                tok = _mentions_collective(x) if callable(x) else tok
            if tok:
                src_i, src_op = taint[id(tainted[0])]
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"collective '{tok}' inside a '{node.op_name}' "
                    f"branch guarded by device-varying predicate "
                    f"'{tainted[0].name}' (tainted by op #{src_i} "
                    f"'{src_op}'): replicas can take different "
                    f"branches, so the collective deadlocks the mesh",
                    op_index=i, var_name=tainted[0].name))
        return out


# ---------------------------------------------------------------------------
# (c) device-varying taint
# ---------------------------------------------------------------------------

class DeviceVaryingTaintPass(AnalysisPass):
    """Device-varying values (axis_index, shard-local collective
    outputs, per-shard RNG) must be reduced across replicas before they
    reach a fetch, a host-sync op, or the step's control flow —
    otherwise every device reports a different answer, or replicas
    diverge.  Unfolded RNG (no axis_index fold into the key) under an
    active dp mesh is a WARN: every replica draws the SAME mask and
    dropout stops being independent across the batch shards."""

    name = "shard-taint"

    def __init__(self, plan=None):
        self.plan = plan

    def run(self, graph, fetch_list=None):
        from .hazards import _HOST_SYNC_OPS
        taint = device_varying_taint(graph)
        out: List[Diagnostic] = []

        if taint:
            for f in (fetch_list or []):
                v = graph.resolve_fetch(f)
                if v is None or id(v) not in taint:
                    continue
                src_i, src_op = taint[id(v)]
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"fetch '{v.name}' carries a device-varying value "
                    f"(tainted by op #{src_i} '{src_op}') with no "
                    f"cross-replica reduction on the path — every "
                    f"device fetches a different tensor",
                    op_index=graph.producer_of.get(id(v)),
                    var_name=v.name))
            for i, node in enumerate(graph.nodes):
                if node.op_name in _HOST_SYNC_OPS:
                    for v, _kind in graph.node_inputs(i):
                        if id(v) not in taint:
                            continue
                        src_i, src_op = taint[id(v)]
                        out.append(self._diag(
                            graph, Diagnostic.ERROR,
                            f"host-sync op '{node.op_name}' reads "
                            f"device-varying '{v.name}' (tainted by op "
                            f"#{src_i} '{src_op}') — each host "
                            f"materializes a different value",
                            op_index=i, var_name=v.name))
                elif node.op_name in _CONTROL_FLOW_OPS:
                    for v, _kind in graph.node_inputs(i):
                        if id(v) not in taint:
                            continue
                        src_i, src_op = taint[id(v)]
                        out.append(self._diag(
                            graph, Diagnostic.ERROR,
                            f"'{node.op_name}' is steered by "
                            f"device-varying '{v.name}' (tainted by op "
                            f"#{src_i} '{src_op}') — replicas can "
                            f"diverge on step control flow",
                            op_index=i, var_name=v.name))
                        break

        # unfolded per-shard RNG: the Executor's dp lowering folds the
        # axis index into the key automatically; a program that opts
        # out (_rng_axis_fold=False) draws IDENTICAL randomness on
        # every replica
        out.extend(self._rng_diags(graph))
        return out

    def _rng_diags(self, graph) -> List[Diagnostic]:
        from ...distributed import grad_comm as _gc
        from ...distributed.mesh import DP_AXIS
        plan = self.plan
        if plan is None:
            return []
        dp = dict(plan.mesh.shape).get(DP_AXIS, 1)
        if dp <= 1:
            return []
        if getattr(graph.program, "_rng_axis_fold", True):
            return []
        out: List[Diagnostic] = []
        for i, node in enumerate(graph.nodes):
            if node.op_name in _RNG_OPS:
                out.append(self._diag(
                    graph, Diagnostic.WARNING,
                    f"RNG op '{node.op_name}' with no axis_index fold "
                    f"into its key: all dp={dp} replicas draw the SAME "
                    f"randomness, so masks are correlated across batch "
                    f"shards (fold the mesh axis index into the key, "
                    f"or leave _rng_axis_fold on)", op_index=i))
        return out


# ---------------------------------------------------------------------------
# (d) wire-byte conservation audit
# ---------------------------------------------------------------------------

class WireByteAuditPass(AnalysisPass):
    """Cross-check three derivations of the grad-comm wire bytes that
    must agree byte-for-byte: the GradCommPlan bucket schedule (what
    the Executor compiles and the ``comm.bucket.<i>.wire_bytes`` stats
    report), ``cost._comm_block`` (what ``Program.analyze`` predicts),
    and this pass's INDEPENDENT first-principles re-derivation
    (:func:`audit_wire_bytes`).  A mismatch means the measured ==
    predicted gate would certify a wrong number."""

    name = "shard-wire"

    def __init__(self, plan):
        self.plan = plan

    def run(self, graph, fetch_list=None):
        from ...distributed import grad_comm as _gc
        plan = self.plan
        status, _msg = _gc.plan_status(plan)
        if status != "active":
            return []
        gplan = _derive_gplan(graph.program, plan, graph)
        if gplan is None:
            return []
        audit = audit_wire_bytes(gplan)
        out: List[Diagnostic] = []

        for i, (b, want) in enumerate(zip(gplan.buckets,
                                          audit["buckets"])):
            if b.wire_bytes != want["wire_bytes"]:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"wire-byte conservation violated: bucket {i} "
                    f"({b.numel} elems, {b.algorithm}/{b.wire_dtype}, "
                    f"dp={gplan.dp}) schedules {b.wire_bytes} B/step "
                    f"but the independent ring re-derivation gives "
                    f"{want['wire_bytes']} B"))
            if b.collectives != want["collectives"]:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"bucket {i} schedules {b.collectives} "
                    f"collective(s) but a {b.algorithm}/{b.wire_dtype} "
                    f"reduction issues {want['collectives']}"))

        if gplan.wire_bytes_per_step != audit["wire_bytes_per_step"]:
            out.append(self._diag(
                graph, Diagnostic.ERROR,
                f"schedule total {gplan.wire_bytes_per_step} B/step != "
                f"audited bucket sum {audit['wire_bytes_per_step']} B"))
        if gplan.fp32_wire_bytes_per_step != \
                audit["fp32_wire_bytes_per_step"]:
            out.append(self._diag(
                graph, Diagnostic.ERROR,
                f"fp32 baseline {gplan.fp32_wire_bytes_per_step} B != "
                f"audited {audit['fp32_wire_bytes_per_step']} B"))
        if gplan.gather_wire_bytes_per_step != \
                audit["gather_wire_bytes_per_step"]:
            out.append(self._diag(
                graph, Diagnostic.ERROR,
                f"wire-byte conservation violated: forward gathers "
                f"schedule {gplan.gather_wire_bytes_per_step} B/step "
                f"but the independent re-derivation gives "
                f"{audit['gather_wire_bytes_per_step']} B"))
        if dict(gplan.axis_wire_bytes) != audit["axis_wire_bytes"]:
            out.append(self._diag(
                graph, Diagnostic.ERROR,
                f"wire-byte conservation violated: per-axis schedule "
                f"{dict(gplan.axis_wire_bytes)} != audited "
                f"{audit['axis_wire_bytes']}"))

        # third leg: the cost model must price the SAME bytes
        from .cost import _comm_block
        try:
            cb = _comm_block(graph.program, plan, graph)
        except Exception:  # noqa: BLE001 - audit must not raise
            cb = None
        if cb is not None and cb.get("enabled"):
            if cb["wire_bytes_per_step"] != audit["wire_bytes_per_step"]:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"cost._comm_block predicts "
                    f"{cb['wire_bytes_per_step']} B/step but the audit "
                    f"derives {audit['wire_bytes_per_step']} B — the "
                    f"measured==predicted gate would certify a wrong "
                    f"number"))
            if cb.get("collectives_per_step") != \
                    audit["collectives_per_step"]:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"cost._comm_block counts "
                    f"{cb.get('collectives_per_step')} collective(s)/"
                    f"step but the audit derives "
                    f"{audit['collectives_per_step']}"))
            if cb.get("axis_wire_bytes", audit["axis_wire_bytes"]) \
                    != audit["axis_wire_bytes"]:
                out.append(self._diag(
                    graph, Diagnostic.ERROR,
                    f"cost._comm_block predicts per-axis "
                    f"{cb.get('axis_wire_bytes')} but the audit "
                    f"derives {audit['axis_wire_bytes']} — the "
                    f"per-axis measured==predicted gate would certify "
                    f"a wrong number"))

        if not out:
            per_axis = ", ".join(
                f"{a}={v}" for a, v in
                sorted(audit["axis_wire_bytes"].items()))
            out.append(self._diag(
                graph, Diagnostic.INFO,
                f"wire audit: {len(gplan.buckets)} bucket(s), "
                f"{audit['wire_bytes_per_step']} B/step on the wire "
                f"(fp32 baseline {audit['fp32_wire_bytes_per_step']} "
                f"B), {audit['collectives_per_step']} collective(s)/"
                f"step, {len(audit['gathers'])} forward gather(s) "
                f"[per-axis B: {per_axis}] — schedule, cost model and "
                f"independent re-derivation agree"))
        return out


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def shardcheck_passes(plan, backend: Optional[str] = None
                      ) -> List[AnalysisPass]:
    """The shardcheck pipeline for one plan (concrete ShardingPlan or
    :class:`AbstractPlan`), in dependency order."""
    return [
        PlanCoveragePass(plan),
        CollectiveChoreographyPass(plan, backend=backend),
        DeviceVaryingTaintPass(plan),
        WireByteAuditPass(plan),
    ]


SHARDCHECK_PASS_REGISTRY = {cls.name: cls for cls in (
    PlanCoveragePass, CollectiveChoreographyPass, DeviceVaryingTaintPass,
    WireByteAuditPass)}
