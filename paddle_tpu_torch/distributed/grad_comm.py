"""Quantized, bucketed gradient collectives with error feedback (the
counterpart of ``paddle_tpu/distributed/grad_comm.py``).

The gradient-communication stage the static Executor (under a
``ShardingPlan``) and ``SpmdTrainStep`` run between backward and the
optimizer update:

- **Quantized reduction**: gradients cross the wire as block-scaled
  int8 (one f32 absmax scale per ``block_size`` elements) or bf16
  instead of fp32.  The int8 route is the two-shot bandwidth
  algorithm: each rank quantizes its local (residual-corrected)
  gradient, an all-to-all exchanges int8 chunks and scales, every rank
  dequantizes and sums its chunk in f32, requantizes, and an all-gather
  of int8 chunks and scales rebuilds the reduced tensor.
- **Error feedback**: each rank's quantization error is returned as a
  per-rank residual and added into the next step's gradient before
  quantization.
- **Bucketing**: gradients fuse into flat buckets of
  ``strategy.fuse_grad_size_in_MB`` in backward production order
  (:func:`production_order`), each reduced by its own collectives.
- **Overlap** (``strategy.grad_comm.overlap``): ``"none"`` reduces every
  bucket after backward; ``"auto"`` resolves to ``"xla"``, the fused
  per-bucket collectives issued (``async_op=True``) as soon as the
  bucket's last gradient lands, in plan order; ``"ring"`` lowers each
  bandwidth-route bucket as single-chunk permutations.
- **Algorithm by message size**: a bucket whose quantized payload is at
  least ``scatter_threshold_KB`` takes the scatter route (reduce-scatter
  + all-gather, or the int8 two-shot); a smaller one takes one fused
  sum (at bf16 wire when the config asks for int8).

:func:`plan_reduction` computes the buckets, algorithms and the
per-rank wire bytes from gradient shapes alone (the ring model of
:func:`_wire_bytes`), so the cost model's prediction and the runtime's
``comm.wire_bytes`` stat are the same number by construction.  That
figure is the plan's count of what a ring moves, not what gloo or NCCL
put on a link.

Each process here is one rank, so where paddle_tpu calls a ``lax``
collective inside ``shard_map`` over an axis name, the port issues the
``torch.distributed`` collective over the rank's group of that axis
(``group``: a :class:`~.collective.Group` or an axis name).  Every sum
over ranks is :func:`_ascending_sum` over the rows an all-to-all (the
reduce-scatter of the bandwidth routes) or, for a latency-bound psum
bucket, a gather brought, so its result is the same on every run,
every backend and every path (NCCL and gloo promise no reduction
order); the ring path and the fused path are therefore bitwise equal
at fp32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collective import _gather, _resolve, collective_permute
from .mesh import DP_AXIS, MP_AXIS

__all__ = [
    "CommSpec", "Bucket", "GradCommPlan", "resolve", "plan_reduction",
    "build_buckets", "flatten_bucket", "unflatten_bucket",
    "quantize_int8_blocks", "dequantize_int8_blocks", "reduce_gradients",
    "source_label", "incompatibility", "plan_status", "classify_spec",
    "hybrid_layout", "plan_gathers", "gather_param", "bucket_flat_numel",
    "resolve_overlap_path", "production_order", "BucketReducer",
]

OVERLAP_MODES = ("none", "auto", "ring")

_WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}
_SCALE_BYTES = 4  # one f32 absmax per block


# ---------------------------------------------------------------------------
# config resolution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CommSpec:
    """Resolved, hashable grad-comm configuration (strategy knobs,
    bucket size, and which toggle asked for it)."""
    dtype: str                    # 'fp32' | 'bf16' | 'int8'
    block_size: int
    error_feedback: bool
    scatter_threshold_KB: float
    fuse_grad_size_in_MB: float
    source: str                   # 'grad_comm' | 'fp16_allreduce'
    overlap: str = "auto"         # 'none' | 'auto' | 'ring'

    def fingerprint(self) -> tuple:
        return (self.dtype, self.block_size, self.error_feedback,
                float(self.scatter_threshold_KB),
                float(self.fuse_grad_size_in_MB), self.overlap)


def resolve(strategy) -> Optional[CommSpec]:
    """The effective grad-comm spec of a DistributedStrategy, or None.
    ``strategy.grad_comm.dtype`` wins; ``strategy.fp16_allreduce`` is the
    alias for a bf16 wire without error feedback."""
    if strategy is None:
        return None
    gc = getattr(strategy, "grad_comm", None)
    fuse = float(getattr(strategy, "fuse_grad_size_in_MB", 32) or 32)
    overlap = str(getattr(gc, "overlap", "auto") or "auto") \
        if gc is not None else "auto"
    if gc is not None and gc.dtype is not None:
        return CommSpec(str(gc.dtype), int(gc.block_size),
                        bool(gc.error_feedback),
                        float(gc.scatter_threshold_KB), fuse, "grad_comm",
                        overlap)
    if getattr(strategy, "fp16_allreduce", False):
        block = int(gc.block_size) if gc is not None else 256
        thresh = (float(gc.scatter_threshold_KB) if gc is not None
                  else 32.0)
        return CommSpec("bf16", block, False, thresh, fuse,
                        "fp16_allreduce", overlap)
    return None


def resolve_overlap_path(cfg: "CommSpec") -> str:
    """The path the ``overlap`` knob resolves to: ``'none'`` (every
    bucket after backward), ``'xla'`` (the fused per-bucket collectives,
    each issued asynchronously as soon as its last gradient lands), or
    ``'ring'`` (single-chunk permutations).

    ``'auto'`` is ``'xla'`` whatever the process group's backend: gloo
    and NCCL both run ``async_op=True`` collectives beside the backward
    that is still running, so no backend needs the ring to overlap.
    (paddle_tpu takes a ``backend`` here and reads its XLA
    latency-hiding state, taking the ring on a TPU or GPU without it;
    the port has nothing to read.)"""
    if cfg.overlap == "none":
        return "none"
    if cfg.overlap == "ring":
        return "ring"
    return "xla"


# ---------------------------------------------------------------------------
# activation / compatibility (one predicate for every consumer)
# ---------------------------------------------------------------------------

def source_label(cfg: CommSpec) -> str:
    """The user-facing name of the toggle that asked for the stage."""
    return ("strategy.fp16_allreduce" if cfg.source == "fp16_allreduce"
            else f'strategy.grad_comm (dtype="{cfg.dtype}")')


def format_mesh_axes(mesh_shape, exclude: Sequence[str] = ()) -> str:
    """``'mp=2, pp=4'``: the one axis=degree renderer the mesh-shape
    messages share."""
    return ", ".join(f"{a}={int(s)}" for a, s in dict(mesh_shape).items()
                     if a not in exclude and int(s) > 1)


def classify_spec(spec, mesh_shape) -> Tuple[str, Optional[int]]:
    """Which grad-comm form a param's spec takes on this mesh:
    ``('rep', None)``, ``('fsdp', 0)`` (dp-sharded on dim 0),
    ``('mp', dim)`` or ``('bad', why)``."""
    shape = dict(mesh_shape)
    hits = []
    for d, e in enumerate(tuple(spec) if spec is not None else ()):
        if e is None:
            continue
        axes = [a for a in ((e,) if isinstance(e, str) else tuple(e))
                if int(shape.get(a, 1)) > 1]
        if axes:
            hits.append((d, tuple(axes)))
    if not hits:
        return "rep", None
    if len(hits) > 1:
        return "bad", "sharded over more than one tensor dimension"
    d, axes = hits[0]
    if len(axes) > 1:
        return "bad", (f"dim {d} sharded over multiple mesh axes "
                       f"{list(axes)}")
    ax = axes[0]
    if ax == DP_AXIS:
        if d != 0:
            return "bad", (f"dp-sharded on dim {d} — the FSDP form "
                           f"shards dim 0 only")
        return "fsdp", 0
    if ax == MP_AXIS:
        return "mp", d
    return "bad", (f"sharded over mesh axis {ax!r} — only 'dp' (dim 0) "
                   f"and 'mp' shards compose with grad_comm")


def incompatibility(cfg: CommSpec, mesh_shape,
                    sharded_params: Sequence = (),
                    hybrid: bool = False) -> Optional[str]:
    """Why the explicit reduction cannot run on this mesh / param
    layout, or None when it can: the single source of the constraint
    messages (SpmdTrainStep, the Executor and the cost model)."""
    src = source_label(cfg)
    if not hybrid:
        others = format_mesh_axes(mesh_shape, exclude=(DP_AXIS,))
        if others:
            return (f"{src} covers the data-parallel grad reduction; "
                    f"mesh axes [{others}] carry model shardings whose "
                    f"collectives GSPMD schedules — run it on a "
                    f"pure-dp mesh, or use the static Executor, whose "
                    f"grad_comm stage composes dp with 'mp' and FSDP "
                    f"shards.")
        sharded = list(sharded_params)
        if sharded:
            return (f"{src} + dp-sharded params (ZeRO-3 / partition "
                    f"rules: {sharded[:4]}): the explicit shard_map "
                    f"grad path would replicate them.  Keep params "
                    f"replicated (ZeRO stage <= 2) with it, or use the "
                    f"static Executor, which gathers FSDP shards ahead "
                    f"of forward and reduce-scatters grads back.")
        return None
    others = format_mesh_axes(mesh_shape, exclude=(DP_AXIS, MP_AXIS))
    if others:
        return (f"{src} composes the data-parallel grad reduction "
                f"with tensor-parallel 'mp' param gathers; mesh axes "
                f"[{others}] schedule cross-stage collectives "
                f"(pipeline/sequence parallel) this shard_map stage "
                f"cannot carry — drop those axes from the mesh or "
                f"disable grad_comm.")
    bad = []
    for name, spec in sharded_params:
        kind, why = classify_spec(spec, mesh_shape)
        if kind == "bad":
            bad.append(f"{name} ({why})")
    if bad:
        return (f"{src} carries dp-sharded (ZeRO-3, dim 0) and "
                f"mp-sharded param layouts; these param specs fit "
                f"neither form: {bad[:4]}.  Re-shard them via "
                f"partition rules / tp placements, or disable "
                f"grad_comm.")
    return None


def plan_status(plan) -> Tuple[str, Optional[str]]:
    """Activation state of a ShardingPlan's grad_comm spec: ``('off',
    None)`` (no spec, or a dp axis of one rank), ``('active', None)``,
    or ``('error', msg)``.  The Executor and the cost model share it, so
    they never disagree about which path runs."""
    cfg = getattr(plan, "grad_comm", None)
    if cfg is None:
        return "off", None
    if dict(plan.mesh.shape).get(DP_AXIS, 1) <= 1:
        return "off", None
    from .sharding import spec_axes
    sharded = [(n, s) for n, s in zip(plan.param_names, plan.param_specs)
               if spec_axes(s)]
    msg = incompatibility(cfg, plan.mesh.shape, sharded, hybrid=True)
    if msg is not None:
        return "error", msg
    return "active", None


# ---------------------------------------------------------------------------
# shared cause strings (the Executor's raise and the static report)
# ---------------------------------------------------------------------------

def fetch_rule_message(name: str, global_shape, shard_shape) -> str:
    """A fetch neither shard-invariant nor batch-major under dp."""
    return (f"grad_comm: fetch '{name}' (global {tuple(global_shape)}, "
            f"per-shard {tuple(shard_shape)}) "
            f"is neither shard-invariant nor batch-major — it "
            f"cannot be reconstructed from dp shards.  Fetch "
            f"batch-major or scalar-mean tensors, or disable "
            f"grad_comm.")


def sum_fetch_message(what: str, name: str) -> str:
    """A SUM-reduced loss/fetch under the dp-mean stage."""
    return (f"grad_comm: {what} '{name}' is SUM-reduced over the "
            f"batch — the dp-mean reduction this stage applies "
            f"would silently scale it (and its gradients) by "
            f"1/dp.  Use a mean reduction, or disable "
            f"grad_comm for this program.")


def overlap_note(cfg: "CommSpec") -> str:
    """How the ``overlap`` knob resolves (the same on every backend)."""
    path = resolve_overlap_path(cfg)
    if path == cfg.overlap:
        return f"grad_comm: overlap={cfg.overlap!r} lowers as requested"
    return (f"grad_comm: overlap={cfg.overlap!r} falls back to the "
            f"{path!r} lowering on every backend (each bucket's "
            f"collectives are issued asynchronously as its last "
            f"gradient lands)")


# ---------------------------------------------------------------------------
# block-scaled int8 quantization
# ---------------------------------------------------------------------------

def quantize_int8_blocks(x: torch.Tensor, block_size: int):
    """1-D float tensor -> (int8 blocks ``[nb, B]``, f32 scales
    ``[nb, 1]``).  Pads to a block multiple; scale = absmax/127 per
    block (zero blocks get scale 1 so dequantize is exact zero); the
    values are ``round(x / scale)`` half to even, clipped to ±127."""
    n = x.shape[0]
    pad = (-n) % block_size
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, pad)).reshape(
        -1, block_size)
    absmax = xp.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA turns a division by a host scalar into a
    # multiply by its reciprocal, which rounds differently
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8_blocks(q: torch.Tensor, scales: torch.Tensor,
                           numel: int) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_blocks` (drops the padding)."""
    return (q.to(torch.float32) * scales).reshape(-1)[:numel]


# ---------------------------------------------------------------------------
# backward production order
# ---------------------------------------------------------------------------

def production_order(program, params, loss_var=None,
                     graph=None) -> List[int]:
    """The order backward finalizes the gradients of ``params``
    (positions into that list), from the Program's DefUseGraph: each
    node's backward level is 1 + the max level of its consumers, and a
    param's gradient is final at the max level over its consumers;
    lower levels come earlier.  Ties break by descending first use.
    Params on no backward path sort last.  The Executor's buckets and
    the cost model both call this."""
    if graph is None:
        from ..static.analysis.graph import DefUseGraph
        graph = DefUseGraph(program)
    n = len(graph.nodes)
    live = None
    if loss_var is not None:
        lv = graph.resolve_fetch(loss_var)
        if lv is not None:
            live = graph.live_nodes([lv])
    level = [0] * n
    for i in range(n - 1, -1, -1):
        lv = 0
        for v in graph.nodes[i].out_vars:
            for j in graph.consumers_of.get(id(v), ()):
                if live is not None and j not in live:
                    continue
                if level[j] + 1 > lv:
                    lv = level[j] + 1
        level[i] = lv
    grad_level: Dict[int, int] = {}
    first_use: Dict[int, int] = {}
    for i, plist in graph.params_of.items():
        if live is not None and i not in live:
            continue
        for p in plist:
            pid = id(p)
            if level[i] > grad_level.get(pid, -1):
                grad_level[pid] = level[i]
            if i < first_use.get(pid, n):
                first_use[pid] = i
    keyed = []
    for pos, p in enumerate(params):
        gl = grad_level.get(id(p))
        if gl is None:
            keyed.append((1, 0, 0, pos))
        else:
            keyed.append((0, gl, -first_use.get(id(p), 0), pos))
    keyed.sort()
    return [k[-1] for k in keyed]


# ---------------------------------------------------------------------------
# buckets + plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Bucket:
    """One fused reduction: which grads it carries (in backward
    production order), how it crosses the wire and what that costs.
    ``issue_frac`` is the share of backward (by cumulative grad numel)
    complete when the bucket's last gradient lands."""
    indices: Tuple[int, ...]
    shapes: Tuple[tuple, ...]
    sizes: Tuple[int, ...]
    numel: int
    algorithm: str                # 'psum' | 'scatter' | 'rscatter' | 'none'
    wire_dtype: str               # 'fp32' | 'bf16' | 'int8'
    wire_bytes: int               # per-rank bytes per step
    collectives: int
    carries_residual: bool
    issue_frac: float = 1.0

    @property
    def classification(self) -> str:
        return ("none" if self.algorithm == "none"
                else "bandwidth" if self.algorithm in ("scatter",
                                                       "rscatter")
                else "latency")

    def to_dict(self) -> dict:
        return {
            "params": list(self.indices), "numel": self.numel,
            "algorithm": self.algorithm, "wire_dtype": self.wire_dtype,
            "wire_bytes": self.wire_bytes,
            "collectives": self.collectives,
            "classification": self.classification,
            "error_feedback": self.carries_residual,
            "issue_frac": round(self.issue_frac, 6),
        }


def build_buckets(shapes: Sequence[tuple], fuse_mb: float,
                  order: Optional[Sequence[int]] = None
                  ) -> List[Tuple[Tuple[int, ...], int]]:
    """Greedy bucket assembly over grads in backward production order
    (``order``, or reverse creation order when None): ``[(indices,
    numel)]``, each bucket at most ``fuse_mb`` MB of f32 payload (a
    single larger grad gets its own bucket)."""
    budget = max(int(float(fuse_mb) * (1 << 20)) // 4, 1)
    out: List[Tuple[Tuple[int, ...], int]] = []
    cur: List[int] = []
    cur_n = 0
    seq = (list(order) if order is not None
           else list(reversed(range(len(shapes)))))
    for i in seq:
        n = 1
        for d in shapes[i]:
            n *= int(d)
        if cur and cur_n + n > budget:
            out.append((tuple(cur), cur_n))
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += n
    if cur:
        out.append((tuple(cur), cur_n))
    return out


def _padded_numel(numel: int, multiple: int) -> int:
    return int(math.ceil(numel / multiple)) * multiple if multiple > 1 \
        else numel


def _int8_payload(numel: int, dp: int, block_size: int) -> int:
    """One direction's int8 payload: values padded so each rank owns a
    block-aligned chunk, plus one f32 scale per block."""
    np_ = _padded_numel(numel, dp * block_size)
    return np_ * 1 + (np_ // block_size) * _SCALE_BYTES


def _wire_bytes(numel: int, wire_dtype: str, algorithm: str, dp: int,
                block_size: int) -> int:
    """Per-rank wire bytes of one bucket's reduction under the ring
    model: an allreduce (or reduce-scatter + all-gather) moves
    ``2*(dp-1)/dp`` of the payload through every rank per step."""
    if dp <= 1 or algorithm == "none":
        return 0
    one_dir = (dp - 1) / dp
    if algorithm == "rscatter":
        if wire_dtype == "int8":
            payload = _int8_payload(numel, dp, block_size)
        else:
            payload = (_padded_numel(numel, dp)
                       * _WIRE_ITEMSIZE[wire_dtype])
        return int(round(one_dir * payload))
    ring = 2.0 * one_dir
    if wire_dtype == "int8":
        payload = _int8_payload(numel, dp, block_size)
    elif algorithm == "scatter":
        payload = _padded_numel(numel, dp) * _WIRE_ITEMSIZE[wire_dtype]
    else:
        payload = numel * _WIRE_ITEMSIZE[wire_dtype]
    return int(round(ring * payload))


def _gather_wire_bytes(numel: int, size: int) -> int:
    """One param all-gather's per-rank wire bytes: ``(size-1)/size`` of
    the f32 payload."""
    if size <= 1:
        return 0
    return int(round((size - 1) / size * numel * 4))


def plan_gathers(shapes: Sequence[tuple], kinds: Sequence[tuple],
                 mesh_shape, order: Optional[Sequence[int]] = None
                 ) -> List[dict]:
    """The param-gather schedule of the hybrid grad path: one all-gather
    per sharded param (FSDP over 'dp' dim 0, tensor-parallel over 'mp'
    on its sharded dim), in reverse backward production order.  Returns
    ``[{index, axis, size, dim, numel, wire_bytes}]``."""
    shape = dict(mesh_shape)
    seq = (list(order) if order is not None
           else list(range(len(shapes))))
    gathers: List[dict] = []
    for i in reversed(seq):
        kind, dim = kinds[i]
        if kind == "rep":
            continue
        ax = DP_AXIS if kind == "fsdp" else MP_AXIS
        size = int(shape.get(ax, 1))
        numel = int(np.prod(shapes[i])) if shapes[i] else 1
        gathers.append({
            "index": int(i), "axis": ax, "size": size,
            "dim": int(dim or 0), "numel": numel,
            "wire_bytes": _gather_wire_bytes(numel, size)})
    return gathers


def hybrid_layout(plan, named_shapes: Sequence[Tuple[str, tuple]],
                  order: Optional[Sequence[int]] = None):
    """Per-trainable-param classification and the gather schedule, from
    the plan's specs: ``(kinds, fsdp positions, gathers)``.  Raises on
    specs outside the supported forms."""
    shape = dict(plan.mesh.shape)
    kinds: List[Tuple[str, Optional[int]]] = []
    for name, shp in named_shapes:
        spec = plan.spec_by_name(name)
        kind, dim = classify_spec(spec, shape)
        if kind == "bad":
            raise NotImplementedError(
                f"grad_comm: param '{name}' spec {spec} — {dim}")
        kinds.append((kind, dim))
    fsdp = tuple(i for i, (k, _) in enumerate(kinds) if k == "fsdp")
    gathers = plan_gathers([s for _, s in named_shapes], kinds, shape,
                           order=order)
    return kinds, fsdp, gathers


class GradCommPlan:
    """Static reduction plan: buckets, algorithms, wire bytes.  Its
    byte totals are what the Executor adds to ``comm.wire_bytes`` per
    step and what the cost model reports as ``predicted_wire_bytes``."""

    __slots__ = ("cfg", "dp", "buckets", "wire_bytes_per_step",
                 "collectives_per_step", "fp32_wire_bytes_per_step",
                 "overlap_path", "gathers", "gather_wire_bytes_per_step",
                 "axis_wire_bytes")

    def __init__(self, cfg: CommSpec, dp: int, buckets: List[Bucket],
                 gathers: Sequence[dict] = ()):
        self.cfg = cfg
        self.dp = int(dp)
        self.buckets = buckets
        self.wire_bytes_per_step = sum(b.wire_bytes for b in buckets)
        self.collectives_per_step = sum(b.collectives for b in buckets)
        self.overlap_path = resolve_overlap_path(cfg)
        self.gathers = list(gathers)
        self.gather_wire_bytes_per_step = sum(
            g["wire_bytes"] for g in self.gathers)
        axis: Dict[str, int] = {DP_AXIS: self.wire_bytes_per_step}
        for g in self.gathers:
            axis[g["axis"]] = axis.get(g["axis"], 0) + g["wire_bytes"]
        self.axis_wire_bytes = axis
        total = sum(b.numel for b in buckets)
        self.fp32_wire_bytes_per_step = _wire_bytes(
            total, "fp32", "psum", self.dp, cfg.block_size)

    @property
    def residual_buckets(self) -> List[Bucket]:
        return [b for b in self.buckets if b.carries_residual]

    def algo_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for b in self.buckets:
            out[b.algorithm] = out.get(b.algorithm, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "dtype": self.cfg.dtype, "dp": self.dp,
            "block_size": self.cfg.block_size,
            "error_feedback": self.cfg.error_feedback,
            "scatter_threshold_KB": self.cfg.scatter_threshold_KB,
            "fuse_grad_size_in_MB": self.cfg.fuse_grad_size_in_MB,
            "overlap": self.cfg.overlap,
            "overlap_path": self.overlap_path,
            "wire_bytes_per_step": self.wire_bytes_per_step,
            "fp32_wire_bytes_per_step": self.fp32_wire_bytes_per_step,
            "collectives_per_step": self.collectives_per_step,
            "gather_wire_bytes_per_step": self.gather_wire_bytes_per_step,
            "axis_wire_bytes": dict(self.axis_wire_bytes),
            "gathers": [dict(g) for g in self.gathers],
            "buckets": [b.to_dict() for b in self.buckets],
        }

    def schedule(self) -> dict:
        """The bucket schedule the compile record carries: per bucket
        its size, algorithm, wire dtype and bytes, issue point, with the
        overlap knob and the path it resolved to."""
        return {
            "overlap": self.cfg.overlap,
            "path": self.overlap_path,
            "dp": self.dp,
            "wire_bytes_per_step": self.wire_bytes_per_step,
            "axis_wire_bytes": dict(self.axis_wire_bytes),
            "gathers": [dict(g) for g in self.gathers],
            "buckets": [b.to_dict() for b in self.buckets],
        }

    def __repr__(self):
        return (f"GradCommPlan(dtype={self.cfg.dtype}, dp={self.dp}, "
                f"buckets={len(self.buckets)}, "
                f"wire={self.wire_bytes_per_step}B/step "
                f"[fp32 {self.fp32_wire_bytes_per_step}B], "
                f"algos={self.algo_counts()}, "
                f"overlap={self.cfg.overlap}->{self.overlap_path})")


def plan_reduction(shapes: Sequence[tuple], dp: int, cfg: CommSpec,
                   order: Optional[Sequence[int]] = None,
                   fsdp: Sequence[int] = (),
                   gathers: Sequence[dict] = ()) -> GradCommPlan:
    """Assemble buckets over gradient ``shapes`` (creation order;
    ``order`` is the backward production order, default reverse
    creation) and pick each bucket's wire dtype and algorithm.  ``fsdp``
    names the positions whose params are dp-sharded on dim 0: their
    grads form dedicated ``'rscatter'`` buckets (reduce-scatter only).
    ``gathers`` rides the plan for per-axis accounting."""
    fsdp_set = frozenset(int(i) for i in fsdp)
    seq = (list(order) if order is not None
           else list(reversed(range(len(shapes)))))
    numels = [int(np.prod(s)) if s else 1 for s in shapes]
    rank = {i: r for r, i in enumerate(seq)}
    prefix = []
    cum = 0
    for i in seq:
        cum += numels[i]
        prefix.append(cum)
    total_numel = max(cum, 1)

    def _mk(indices, numel, algo, wire, n_coll):
        carries = (cfg.error_feedback and algo != "none"
                   and wire != "fp32")
        last = max(prefix[rank[i]] for i in indices)
        return Bucket(
            indices=indices,
            shapes=tuple(tuple(shapes[i]) for i in indices),
            sizes=tuple(numels[i] for i in indices),
            numel=numel, algorithm=algo, wire_dtype=wire,
            wire_bytes=_wire_bytes(numel, wire, algo, dp, cfg.block_size),
            collectives=n_coll, carries_residual=carries,
            issue_frac=last / total_numel)

    buckets: List[Bucket] = []
    normal_seq = [i for i in seq if i not in fsdp_set]
    fsdp_seq = [i for i in seq if i in fsdp_set]
    for indices, numel in build_buckets(
            shapes, cfg.fuse_grad_size_in_MB, order=normal_seq):
        if dp <= 1:
            algo, wire = "none", cfg.dtype
        else:
            if cfg.dtype == "int8":
                payload = _int8_payload(numel, dp, cfg.block_size)
            else:
                payload = numel * _WIRE_ITEMSIZE[cfg.dtype]
            if payload >= cfg.scatter_threshold_KB * 1024:
                algo, wire = "scatter", cfg.dtype
            else:
                algo = "psum"
                wire = "bf16" if cfg.dtype == "int8" else cfg.dtype
        if algo == "none":
            n_coll = 0
        elif algo == "psum":
            n_coll = 1
        elif wire == "int8":
            n_coll = 4
        else:
            n_coll = 2
        buckets.append(_mk(indices, numel, algo, wire, n_coll))
    for indices, numel in build_buckets(
            shapes, cfg.fuse_grad_size_in_MB, order=fsdp_seq):
        if dp <= 1:
            buckets.append(_mk(indices, numel, "none", cfg.dtype, 0))
            continue
        if cfg.dtype == "int8":
            payload = _int8_payload(numel, dp, cfg.block_size)
            wire = ("int8" if payload >= cfg.scatter_threshold_KB * 1024
                    else "bf16")
        else:
            wire = cfg.dtype
        n_coll = 2 if wire == "int8" else 1
        buckets.append(_mk(indices, numel, "rscatter", wire, n_coll))
    buckets.sort(key=lambda b: (b.issue_frac,
                                min(rank[i] for i in b.indices)))
    return GradCommPlan(cfg, dp, buckets, gathers=gathers)


# ---------------------------------------------------------------------------
# bucket (dis)assembly (bitwise)
# ---------------------------------------------------------------------------

def flatten_bucket(grads: Sequence, bucket: Bucket) -> torch.Tensor:
    """The bucket's grads as one flat f32 vector, in the bucket's
    production order."""
    return torch.cat([grads[i].to(torch.float32).reshape(-1)
                      for i in bucket.indices])


def unflatten_bucket(flat: torch.Tensor, bucket: Bucket, like: Sequence):
    """Split a flat vector back into the bucket's grads (bitwise
    inverse of :func:`flatten_bucket`; shape and dtype from ``like``).
    Returns ``[(index, grad)]``."""
    out = []
    off = 0
    for i, n, shp in zip(bucket.indices, bucket.sizes, bucket.shapes):
        out.append((i, flat[off:off + n].reshape(shp).to(like[i].dtype)))
        off += n
    return out


def fsdp_row_len(bucket: Bucket, dp: int, block_size: int) -> int:
    """Per-rank row length of an ``'rscatter'`` bucket's shard-major
    flat layout (``numel/dp``, block-padded on int8 wire)."""
    row = bucket.numel // dp
    if bucket.wire_dtype == "int8":
        row = _padded_numel(row, block_size)
    return row


def bucket_flat_numel(bucket: Bucket, dp: int, block_size: int) -> int:
    """Length of a bucket's flat working vector and of its EF residual:
    ``numel`` for gathered buckets, ``dp x padded row`` for FSDP
    reduce-scatter buckets."""
    if bucket.algorithm != "rscatter":
        return bucket.numel
    return dp * fsdp_row_len(bucket, dp, block_size)


def flatten_bucket_fsdp(grads: Sequence, bucket: Bucket, dp: int,
                        block_size: int) -> torch.Tensor:
    """Shard-major flatten of an ``'rscatter'`` bucket: ``[dp,
    row_len]`` row-major, row r holding every member grad's r-th dim-0
    shard."""
    rows = torch.cat([grads[i].to(torch.float32).reshape(dp, -1)
                      for i in bucket.indices], dim=1)
    row = fsdp_row_len(bucket, dp, block_size)
    pad = row - rows.shape[1]
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.reshape(-1)


def unflatten_bucket_fsdp(chunk: torch.Tensor, bucket: Bucket, dp: int,
                          like: Sequence):
    """Split my reduced chunk (one row of the shard-major layout) into
    the bucket's per-param dim-0 shard grads: ``[(index, grad)]`` with
    shard shape ``(d0/dp, *rest)``, dtype from ``like``."""
    out = []
    off = 0
    for i, n, shp in zip(bucket.indices, bucket.sizes, bucket.shapes):
        ln = n // dp
        piece = chunk[off:off + ln].reshape((int(shp[0]) // dp,)
                                            + tuple(shp[1:]))
        out.append((i, piece.to(like[i].dtype)))
        off += ln
    return out


# ---------------------------------------------------------------------------
# the collectives (every sum is a gather + an ascending sum)
# ---------------------------------------------------------------------------

def _chunked_all_to_all(rows, group):
    """``all_to_all`` as ``n - 1`` single-chunk permutations: ``rows[k]``
    is the chunk for member k; returns ``[n, ...]`` whose row k is the
    chunk member k sent here.  At step s member d sends
    ``rows[(d - s) % n]`` to member ``(d - s) % n``."""
    g = _resolve(group)
    n, idx = g.nranks, g.rank
    got = [rows[idx]]
    for s in range(1, n):
        perm = [(d, (d - s) % n) for d in range(n)]
        got.append(collective_permute(rows[(idx - s) % n], perm, g))
    # got[s] came from member (idx + s) % n: roll so row k = member k
    return torch.roll(torch.stack(got), idx, dims=0)


def _chunked_all_gather(chunk, group):
    """``all_gather`` as ``n - 1`` single-chunk permutations: ``[n,
    ...]`` with row k = member k's chunk."""
    g = _resolve(group)
    n, idx = g.nranks, g.rank
    got = [chunk]
    for s in range(1, n):
        perm = [(d, (d - s) % n) for d in range(n)]
        got.append(collective_permute(chunk, perm, g))
    return torch.roll(torch.stack(got), idx, dims=0)


def _ascending_sum(rows, n: int):
    """Left-to-right sum of ``rows[0..n-1]``: the accumulation order is
    the members' ascending order, the same on every run and every
    backend (NCCL and gloo reductions promise no order)."""
    total = rows[0]
    for k in range(1, n):
        total = total + rows[k]
    return total


class _Pending:
    """A collective issued with ``async_op=True`` and the closure that
    turns its output into the result once it is done."""

    def __init__(self, work, finish):
        self.work = work
        self.finish = finish

    def result(self):
        if self.work is not None:
            self.work.wait()
        return self.finish()


def _all_to_all(rows: torch.Tensor, g, ring: bool, async_op=False):
    """``[n, ...]`` rows -> ``[n, ...]``, row k from member k."""
    if ring:
        out = _chunked_all_to_all(rows, g)
        return _Pending(None, lambda: out) if async_op else out
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    work = dist.all_to_all_single(out, rows, group=g.process_group,
                                  async_op=async_op)
    return _Pending(work, lambda: out) if async_op else out


def _all_gather_rows(chunk: torch.Tensor, g, ring: bool, async_op=False):
    """This rank's chunk -> ``[n, ...]``, row k = member k's chunk."""
    if ring:
        out = _chunked_all_gather(chunk, g)
        return _Pending(None, lambda: out) if async_op else out
    parts = [torch.empty_like(chunk) for _ in range(g.nranks)]
    work = dist.all_gather(parts, chunk.contiguous(), group=g.process_group,
                           async_op=async_op)
    if async_op:
        return _Pending(work, lambda: torch.stack(parts))
    return torch.stack(parts)


def _psum(x: torch.Tensor, g, async_op=False):
    """The sum over the group, in ascending member order."""
    n = g.nranks
    if async_op:
        pend = _all_gather_rows(x, g, False, async_op=True)
        return _Pending(pend.work,
                        lambda: _ascending_sum(pend.finish(), n))
    return _ascending_sum(_all_gather_rows(x, g, False), n)


def _rs_ag(x, g, dp: int, ring: bool = False):
    """Bandwidth route for non-int8 wire: pad to a dp multiple, each
    rank reduces its chunk (all-to-all + ascending sum), all-gather
    back."""
    n = x.shape[0]
    np_ = _padded_numel(n, dp)
    rows = torch.nn.functional.pad(x, (0, np_ - n)).reshape(dp, np_ // dp)
    total = _ascending_sum(_all_to_all(rows, g, ring), dp)
    return _all_gather_rows(total, g, ring).reshape(-1)[:n]


_SCATTER_MIN_BYTES = 32 * 1024   # grad_comm.scatter_threshold_KB's default


def sum_over(x: torch.Tensor, g):
    """The sum of ``x`` over the group, in ascending member order: one
    gather of every rank's copy below 32 KB (latency bound), else a
    reduce-scatter and an all-gather, which move ``2(n-1)/n`` of the
    bytes and give the same sum bitwise."""
    if x.numel() * x.element_size() < _SCATTER_MIN_BYTES:
        return _psum(x.contiguous(), g)
    return _rs_ag(x.reshape(-1), g, g.nranks).reshape(x.shape)


def _rs_only(x, g, dp: int, ring: bool):
    """Reduce-scatter without the all-gather leg: my chunk of the sum
    (``x``'s length is a dp multiple by the FSDP layout)."""
    rows = x.reshape(dp, x.shape[0] // dp)
    return _ascending_sum(_all_to_all(rows, g, ring), dp)


def gather_param(shard, group, size: int, dim: int = 0, ring: bool = False):
    """All-gather one sharded tensor to its full value along ``dim``.
    ``ring=True`` decomposes it into ``size-1`` single-chunk
    permutations.  Wire bytes either way: ``(size-1)/size`` of the
    payload (:func:`_gather_wire_bytes`)."""
    if size <= 1:
        return shard
    g = _resolve(group)
    if g.nranks != size:
        raise ValueError(f"gather_param: size {size}, the group has "
                         f"{g.nranks} ranks")
    dim = dim % shard.dim()
    if ring:
        moved = shard.movedim(dim, 0)
        rows = _chunked_all_gather(moved, g)
        full = rows.reshape((size * moved.shape[0],)
                            + tuple(moved.shape[1:]))
        return full.movedim(0, dim)
    return _gather(shard, g, dim)


class _Payload:
    """A bucket's wire payload, built once per step: the flat gradient,
    the residual-corrected ``carry``, and what crosses the wire (``sent``
    on fp32/bf16 wire; on int8 wire the padded carry and its blocks
    ``q``, ``s``).  The overlapped path builds it in the backward hook
    and the reduction reuses it."""

    __slots__ = ("flat", "carry", "sent", "padded", "q", "s")

    def __init__(self, flat, residual, bucket: Bucket, plan: "GradCommPlan"):
        self.flat = flat
        self.carry = self.sent = self.padded = self.q = self.s = None
        if bucket.algorithm == "none":
            return
        carry = flat + residual if residual is not None else flat
        self.carry = carry
        if bucket.wire_dtype != "int8":
            self.sent = (carry if bucket.wire_dtype == "fp32"
                         else carry.to(torch.bfloat16))
            return
        block = plan.cfg.block_size
        n = carry.shape[0]
        # an FSDP bucket's shard-major layout is block-padded already
        self.padded = (carry if bucket.algorithm == "rscatter"
                       else torch.nn.functional.pad(
                           carry, (0, _padded_numel(n, plan.dp * block) - n)))
        self.q, self.s = quantize_int8_blocks(self.padded, block)


def _int8_first(pl: _Payload, g, dp: int, block: int, ring: bool,
                async_op=False):
    """Shot one of the int8 routes: the all-to-all of the blocks and
    their scales."""
    cb = pl.padded.shape[0] // dp // block
    qq = _all_to_all(pl.q.reshape(dp, cb, block), g, ring, async_op)
    ss = _all_to_all(pl.s.reshape(dp, cb, 1), g, ring, async_op)
    return qq, ss


def _reduce_int8_scatter(pl: _Payload, g, dp: int, block: int,
                         error_feedback: bool, ring: bool = False,
                         first=None):
    """The two-shot block-scaled int8 reduction of the residual-
    corrected flat carry.  Returns (reduced sum f32, per-rank residual
    or None).  ``first`` is shot one's exchange when it was already
    issued (the overlapped path)."""
    n = pl.carry.shape[0]
    np_ = pl.padded.shape[0]
    chunk = np_ // dp
    qq, ss = (_int8_first(pl, g, dp, block, ring) if first is None
              else first)
    red_chunk = _ascending_sum(qq.to(torch.float32) * ss, dp).reshape(-1)
    q2, s2 = quantize_int8_blocks(red_chunk, block)
    qg = _all_gather_rows(q2.reshape(-1), g, ring)
    sg = _all_gather_rows(s2.reshape(-1), g, ring)
    total = dequantize_int8_blocks(qg.reshape(-1, block),
                                   sg.reshape(-1, 1), n)
    if not error_feedback:
        return total, None
    # residual: my local quantize error everywhere, plus the requantize
    # error on the chunk I own (only I know it; the next step's sum
    # recovers it exactly once)
    e1 = pl.padded - dequantize_int8_blocks(pl.q, pl.s, np_)
    e2 = red_chunk - dequantize_int8_blocks(q2, s2, chunk)
    idx = g.rank
    e1[idx * chunk:(idx + 1) * chunk] += e2
    return total, e1[:n]


def _reduce_int8_rscatter(pl: _Payload, g, dp: int, block: int,
                          error_feedback: bool, ring: bool = False,
                          first=None):
    """One-shot block-scaled int8 reduce-scatter for FSDP buckets: each
    rank keeps its own chunk, so there is no second shot and no
    requantize error.  Returns (my reduced chunk f32, residual or
    None)."""
    n = pl.carry.shape[0]
    qq, ss = (_int8_first(pl, g, dp, block, ring) if first is None
              else first)
    red_chunk = _ascending_sum(qq.to(torch.float32) * ss, dp).reshape(-1)
    if not error_feedback:
        return red_chunk, None
    return red_chunk, pl.carry - dequantize_int8_blocks(pl.q, pl.s, n)


def _reduce_bucket_fsdp(pl: _Payload, residual, g, bucket: Bucket,
                        plan: "GradCommPlan", ring: bool = False,
                        first=None):
    """Reduce one FSDP (``'rscatter'``) bucket: returns (my mean chunk
    f32, new residual or None)."""
    dp = plan.dp
    wire = bucket.wire_dtype
    if wire == "fp32":
        chunk = (_rs_only(pl.sent, g, dp, ring) if first is None
                 else _ascending_sum(first, dp))
        new_res = None if residual is None else torch.zeros_like(residual)
        return chunk / dp, new_res
    if wire == "bf16":
        chunk = (_rs_only(pl.sent, g, dp, ring) if first is None
                 else _ascending_sum(first, dp)).to(torch.float32)
        new_res = (pl.carry - pl.sent.to(torch.float32)
                   if bucket.carries_residual and residual is not None
                   else None)
        return chunk / dp, new_res
    chunk, new_res = _reduce_int8_rscatter(
        pl, g, dp, plan.cfg.block_size,
        bucket.carries_residual and residual is not None, ring=ring,
        first=first)
    return chunk / dp, new_res


def _reduce_bucket(pl: _Payload, residual, g, bucket: Bucket,
                   plan: "GradCommPlan", ring: bool = False, first=None):
    """Reduce one bucket's payload over the dp group following the
    plan.  Returns (mean f32 vector, or my mean chunk for an
    ``'rscatter'`` bucket; new residual or None).  Latency-bound psum
    buckets stay one fused gather on every path."""
    dp = plan.dp
    if bucket.algorithm == "none":
        return pl.flat, residual
    if bucket.algorithm == "rscatter":
        return _reduce_bucket_fsdp(pl, residual, g, bucket, plan,
                                   ring=ring, first=first)
    wire = bucket.wire_dtype
    if wire in ("fp32", "bf16"):
        sent = pl.sent
        if bucket.algorithm == "psum":
            total = (_psum(sent, g) if first is None
                     else _ascending_sum(first, dp))
        elif first is None:
            total = _rs_ag(sent, g, dp, ring)
        else:
            n = sent.shape[0]
            red = _ascending_sum(first, dp)
            total = _all_gather_rows(red, g, ring).reshape(-1)[:n]
        total = total.to(torch.float32)
        if wire == "fp32":
            new_res = None if residual is None else torch.zeros_like(
                residual)
        else:
            new_res = (pl.carry - sent.to(torch.float32)
                       if bucket.carries_residual and residual is not None
                       else None)
        return total / dp, new_res
    total, new_res = _reduce_int8_scatter(
        pl, g, dp, plan.cfg.block_size,
        bucket.carries_residual and residual is not None, ring=ring,
        first=first)
    return total / dp, new_res


def _issue_first(pl: _Payload, g, bucket: Bucket, plan: "GradCommPlan"):
    """Issue a bucket's first collective asynchronously (the ``'xla'``
    path): returns a callable giving what :func:`_reduce_bucket` takes
    as ``first`` once the collective is done."""
    dp = plan.dp
    if bucket.wire_dtype == "int8":
        pq, ps = _int8_first(pl, g, dp, plan.cfg.block_size, False,
                             async_op=True)
        return lambda: (pq.result(), ps.result())
    sent = pl.sent
    if bucket.algorithm == "psum":
        pend = _all_gather_rows(sent, g, False, async_op=True)
    else:
        n = sent.shape[0]
        np_ = _padded_numel(n, dp)
        rows = torch.nn.functional.pad(sent, (0, np_ - n)).reshape(
            dp, np_ // dp)
        pend = _all_to_all(rows, g, False, async_op=True)
    return pend.result


def _flatten(grads, bucket: Bucket, plan: "GradCommPlan"):
    return (flatten_bucket_fsdp(grads, bucket, plan.dp, plan.cfg.block_size)
            if bucket.algorithm == "rscatter"
            else flatten_bucket(grads, bucket))


def reduce_gradients(grads: Sequence, *, plan: "GradCommPlan",
                     group=DP_AXIS, residuals: Optional[Sequence] = None,
                     mode: Optional[str] = None, issued=None):
    """Reduce this rank's gradients to their dp-mean following ``plan``.

    ``grads`` are the local gradients, one per trainable param in
    creation order; ``residuals`` the per-rank error-feedback carry,
    one flat f32 vector per ``plan.residual_buckets`` entry in plan
    order (None: no error feedback).  ``mode`` is the overlap path
    (default the plan's): ``'ring'`` runs the bandwidth routes as
    single-chunk permutations; ``'none'`` and ``'xla'`` the fused
    collectives.  ``issued`` maps bucket positions to what
    :class:`BucketReducer` already built and issued during backward
    (the payload and its first collective), which is not built again.

    Returns ``(reduced grads, new residuals)``: replicated means in the
    original order, shape and dtype, except params in ``'rscatter'``
    buckets, whose entries are this rank's dim-0 shard of the mean."""
    mode = plan.overlap_path if mode is None else mode
    g = _resolve(group)
    out = list(grads)
    new_res: List = []
    ri = 0
    for bi, bucket in enumerate(plan.buckets):
        res = None
        if residuals is not None and bucket.carries_residual:
            res = residuals[ri]
        if issued is not None and bi in issued:
            pl, pending = issued[bi]
            first = pending()
        else:
            pl = _Payload(_flatten(grads, bucket, plan), res, bucket, plan)
            first = None
        red, r2 = _reduce_bucket(pl, res, g, bucket, plan,
                                 ring=(mode == "ring"), first=first)
        if residuals is not None and bucket.carries_residual:
            new_res.append(r2 if r2 is not None
                           else torch.zeros_like(pl.flat))
            ri += 1
        pieces = (unflatten_bucket_fsdp(red, bucket, plan.dp, grads)
                  if bucket.algorithm == "rscatter"
                  else unflatten_bucket(red, bucket, grads))
        for i, gr in pieces:
            out[i] = gr
    return out, new_res


class BucketReducer:
    """The ``'xla'`` overlap path during backward: each bucket's payload
    is built and its first collective issued (``async_op=True``) as soon
    as its last gradient has landed and every bucket before it in plan
    order has been issued, so the collectives run beside the backward
    still producing later buckets, in the same order on every rank.
    Feed it each gradient with :meth:`arrived`; :attr:`issued` is what
    :func:`reduce_gradients` takes to finish the buckets."""

    def __init__(self, plan: "GradCommPlan", group=DP_AXIS,
                 residuals: Optional[Sequence] = None):
        self.plan = plan
        self.g = _resolve(group)
        self.grads: Dict[int, torch.Tensor] = {}
        self._res = {}
        ri = 0
        for bi, b in enumerate(plan.buckets):
            if residuals is not None and b.carries_residual:
                self._res[bi] = residuals[ri]
                ri += 1
        self._next = 0
        self.issued: Dict[int, tuple] = {}

    def arrived(self, i: int, grad: torch.Tensor) -> None:
        self.grads[i] = grad
        buckets = self.plan.buckets
        while self._next < len(buckets):
            b = buckets[self._next]
            if b.algorithm == "none" or any(j not in self.grads
                                            for j in b.indices):
                return
            pl = _Payload(_flatten(self.grads, b, self.plan),
                          self._res.get(self._next), b, self.plan)
            self.issued[self._next] = (pl, _issue_first(pl, self.g, b,
                                                        self.plan))
            self._next += 1
