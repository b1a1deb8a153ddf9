"""The static cost model (the counterpart of
``paddle_tpu/static/analysis/cost.py``): FLOPs and bytes per op, a
roofline per chip spec, donation-aware peak bytes, the hazards and the
fusion candidates, all from the recorded shapes of the op list (no
execution, no profiler).

Every op lands in exactly one of *modeled* (a rule below priced it) or
the explicit ``unmodeled`` bucket, whose op count and bytes ride every
total: a report never undercounts quietly because an op had no rule.
The rules are the JAX package's, so the FLOPs of one program agree with
paddle_tpu's.

Entry points:

- :func:`analyze` / ``Program.analyze(...)`` -> :class:`ProgramReport`;
- :func:`compile_summary`: the slice the static Executor keeps on each
  built step (``step.predicted``: FLOPs, peak bytes, the unmodeled
  count), priced at the run's feed shapes against
  :func:`resolve_perf_chip`'s row;
- :data:`CHIP_SPECS`: the roofline rows ``cpu`` and ``h100``.

Shapes are re-derived by replaying every op on ``meta`` tensors under
the given feed shapes (a dynamic dim records as 1).  A fusion candidate
is a maximal chain of single-consumer ops, ranked by the bytes a fused
kernel saves: each intermediate written by one op and read back by the
next (twice its size) stays on chip when the chain runs as one kernel.

Under a sharding plan (``analyze(sharding=plan)``) the report adds
``memory_per_shard`` (each parameter, with its gradient and slots,
divided by its spec's axis sizes; activations by the batch axes) and
the ``comm`` block: the gradient-communication plan the Executor runs
(the same :func:`~...distributed.grad_comm.plan_reduction`, so
``predicted_wire_bytes`` is the runtime's ``comm.wire_bytes`` per
step), per-axis wire bytes and the gather schedule, and the exposed
share of the comm seconds on each chip row.
"""
from __future__ import annotations

import json
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..program import (Program, Variable, infer_outputs, param_aval,
                       to_meta)
from .graph import DefUseGraph
from .liveness import MemoryEstimate, aval_bytes, estimate_memory
from .passes import Diagnostic

__all__ = ["ChipSpec", "CHIP_SPECS", "OpCost", "ProgramReport",
           "analyze", "compile_summary", "resolve_perf_chip",
           "_propagate_avals", "_fusion_candidates", "_FUSABLE"]


class ChipSpec:
    """The roofline corner of one device: peak FLOP/s, memory bytes/s,
    memory bytes and the interconnect's bytes/s per device."""

    __slots__ = ("name", "peak_flops", "hbm_bw", "hbm_bytes", "ici_bw")

    def __init__(self, name: str, peak_flops: float, hbm_bw: float,
                 hbm_bytes: int, ici_bw: float = 0.0):
        self.name = name
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self.hbm_bytes = int(hbm_bytes)
        self.ici_bw = float(ici_bw)

    def to_dict(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "hbm_bytes": self.hbm_bytes,
                "ici_bw": self.ici_bw}


CHIP_SPECS: Dict[str, ChipSpec] = {
    # a nominal host CPU (the JAX package's row)
    "cpu": ChipSpec("cpu", 200e9, 40e9, 16 << 30, 20e9),
    # NVIDIA's published H100 SXM5 figures: dense bf16, HBM3, NVLink
    "h100": ChipSpec("h100", 989e12, 3.35e12, 80 << 30, 900e9),
}


# ---------------------------------------------------------------------------
# per-op FLOP rules (the JAX package's tables)
# ---------------------------------------------------------------------------

def _numel(aval) -> int:
    n = 1
    for s in aval.shape:
        n *= int(s)
    return n


# elementwise ops: flops = factor * output elements
_ELEMENTWISE: Dict[str, int] = {
    "add": 1, "subtract": 1, "multiply": 1, "divide": 1, "pow": 1,
    "scale": 2, "clip": 2, "abs": 1, "negative": 1, "sign": 1,
    "maximum": 1, "minimum": 1, "floor": 1, "ceil": 1, "round": 1,
    "square": 1, "reciprocal": 1, "remainder": 1, "floor_divide": 1,
    "equal": 1, "not_equal": 1, "greater_than": 1, "greater_equal": 1,
    "less_than": 1, "less_equal": 1, "logical_and": 1, "logical_or": 1,
    "logical_not": 1, "logical_xor": 1, "bitwise_not": 1, "where": 1,
    "isnan": 1, "isinf": 1, "isfinite": 1, "isclose": 4, "add_n": 1,
    "relu": 1, "relu6": 2, "leaky_relu": 2, "prelu": 2, "hardtanh": 2,
    "hardshrink": 2, "softshrink": 2, "thresholded_relu": 2,
    "hardsigmoid": 3, "maxout": 2, "masked_fill": 1, "increment": 1,
    "exp": 10, "log": 10, "log2": 10, "log10": 10, "log1p": 10,
    "expm1": 10, "sqrt": 10, "rsqrt": 10, "sin": 10, "cos": 10,
    "tan": 10, "asin": 10, "acos": 10, "atan": 10, "sinh": 10,
    "cosh": 10, "tanh": 10, "asinh": 10, "acosh": 10, "atanh": 10,
    "sigmoid": 10, "log_sigmoid": 12, "softplus": 12, "silu": 11,
    "swish": 11, "gelu": 14, "elu": 11, "selu": 12, "celu": 11,
    "stanh": 11, "mish": 14, "erf": 10, "erfinv": 12,
    "dropout": 3, "alpha_dropout": 4, "label_smooth": 2,
    "lerp": 3, "logaddexp": 12, "nan_to_num": 2, "one_hot": 1,
    "gumbel_softmax": 15, "deg2rad": 1, "rad2deg": 1, "cast": 0,
}

# reductions: flops = factor * input elements
_REDUCE: Dict[str, int] = {
    "sum": 1, "mean": 1, "max": 1, "min": 1, "prod": 1, "all": 1,
    "any": 1, "argmax": 1, "argmin": 1, "count_nonzero": 1,
    "nansum": 2, "nanmean": 2, "norm": 2, "std": 4, "var": 3,
    "logsumexp": 12, "cumsum": 1, "cumprod": 1, "cummax": 1,
    "logcumsumexp": 12, "trace": 1, "median": 8, "kthvalue": 8,
    "mode": 8, "sort": 16, "argsort": 16, "topk": 8, "dist": 3,
    "allclose": 4, "histogram": 2, "bincount": 1, "diff": 1,
    "searchsorted": 8, "pool": None,  # pool priced by its window below
}

# pure data movement / indexing: modeled, zero FLOPs
_MOVEMENT = frozenset({
    "reshape", "flatten", "squeeze", "unsqueeze", "transpose", "t",
    "swapaxes", "moveaxis", "slice", "strided_slice", "split", "unbind",
    "concat", "stack", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "gather", "gather_nd", "index_select",
    "index_sample", "take_along_axis", "put_along_axis", "scatter",
    "scatter_nd_add", "embedding", "pad", "flip", "roll", "rot90",
    "clone", "crop_tensor", "diag", "diag_embed", "diagflat", "tril",
    "triu", "repeat_interleave", "shard_index", "sequence_mask",
    "multiplex", "set_value", "assign", "identity", "numel", "shape",
})

# normalizations: flops = factor * input elements (stats + affine)
_NORMALIZE: Dict[str, int] = {
    "batch_norm": 8, "layer_norm": 8, "instance_norm": 8,
    "group_norm": 8, "local_response_norm": 10, "normalize": 6,
    "spectral_norm": 10, "softmax": 5, "log_softmax": 6,
    "sequence_softmax": 5,
}

# losses: factor * first-input elements
_LOSS: Dict[str, int] = {
    "mse_loss": 4, "l1_loss": 3, "smooth_l1_loss": 5,
    "square_error_cost": 3, "cross_entropy": 8,
    "linear_cross_entropy": 8, "binary_cross_entropy": 12,
    "bce_with_logits": 14, "nll_loss": 3, "kl_div": 12, "log_loss": 12,
    "hinge_embedding_loss": 4, "margin_ranking_loss": 4,
    "cosine_embedding_loss": 8, "ctc_loss": 32, "dice_loss": 6,
    "npair_loss": 8, "sigmoid_focal_loss": 16, "hsigmoid_loss": 10,
}



def _contracted_dim(in_avals, kw) -> int:
    """K of a matmul from the lhs aval, honoring transpose kwargs."""
    a = in_avals[0]
    if not a.shape:
        return 1
    tx = bool(kw.get("transpose_x", kw.get("transpose_a", False)))
    return int(a.shape[-2] if (tx and len(a.shape) >= 2) else a.shape[-1])


class OpCost:
    """One op's modeled cost (or its explicit unmodeled admission)."""

    __slots__ = ("op_index", "op_name", "rule", "flops", "in_bytes",
                 "out_bytes", "param_bytes", "modeled", "loc")

    def __init__(self, op_index, op_name, rule, flops, in_bytes,
                 out_bytes, param_bytes, modeled, loc=None):
        self.op_index = op_index
        self.op_name = op_name
        self.rule = rule
        self.flops = int(flops)
        self.in_bytes = int(in_bytes)
        self.out_bytes = int(out_bytes)
        self.param_bytes = int(param_bytes)
        self.modeled = modeled
        self.loc = loc

    @property
    def total_bytes(self) -> int:
        return self.in_bytes + self.out_bytes + self.param_bytes

    def to_dict(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}

    def __repr__(self):
        return (f"OpCost(#{self.op_index} {self.op_name}: "
                f"flops={self.flops}, bytes={self.total_bytes}, "
                f"modeled={self.modeled})")


def _op_flops(node, in_avals, param_avals, out_avals
              ) -> Tuple[Optional[int], str]:
    """(flops, rule name) or (None, 'unmodeled')."""
    name = node.op_name
    out_n = sum(_numel(a) for a in out_avals)
    in_n = _numel(in_avals[0]) if in_avals else 0

    if name in ("linear", "addmm"):
        k = _contracted_dim(in_avals or param_avals, node.attrs)
        bias = out_n if (len(param_avals) > 1 or name == "addmm") else 0
        return 2 * out_n * k + bias, "matmul"
    if name in ("matmul", "matmul_transpose", "mm", "bmm", "mv",
                "inner", "outer", "dot"):
        k = (_contracted_dim(in_avals, node.attrs) if in_avals else 1)
        if name == "outer":
            k = 1
        return 2 * out_n * k, "matmul"
    if name in ("conv2d", "conv3d", "conv1d", "sequence_conv"):
        # weight [Co, Ci/g, *k]: each output element costs one dot of
        # length Ci/g * prod(kernel)
        if param_avals:
            w = param_avals[0]
            dot = _numel(w) // max(int(w.shape[0]), 1)
            bias = out_n if len(param_avals) > 1 else 0
            return 2 * out_n * dot + bias, "conv"
        return None, "unmodeled"
    if name in ("conv2d_transpose", "conv3d_transpose"):
        # every input element scatters one weight-sized stencil
        if param_avals:
            w = param_avals[0]
            dot = _numel(w) // max(int(w.shape[0]), 1)
            bias = out_n if len(param_avals) > 1 else 0
            return 2 * in_n * dot + bias, "conv"
        return None, "unmodeled"
    if name == "pool":
        # the JAX op carries its window, the port's op its kernel
        win = node.attrs.get("window", node.attrs.get("kernel", ()))
        wn = 1
        for s in win:
            wn *= int(s)
        return out_n * max(wn, 1), "reduce"
    if name in ("adaptive_avg_pool1d", "adaptive_avg_pool2d",
                "adaptive_avg_pool3d", "adaptive_max_pool1d",
                "adaptive_max_pool2d", "adaptive_max_pool3d",
                "interpolate", "pixel_shuffle", "unfold", "grid_sample",
                "affine_grid", "temporal_shift"):
        return 2 * max(in_n, out_n), "sample"
    if name in ("scaled_dot_product_attention", "flash_attention"):
        # q,k,v avals: 2 * numel(q) * Lk for QK^T plus the same for PV,
        # plus a softmax over the score matrix (approximate)
        if len(in_avals) >= 2 and len(in_avals[1].shape) >= 2:
            q, kv = in_avals[0], in_avals[1]
            lk = int(kv.shape[-2]) if len(kv.shape) >= 2 else 1
            scores = _numel(q) // max(int(q.shape[-1]), 1) * lk
            return 4 * _numel(q) * lk + 5 * scores, "attention"
        return None, "unmodeled"
    if name == "paged_attention":
        # decode attention over a paged KV pool: q [S, H, D], pool
        # [(L,) N, page, Hkv, D], page_table [S, P]; context T = P * page
        # (_node_costs counts the gathered pages' bytes, not the pool's)
        if len(in_avals) >= 4 and len(in_avals[0].shape) == 3 \
                and len(in_avals[3].shape) == 2:
            q, kp, pt = in_avals[0], in_avals[1], in_avals[3]
            page = int(kp.shape[-3])
            T = int(pt.shape[1]) * page
            scores = _numel(q) // max(int(q.shape[-1]), 1) * T
            return 4 * _numel(q) * T + 5 * scores, "attention"
        return None, "unmodeled"
    if name in _NORMALIZE:
        return _NORMALIZE[name] * max(in_n, out_n), "normalize"
    if name in _LOSS:
        return _LOSS[name] * in_n, "loss"
    if name in _ELEMENTWISE:
        return _ELEMENTWISE[name] * out_n, "elementwise"
    if name in _REDUCE:
        return (_REDUCE[name] or 1) * in_n, "reduce"
    if name in _MOVEMENT:
        return 0, "movement"
    return None, "unmodeled"


def _node_costs(graph: DefUseGraph,
                avals: Optional[Dict[int, object]] = None) -> List[OpCost]:
    avals = avals or {}
    out: List[OpCost] = []
    for i, node in enumerate(graph.nodes):
        in_avals, param_avals = [], []
        in_bytes = param_bytes = 0
        for tag, x in node.in_specs:
            if tag == "v":
                a = avals.get(id(x), x.meta)
                in_avals.append(a)
                in_bytes += aval_bytes(a)
            elif tag == "p":
                x = param_aval(x)
                param_avals.append(x)
                param_bytes += aval_bytes(x)
            elif tag == "c" or isinstance(x, np.ndarray):
                in_avals.append(x)
                in_bytes += aval_bytes(x)
        out_avals = [avals.get(id(v), v.meta) for v in node.out_vars]
        out_bytes = sum(aval_bytes(a) for a in out_avals)
        flops, rule = _op_flops(node, in_avals, param_avals, out_avals)
        if node.op_name == "paged_attention" and len(in_avals) >= 5 \
                and len(in_avals[3].shape) == 2:
            # the K and V rows the page table names, not the whole pool
            q, kp, pt = in_avals[0], in_avals[1], in_avals[3]
            page, hkv, d = (int(s) for s in kp.shape[-3:])
            S, P = (int(s) for s in pt.shape)
            gather = 2 * S * P * page * hkv * d * kp.element_size()
            in_bytes = (aval_bytes(q) + gather + aval_bytes(pt)
                        + aval_bytes(in_avals[4]))
        out.append(OpCost(i, node.op_name, rule,
                          flops if flops is not None else 0,
                          in_bytes, out_bytes, param_bytes,
                          modeled=flops is not None, loc=graph.loc_of(i)))
    return out


_OPT_FLOPS_PER_ELEM = {
    "SGD": 2, "Momentum": 4, "Adagrad": 8, "RMSProp": 10,
    "Adadelta": 10, "Adam": 18, "AdamW": 20, "Lamb": 24,
}


def _optimizer_flops(program: Program, trainable_bytes: int,
                     elem_size: int = 4) -> int:
    pack = program._optimizer
    if pack is None:
        return 0
    per = _OPT_FLOPS_PER_ELEM.get(type(pack[0]).__name__, 10)
    return per * (trainable_bytes // max(elem_size, 1))



# ---------------------------------------------------------------------------
# shape re-derivation
# ---------------------------------------------------------------------------

def _propagate_avals(graph: DefUseGraph,
                     feed_shapes: Dict[str, Sequence[int]]
                     ) -> Dict[int, torch.Tensor]:
    """``id(Variable) -> meta tensor`` for every feed and op output,
    re-derived in topological order under the given feed shapes.  An op
    that fails to replay raises: the program could not run at these
    shapes either (the JAX package keeps the recorded shape there)."""
    avals: Dict[int, torch.Tensor] = {}
    for name, v in graph.feeds.items():
        shape = feed_shapes.get(name)
        avals[id(v)] = (v.meta if shape is None else torch.empty(
            tuple(int(s) for s in shape), dtype=v.meta.dtype,
            device="meta"))
    for node in graph.nodes:
        args = [avals.get(id(x), x.meta) if tag == "v" else to_meta(x)
                for tag, x in node.in_specs]
        out = infer_outputs(node, args,
                            lambda v: avals.get(id(v), v.meta))
        for v, a in zip(node.out_vars, out if node.multi else [out]):
            avals[id(v)] = a
    return avals


def _shapes_from_batch(graph: DefUseGraph, batch_size: int
                       ) -> Dict[str, Sequence[int]]:
    out = {}
    for name, v in graph.feeds.items():
        desc = v.desc_shape
        if desc and any(s == -1 for s in desc):
            out[name] = tuple(int(batch_size) if s == -1 else int(s)
                              for s in desc)
    return out


# ---------------------------------------------------------------------------
# fusion candidates
# ---------------------------------------------------------------------------

# an op that can ride a fused kernel's epilogue
_FUSABLE = (frozenset(_ELEMENTWISE) | frozenset(_REDUCE)
            | frozenset(_NORMALIZE) | frozenset(_LOSS) | _MOVEMENT)


def _fusion_candidates(graph: DefUseGraph, avals: Dict[int, torch.Tensor],
                       fetched: set, costs: Optional[List[OpCost]] = None,
                       top_k: Optional[int] = None) -> List[dict]:
    """Maximal single-consumer chains (no fetched intermediate), ranked
    by the bytes a fused kernel saves, most first (ties in op order).
    With ``costs`` each candidate also carries its FLOPs and its traffic
    fused and unfused."""
    nodes = graph.nodes

    def bytes_of(v):
        return aval_bytes(avals.get(id(v), v.meta))

    in_chain: set = set()
    cands: List[dict] = []
    for i in range(len(nodes)):
        if i in in_chain:
            continue
        chain, j = [i], i
        while True:
            outs = nodes[j].out_vars
            if len(outs) != 1 or id(outs[0]) in fetched:
                break
            cons = graph.consumers_of.get(id(outs[0]), [])
            if len(cons) != 1:
                break
            k = cons[0]
            if k <= j or k in in_chain or nodes[k].op_name not in _FUSABLE:
                break
            chain.append(k)
            j = k
        if len(chain) < 2:
            continue
        in_chain.update(chain)
        saved = sum(2 * bytes_of(nodes[j].out_vars[0]) for j in chain[:-1])
        cand = {"ops": chain, "op_names": [nodes[j].op_name for j in chain],
                "saved_bytes": saved}
        if costs is not None:
            unfused = sum(costs[j].total_bytes for j in chain)
            cand.update({"flops": sum(costs[j].flops for j in chain),
                         "unfused_traffic_bytes": unfused,
                         "fused_traffic_bytes": unfused - saved,
                         "loc": graph.loc_of(chain[0])})
        cands.append(cand)
    cands.sort(key=lambda c: -c["saved_bytes"])
    return cands if top_k is None else cands[:top_k]


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _fmt_flops(n: float) -> str:
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000 or unit == "T":
            return f"{n:.2f}{unit}F" if unit else f"{int(n)}F"
        n /= 1000.0
    return f"{n:.2f}TF"


class ProgramReport:
    """Everything :func:`analyze` learned about one Program."""

    __slots__ = ("program_serial", "n_ops", "fetch_names", "per_op",
                 "totals", "memory", "memory_per_shard", "roofline",
                 "fusion_candidates", "hazards", "batch_hint")

    def to_dict(self) -> dict:
        return {
            "program": self.program_serial,
            "ops": self.n_ops,
            "fetch": list(self.fetch_names),
            "batch_hint": self.batch_hint,
            "per_op": [c.to_dict() for c in self.per_op],
            "totals": self.totals,
            "memory": self.memory.to_dict(),
            "memory_per_shard": (
                None if getattr(self, "memory_per_shard", None) is None
                else self.memory_per_shard.to_dict()),
            "roofline": self.roofline,
            "fusion_candidates": self.fusion_candidates,
            "hazards": [d.to_dict() for d in self.hazards],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def render(self, max_rows: Optional[int] = 40) -> str:
        t, m = self.totals, self.memory
        lines = [f"Program #{self.program_serial}: {self.n_ops} ops, "
                 f"fetch={list(self.fetch_names)}"]
        lines.append(
            f"  flops: fwd {_fmt_flops(t['flops_fwd'])}"
            + (f", train {_fmt_flops(t['flops_train'])}"
               if t["flops_train"] is not None else "")
            + f" | min device-memory traffic "
            f"{_fmt_bytes(t['min_traffic_bytes'])}"
            f" | arithmetic intensity {t['arithmetic_intensity']:.1f}")
        un = t["unmodeled"]
        lines.append(
            f"  unmodeled: {un['count']} op(s), {_fmt_bytes(un['bytes'])}"
            + (f" ({', '.join(sorted(set(un['ops'])))})" if un["ops"]
               else ""))
        act = (m.retained_activation_bytes if m.training
               else m.activation_peak_bytes)
        lines.append(
            f"  memory: peak {_fmt_bytes(m.peak_bytes_donated)} donated / "
            f"{_fmt_bytes(m.peak_bytes_no_donation)} no-donation "
            f"(params {_fmt_bytes(m.param_bytes)}, slots "
            f"{_fmt_bytes(m.slot_bytes)}, grads {_fmt_bytes(m.grad_bytes)}, "
            f"activations {_fmt_bytes(act)})")
        ms = getattr(self, "memory_per_shard", None)
        if ms is not None:
            lines.append(
                f"  per-shard ({self.totals.get('mesh_devices', '?')} "
                f"devices): peak {_fmt_bytes(ms.peak_bytes_donated)} "
                f"donated / {_fmt_bytes(ms.peak_bytes_no_donation)} "
                f"no-donation (params {_fmt_bytes(ms.param_bytes)}, "
                f"slots {_fmt_bytes(ms.slot_bytes)}, grads "
                f"{_fmt_bytes(ms.grad_bytes)})")
        comm = self.totals.get("comm")
        if comm is not None:
            ratio = (comm["wire_bytes_per_step"]
                     / max(comm["fp32_wire_bytes_per_step"], 1))
            lines.append(
                f"  comm (dp={comm['dp']}, "
                f"{'grad_comm ' + str(comm['dtype']) if comm['enabled'] else 'fp32 all-reduce'}): "
                f"{_fmt_bytes(comm['wire_bytes_per_step'])}/step wire "
                f"({ratio:.3f}x fp32), "
                f"{len(comm['collectives'])} collective group(s), "
                f"overlap {comm.get('overlap', 'none')}"
                f"->{comm.get('overlap_path', 'none')}")
        if self.roofline:
            lines.append("  roofline (predicted):")
            for name, r in self.roofline.items():
                lines.append(
                    f"    {name:>4}: step {r['predicted_step_s'] * 1e3:.3f} "
                    f"ms, MFU {r['predicted_mfu']:.3f}, {r['bound']}-bound")
        if self.fusion_candidates:
            n_real = sum(1 for c in self.fusion_candidates
                         if c.get("realized"))
            lines.append(
                f"  fusion candidates (by device-memory traffic saved; "
                f"{n_real}/{len(self.fusion_candidates)} realized by the "
                f"kernel tier):")
            for c in self.fusion_candidates:
                loc = f" @ {c['loc']}" if c.get("loc") else ""
                real = (f" [realized: {c['realized']}]"
                        if c.get("realized") else "")
                lines.append(
                    f"    {'+'.join(c['op_names'])} (ops {c['ops']}): "
                    f"saves {_fmt_bytes(c['saved_bytes'])}{loc}{real}")
        if self.hazards:
            lines.append("  hazards:")
            lines.extend(f"    {d}" for d in self.hazards)
        rows = self.per_op if max_rows is None else self.per_op[:max_rows]
        lines.append("  per-op:")
        lines.append("    idx  op                    flops        bytes"
                     "      rule")
        for c in rows:
            star = " " if c.modeled else "*"
            lines.append(
                f"    {c.op_index:>3}{star} {c.op_name:<20} "
                f"{_fmt_flops(c.flops):>10} {_fmt_bytes(c.total_bytes):>10}"
                f"  {c.rule}" + (f"  @ {c.loc}" if c.loc else ""))
        if max_rows is not None and len(self.per_op) > max_rows:
            lines.append(f"    ... {len(self.per_op) - max_rows} more "
                         f"(render(max_rows=None))")
        return "\n".join(lines)

    def __str__(self):
        return self.render()

    def __repr__(self):
        t = self.totals
        return (f"ProgramReport(#{self.program_serial}, {self.n_ops} ops, "
                f"fwd={_fmt_flops(t['flops_fwd'])}, "
                f"peak={_fmt_bytes(self.memory.peak_bytes_donated)})")


# ---------------------------------------------------------------------------
# gradient-collective prediction (grad_comm wire bytes)
# ---------------------------------------------------------------------------

def _comm_block(program: Program, plan,
                graph: Optional[DefUseGraph] = None) -> Optional[dict]:
    """Predicted per-step gradient communication of a training program
    under a sharding plan.  With an active ``grad_comm`` spec the
    numbers come from the same ``plan_reduction`` the Executor runs, so
    this prediction and the runtime ``comm.wire_bytes`` stat agree
    exactly; without one, the block models a plain fp32 all-reduce of
    every gradient after backward."""
    if program._optimizer is None or plan is None:
        return None
    from ...distributed import grad_comm as _gc
    from ...distributed.mesh import DP_AXIS
    from .liveness import _opt_unpack
    dp = dict(plan.mesh.shape).get(DP_AXIS, 1)
    _opt, trainable = _opt_unpack(program)
    shapes = [tuple(param_aval(p).shape) for p in trainable]
    grad_bytes = sum(4 * int(np.prod(s)) if s else 4 for s in shapes)
    ring = (2.0 * (dp - 1) / dp) if dp > 1 else 0.0
    fp32_wire = int(round(ring * grad_bytes))
    status, err = _gc.plan_status(plan)
    if status != "active":
        return {
            "enabled": False, "dp": dp, "dtype": "fp32",
            **({"error": err} if err else {}),
            "overlap": "none", "overlap_path": "none",
            "wire_bytes_per_step": fp32_wire,
            "fp32_wire_bytes_per_step": fp32_wire,
            "gathers": [], "gather_wire_bytes_per_step": 0,
            "axis_wire_bytes": ({DP_AXIS: fp32_wire} if dp > 1 else {}),
            "collectives": ([] if dp <= 1 else [{
                "params": list(range(len(shapes))),
                "numel": grad_bytes // 4, "algorithm": "gspmd_psum",
                "wire_dtype": "fp32", "wire_bytes": fp32_wire,
                "collectives": 1, "classification": "bandwidth",
                "error_feedback": False, "issue_frac": 1.0}]),
        }
    cfg = plan.grad_comm
    pack = program._optimizer
    order = _gc.production_order(program, trainable,
                                 pack[1] if pack is not None else None,
                                 graph=graph)
    named = [(p.name, s) for p, s in zip(trainable, shapes)]
    _kinds, fsdp, gathers = _gc.hybrid_layout(plan, named, order=order)
    gplan = _gc.plan_reduction(shapes, dp=dp, cfg=cfg, order=order,
                               fsdp=fsdp, gathers=gathers)
    return {
        "enabled": True, "dp": dp, "dtype": cfg.dtype,
        "block_size": cfg.block_size,
        "error_feedback": cfg.error_feedback,
        "overlap": cfg.overlap,
        "overlap_path": gplan.overlap_path,
        "wire_bytes_per_step": gplan.wire_bytes_per_step,
        "fp32_wire_bytes_per_step": gplan.fp32_wire_bytes_per_step,
        "collectives_per_step": gplan.collectives_per_step,
        "collectives": [b.to_dict() for b in gplan.buckets],
        "gathers": list(gplan.gathers),
        "gather_wire_bytes_per_step": gplan.gather_wire_bytes_per_step,
        "axis_wire_bytes": dict(gplan.axis_wire_bytes),
    }


def _comm_seconds(comm: dict, backward_s: float, ici_bw: float
                  ) -> Tuple[float, float]:
    """(total comm seconds, predicted exposed comm seconds) of one comm
    block over ``ici_bw`` bytes/s.  Bucket i is ready at ``backward_s *
    issue_frac_i`` and takes the link after the buckets before it; what
    the link still moves when backward ends is exposed.  On the
    ``'none'`` path everything is exposed."""
    if ici_bw <= 0:
        return 0.0, 0.0
    gather_s = comm.get("gather_wire_bytes_per_step", 0) / ici_bw
    total = comm["wire_bytes_per_step"] / ici_bw + gather_s
    if not comm.get("enabled") or comm.get("overlap_path") == "none":
        return total, total
    link_end = 0.0
    for b in comm.get("collectives", ()):
        ready = backward_s * float(b.get("issue_frac", 1.0))
        link_end = max(link_end, ready) + b["wire_bytes"] / ici_bw
    return total, max(0.0, link_end - backward_s)


def analyze(program: Program, fetch_list: Optional[Sequence] = None,
            feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
            batch_size: Optional[int] = None,
            chip: Optional[str] = None, top_k: Optional[int] = 5,
            include_hazards: bool = True, sharding=None) -> ProgramReport:
    """The cost model's report on one recorded Program.

    ``fetch_list`` (Variables or names) roots the liveness; an attached
    optimizer's loss is a root too.  ``batch_size`` stands in for every
    dynamic feed dim and re-derives every shape; ``feed_shapes`` sets
    feeds exactly.  ``chip`` picks one :data:`CHIP_SPECS` row (default:
    all); an unknown name raises KeyError.  ``top_k`` bounds the ranked
    fusion candidates (0: none, None: all).  ``sharding`` (a
    :class:`~...distributed.sharding.ShardingPlan`) adds
    ``memory_per_shard`` and the ``comm`` totals."""
    graph = DefUseGraph(program)
    shapes = dict(feed_shapes or {})
    if batch_size is not None:
        derived = _shapes_from_batch(graph, batch_size)
        derived.update(shapes)
        shapes = derived
    avals = _propagate_avals(graph, shapes) if shapes else {}

    fetch_vars: List[Variable] = []
    fetch_names: List[str] = []
    for f in fetch_list or []:
        v = graph.resolve_fetch(f)
        if v is not None:
            fetch_vars.append(v)
            fetch_names.append(v.name)
    opt_pack = program._optimizer
    if opt_pack is not None and isinstance(opt_pack[1], Variable) \
            and not any(v is opt_pack[1] for v in fetch_vars):
        fetch_vars.append(opt_pack[1])

    costs = _node_costs(graph, avals)
    memory = estimate_memory(graph, fetch_vars, avals)
    memory_per_shard = None
    if sharding is not None:
        # params (with grads and slots) divide by their spec's axis
        # sizes, activations and feeds by the batch axes, when the plan
        # shards every feed (a replicated feed is whole on every rank)
        from ...distributed.sharding import spec_axes
        spec_of = dict(zip(sharding.param_names, sharding.param_specs))
        div: Dict[int, int] = {}
        for pos, p in enumerate(program.parameters()):
            spec = spec_of.get(p.name)
            if spec is None and pos < len(sharding.param_specs):
                spec = sharding.param_specs[pos]
            div[id(p)] = sharding.divisor(spec) if spec is not None else 1

        def _feed_shape(v):
            return tuple(avals.get(id(v), v.meta).shape)

        feeds_sharded = all(
            len(spec_axes(sharding.feed_spec(_feed_shape(v)))) > 0
            for v in graph.feeds.values()) if graph.feeds else True
        memory_per_shard = estimate_memory(
            graph, fetch_vars, avals, param_div=div,
            act_div=sharding.batch_divisor() if feeds_sharded else 1)
    flops_fwd = sum(c.flops for c in costs)
    unmodeled = [c for c in costs if not c.modeled]
    training = opt_pack is not None
    opt_flops = _optimizer_flops(program, memory.trainable_param_bytes)
    flops_train = (3 * flops_fwd + opt_flops) if training else None

    feed_bytes = memory.feed_bytes
    fetch_bytes = sum(aval_bytes(avals.get(id(v), v.meta))
                      for v in fetch_vars)
    unfused_traffic = sum(c.total_bytes for c in costs)
    if training:
        # the forward reads parameters and feeds, the backward writes
        # gradients, the update reads gradients, parameters and slots and
        # writes parameters and slots; kept activations are written once
        # and read back once
        min_traffic = (feed_bytes + fetch_bytes
                       + 3 * memory.trainable_param_bytes
                       + (memory.param_bytes - memory.trainable_param_bytes)
                       + 2 * memory.slot_bytes
                       + 2 * memory.retained_activation_bytes)
        roof_flops = flops_train
    else:
        min_traffic = feed_bytes + fetch_bytes + memory.param_bytes
        roof_flops = flops_fwd
    intensity = roof_flops / max(min_traffic, 1)

    comm = _comm_block(program, sharding, graph=graph) \
        if sharding is not None else None

    if chip is not None:
        if chip not in CHIP_SPECS:
            raise KeyError(
                f"unknown chip {chip!r}; known: {sorted(CHIP_SPECS)}")
        specs = {chip: CHIP_SPECS[chip]}
    else:
        specs = CHIP_SPECS
    roofline = {}
    for name, spec in specs.items():
        t_comp = roof_flops / spec.peak_flops
        t_mem = min_traffic / spec.hbm_bw
        step = max(t_comp, t_mem)
        entry = {
            "peak_flops": spec.peak_flops,
            "hbm_bw": spec.hbm_bw,
            "predicted_step_s": step,
            "predicted_mfu": (t_comp / step) if step > 0 else 0.0,
            "bound": "compute" if t_comp >= t_mem else "memory",
            "fits_hbm": memory.peak_bytes_donated <= spec.hbm_bytes,
        }
        if comm is not None and training and comm.get("dp", 1) > 1:
            # only the exposed share of the gradient collectives adds to
            # the step; backward's window is its FLOP share (2x the
            # forward of the 3x-forward training total)
            backward_s = step * (2.0 * flops_fwd / max(roof_flops, 1))
            comm_s, exposed_s = _comm_seconds(comm, backward_s,
                                              spec.ici_bw)
            entry["predicted_comm_s"] = comm_s
            entry["predicted_exposed_comm_s"] = exposed_s
            entry["predicted_hidden_comm_s"] = comm_s - exposed_s
            entry["predicted_step_s"] = step + exposed_s
            if entry["predicted_step_s"] > 0:
                entry["predicted_mfu"] = t_comp / entry["predicted_step_s"]
        roofline[name] = entry

    fetched_ids = {id(v) for v in fetch_vars}
    cands = _fusion_candidates(graph, avals, fetched_ids, costs, top_k)
    if cands:
        from .fusion import annotate_candidates
        annotate_candidates(program, cands, graph, avals,
                            plan_active=sharding is not None)

    hazards: List[Diagnostic] = []
    if include_hazards:
        from .hazards import hazard_passes
        for p in hazard_passes():
            hazards.extend(p.run(graph, fetch_list))

    rep = ProgramReport()
    rep.program_serial = program._serial
    rep.n_ops = len(graph.nodes)
    rep.fetch_names = fetch_names
    rep.batch_hint = batch_size
    rep.per_op = costs
    rep.memory_per_shard = memory_per_shard
    rep.totals = {
        **({"mesh_devices": sharding.n_devices}
           if sharding is not None else {}),
        **({"comm": comm} if comm is not None else {}),
        "flops_fwd": flops_fwd,
        "flops_train": flops_train,
        "optimizer_flops": opt_flops if training else 0,
        "feed_bytes": feed_bytes,
        "fetch_bytes": fetch_bytes,
        "param_bytes": memory.param_bytes,
        "unfused_traffic_bytes": unfused_traffic,
        "min_traffic_bytes": min_traffic,
        "arithmetic_intensity": intensity,
        "unmodeled": {
            "count": len(unmodeled),
            "ops": [c.op_name for c in unmodeled],
            "bytes": sum(c.total_bytes for c in unmodeled),
            "flops_unknown": bool(unmodeled),
        },
    }
    rep.memory = memory
    rep.roofline = roofline
    rep.fusion_candidates = cands
    rep.hazards = hazards
    return rep


def resolve_perf_chip(place=None) -> str:
    """The :data:`CHIP_SPECS` row a prediction is priced against:
    ``FLAGS_perf_chip`` when it names a row, else ``h100`` for an H100
    (``place``, default the current CUDA device when there is one) and
    ``cpu`` otherwise.  A flag naming no row, or another card, warns and
    takes the automatic choice, or ``cpu``."""
    from ...core.flags import get_flag
    chip = get_flag("perf_chip")
    if chip:
        if chip in CHIP_SPECS:
            return chip
        warnings.warn(
            f"FLAGS_perf_chip={chip!r} is not a known chip spec (choose "
            f"from {sorted(CHIP_SPECS)}); taking the device's own",
            RuntimeWarning)
    dev = torch.device(place) if place is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda" and "H100" in torch.cuda.get_device_name(dev):
        return "h100"
    warnings.warn(
        f"no roofline chip spec for device {dev}; pricing predictions "
        f"against 'cpu' (set FLAGS_perf_chip to a CHIP_SPECS key)",
        RuntimeWarning)
    return "cpu"


def compile_summary(program: Program, donate: bool = True,
                    feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                    place=None, sharding=None) -> Optional[dict]:
    """The slice of :func:`analyze` the Executor keeps on each built
    step: FLOPs a step (forward and train), peak bytes, the least
    traffic, the chip row and its predicted step time, and the unmodeled
    ops.  Priced at ``feed_shapes`` (the run's; paddle_tpu prices the
    recorded placeholder of 1 for a dynamic dim).  Returns None instead
    of raising: a cost-model gap must never break a build.  With a
    ``sharding`` plan it also carries ``peak_bytes_per_shard`` and the
    comm prediction (``predicted_wire_bytes``, per axis, the overlap
    path and the comm seconds the perf observatory splits)."""
    try:
        # inside the try: a misconfigured flag warns, and under
        # warnings-as-errors that warning raises
        chip = resolve_perf_chip(place)
        rep = analyze(program, feed_shapes=feed_shapes,
                      include_hazards=False, chip=chip, top_k=0,
                      sharding=sharding)
    except Exception:  # noqa: BLE001 - prediction is best-effort
        return None
    t = rep.totals
    out = {
        "flops": (t["flops_train"] if t["flops_train"] is not None
                  else t["flops_fwd"]),
        "flops_fwd": t["flops_fwd"],
        "peak_bytes": (rep.memory.peak_bytes_donated if donate
                       else rep.memory.peak_bytes_no_donation),
        "min_traffic_bytes": t["min_traffic_bytes"],
        "chip": chip,
        "predicted_step_s": rep.roofline[chip]["predicted_step_s"],
        "unmodeled_ops": t["unmodeled"]["count"],
        "unmodeled_bytes": t["unmodeled"]["bytes"],
    }
    if rep.memory_per_shard is not None:
        ms = rep.memory_per_shard
        out["peak_bytes_per_shard"] = (ms.peak_bytes_donated if donate
                                       else ms.peak_bytes_no_donation)
        out["mesh_devices"] = t.get("mesh_devices")
    comm = t.get("comm")
    if comm is not None:
        out["predicted_wire_bytes"] = comm["wire_bytes_per_step"]
        out["comm_enabled"] = comm["enabled"]
        if comm.get("axis_wire_bytes"):
            out["predicted_axis_wire_bytes"] = dict(comm["axis_wire_bytes"])
        if comm.get("gather_wire_bytes_per_step"):
            out["predicted_gather_wire_bytes"] = \
                comm["gather_wire_bytes_per_step"]
        out["comm_overlap"] = comm.get("overlap_path", "none")
        r = rep.roofline[chip]
        for k in ("predicted_comm_s", "predicted_exposed_comm_s",
                  "predicted_hidden_comm_s"):
            if k in r:
                out[k] = r[k]
    return out
