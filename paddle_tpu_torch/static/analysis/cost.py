"""The cost model's shape re-derivation and fusion candidates (the port's
copy of ``_propagate_avals``, ``_FUSABLE`` and ``_fusion_candidates`` of
``paddle_tpu/static/analysis/cost.py``).  The roofline report is not
ported yet.

Shapes are re-derived by replaying every op on ``meta`` tensors under
the run's feed shapes (a dynamic dim records as 1).  A candidate is a
maximal chain of single-consumer ops, ranked by the bytes a fused kernel
saves: each intermediate written by one op and read back by the next
(twice its size) stays on chip when the chain runs as one kernel."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..program import to_meta
from .graph import DefUseGraph

__all__ = ["_propagate_avals", "_fusion_candidates", "_FUSABLE"]

# op names that can ride a fused kernel's epilogue: paddle_tpu's
# elementwise, reduction, normalisation, loss and movement tables
_FUSABLE = frozenset({
    # elementwise
    "add", "subtract", "multiply", "divide", "pow", "scale", "clip", "abs",
    "negative", "sign", "maximum", "minimum", "floor", "ceil", "round",
    "square", "reciprocal", "remainder", "floor_divide", "equal",
    "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_not", "where", "isnan", "isinf", "isfinite",
    "isclose", "add_n", "relu", "relu6", "leaky_relu", "prelu", "hardtanh",
    "hardshrink", "softshrink", "thresholded_relu", "hardsigmoid",
    "maxout", "masked_fill", "increment", "exp", "log", "log2", "log10",
    "log1p", "expm1", "sqrt", "rsqrt", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "sigmoid",
    "log_sigmoid", "softplus", "silu", "swish", "gelu", "elu", "selu",
    "celu", "stanh", "mish", "erf", "erfinv", "dropout", "alpha_dropout",
    "label_smooth", "lerp", "logaddexp", "nan_to_num", "one_hot",
    "gumbel_softmax", "deg2rad", "rad2deg", "cast",
    # reductions
    "sum", "mean", "max", "min", "prod", "all", "any", "argmax", "argmin",
    "count_nonzero", "nansum", "nanmean", "norm", "std", "var",
    "logsumexp", "cumsum", "cumprod", "cummax", "logcumsumexp", "trace",
    "median", "kthvalue", "mode", "sort", "argsort", "topk", "dist",
    "allclose", "histogram", "bincount", "diff", "searchsorted", "pool",
    # normalisations
    "batch_norm", "layer_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize", "spectral_norm", "softmax",
    "log_softmax", "sequence_softmax",
    # losses
    "mse_loss", "l1_loss", "smooth_l1_loss", "square_error_cost",
    "cross_entropy", "linear_cross_entropy", "binary_cross_entropy",
    "bce_with_logits", "nll_loss", "kl_div", "log_loss",
    "hinge_embedding_loss", "margin_ranking_loss",
    "cosine_embedding_loss", "ctc_loss", "dice_loss", "npair_loss",
    "sigmoid_focal_loss", "hsigmoid_loss",
    # data movement
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


def _propagate_avals(graph: DefUseGraph,
                     feed_shapes: Dict[str, Sequence[int]]
                     ) -> Dict[int, torch.Tensor]:
    """``id(Variable) -> meta tensor`` for every feed and op output,
    re-derived in topological order under the given feed shapes.  An op
    that fails to replay raises: the program could not run at these
    shapes either."""
    avals: Dict[int, torch.Tensor] = {}
    for name, v in graph.feeds.items():
        shape = feed_shapes.get(name)
        avals[id(v)] = (v.meta if shape is None else torch.empty(
            tuple(int(s) for s in shape), dtype=v.meta.dtype,
            device="meta"))
    with torch.no_grad():
        for node in graph.nodes:
            args = [avals.get(id(x), x.meta) if tag == "v" else to_meta(x)
                    for tag, x in node.in_specs]
            out = node.fn(*args, **node.attrs)
            for v, a in zip(node.out_vars, out if node.multi else [out]):
                avals[id(v)] = a
    return avals


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fusion_candidates(graph: DefUseGraph, avals: Dict[int, torch.Tensor],
                       fetched: set) -> List[dict]:
    """Maximal single-consumer chains (no fetched intermediate), ranked
    by the bytes a fused kernel saves, most first (ties in op order)."""
    nodes = graph.nodes
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
        saved = sum(2 * _bytes(avals.get(id(nodes[j].out_vars[0]),
                                         nodes[j].out_vars[0].meta))
                    for j in chain[:-1])
        cands.append({"ops": chain,
                      "op_names": [nodes[j].op_name for j in chain],
                      "saved_bytes": saved})
    cands.sort(key=lambda c: -c["saved_bytes"])
    return cands
