"""``save_inference_model`` / ``load_inference_model`` for static
programs (the counterpart of ``paddle_tpu/static/io.py``; reference:
python/paddle/static/io.py save_inference_model:231,
load_inference_model:434).

The Program is pruned to the backward slice of the fetch variables
(training-only nodes, the loss and its labels, drop out), the
Executor's epilogue-fusion pass rewrites the slice as it would for a
run (``FLAGS_use_pallas_kernels``; a dynamic dim is planned at size 1,
so a chain is fused only if it takes every batch), and the Executor's
replay of the slice, with the parameters it reads as inputs, is
exported in ``jit.save``'s format (``paddle_tpu_torch.export.v1``):
one deployable file family for both sources, which ``inference.
create_predictor`` serves.  The fused chains are the
``paddle_tpu_torch::fused_linear_epilogue_fwd`` nodes of the graph.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.flags import get_flag
from ..jit.save_load import (example_inputs, export_program, load_artifact,
                             write_artifact)
from ..jit.static_function import InputSpec
from .executor import _interp
from .program import Program, Variable, _OpNode

__all__ = ["save_inference_model", "load_inference_model"]


def _prune(nodes, fetch_vars) -> List:
    """The nodes the fetch variables depend on (reference:
    Program._prune_with_input), in program order.  Control-flow nodes
    keep the producers of the Variables their closures read."""
    needed = {id(v) for v in fetch_vars}
    kept = []
    for node in reversed(nodes):
        if any(id(v) in needed for v in node.out_vars):
            kept.append(node)
            needed.update(id(v) for tag, v in node.in_specs if tag == "v")
            needed.update(id(v) for v in node.extra_vars)
    kept.reverse()
    return kept


def _plain_constants(nodes) -> List:
    """The nodes with their recorded constants (``("c", tensor)``) as
    plain ``torch.Tensor``s: ``torch.export`` takes a tensor of a
    subclass that is not its own fake for a foreign value."""
    out = []
    for n in nodes:
        specs = [(tag, torch.Tensor.as_subclass(v, torch.Tensor))
                 if tag == "c" and isinstance(v, torch.Tensor) else (tag, v)
                 for tag, v in n.in_specs]
        out.append(_OpNode(n.fn, n.attrs, n.op_name, specs, n.out_vars,
                           n.multi, n.loc, n.trace, n.extra_vars,
                           n.extra_params))
    return out


def _params_of(nodes) -> List[torch.nn.Parameter]:
    seen, out = set(), []
    for node in nodes:
        for p in [v for tag, v in node.in_specs if tag == "p"] \
                + list(node.extra_params):
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def _param_names(params) -> List[str]:
    names = [getattr(p, "param_name", None) or f"param_{i}"
             for i, p in enumerate(params)]
    if len(set(names)) != len(names):
        names = [f"param_{i}" for i in range(len(params))]
    return names


def save_inference_model(path_prefix: str, feed_vars: Sequence[Variable],
                         fetch_vars: Sequence[Variable], executor=None,
                         program: Program = None, **kwargs):
    feed_vars = list(feed_vars)
    fetch_vars = list(fetch_vars)
    program = program or feed_vars[0].program
    nodes = list(program.nodes)
    if get_flag("use_pallas_kernels"):
        from .analysis import fusion
        plans = fusion.plan_fusions(
            program, fetch_list=fetch_vars,
            feed_shapes={v.name: tuple(1 if s < 0 else s for s in v.shape)
                         for v in feed_vars})
        if plans:
            nodes = fusion.apply_plans(nodes, plans)
    nodes = _plain_constants(_prune(nodes, fetch_vars))
    params = _params_of(nodes)
    n_p = len(params)

    def infer(*flat):
        pmap = {id(p): t for p, t in zip(params, flat[:n_p])}
        env = {id(v): t for v, t in zip(feed_vars, flat[n_p:])}
        env = _interp(nodes, env, pmap)
        return [env[id(v)] for v in fetch_vars]

    specs = [InputSpec([None if s < 0 else s for s in v.shape], v.dtype)
             for v in feed_vars]
    dev = params[0].device if params else torch.device("cpu")
    examples, dyn, declared = example_inputs(specs, dev)
    ep, fields = export_program(infer, params, examples, dyn, declared,
                                "save_inference_model")
    names = _param_names(params)
    meta = dict(fields, source="static",
                feed_names=[v.name for v in feed_vars],
                fetch_names=[v.name for v in fetch_vars],
                state_names=names,
                state_dtypes=[str(p.dtype).replace("torch.", "")
                              for p in params],
                in_shapes=[[None if s < 0 else s for s in v.shape]
                           for v in feed_vars],
                in_dtypes=[str(v.dtype).replace("torch.", "")
                           for v in feed_vars])
    write_artifact(path_prefix, ep, meta,
                   {n: p.detach() for n, p in zip(names, params)})


class _LoadedProgram:
    """Stands in for (inference_program, feed_names, fetch_targets) on
    the Executor.run path (the reference returns a deserialized
    ProgramDesc)."""

    def __init__(self, layer):
        self._layer = layer
        meta = layer.meta
        self.feed_names = list(meta.get("feed_names") or [])
        self.fetch_names = list(meta.get("fetch_names") or [])

    def _run_loaded(self, feed, fetch_list, return_numpy=True):
        feed = feed or {}
        outs = self._layer.run_flat([feed[n] for n in self.feed_names])
        if return_numpy:
            return [o.cpu().numpy() for o in outs]
        from ..core.tensor import wrap
        return [wrap(o) for o in outs]


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """``[program, feed_target_names, fetch_targets]``; run it with
    ``exe.run(program, feed={...}, fetch_list=program.fetch_names)``.
    It runs on the executor's place (else ``set_device``'s choice,
    else the current CUDA device)."""
    place = getattr(executor, "place", None)
    prog = _LoadedProgram(load_artifact(path_prefix, place))
    return [prog, prog.feed_names, prog.fetch_names]

