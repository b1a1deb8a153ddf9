"""``jit.save`` / ``jit.load``: a deployable artifact of a Layer's (or a
``to_static`` function's) eval forward, the counterpart of
``paddle_tpu/jit/save_load.py``.

**Format** (``paddle_tpu_torch.export.v1``):

- ``<path>.pdmodel``: 8 bytes of header length (little endian), a JSON
  header, then the program: ``torch.export.save`` of the forward
  captured by ``torch.export`` (non-strict) with the weights as its
  first inputs;
- ``<path>.pdiparams``: the parameters and buffers by name
  (``paddle.save``'s format), the weights the program is run with.

**Export rules.**

- The layer is exported in eval mode (dropout off; batch norm reads its
  running statistics as they are at save time) and put back in the
  mode it was in.
- The forward's tensor ``if``/``while`` are converted by dy2static and
  lower to ``torch.cond`` / torch's ``while_loop``; a Python ``if`` on
  a tensor that stays raises a ``TypeError`` naming paddle.cond, and a
  ``while_loop`` torch cannot export raises ``NotImplementedError``.
  No graph is written with a branch or a trip count fixed.
- A ``None`` (or negative) dim of an ``InputSpec`` is a
  ``torch.export`` dynamic dim (``Dim.AUTO``) traced at an example size
  of at least 2 (2 for the leading dim, ``2 + i`` at position ``i``),
  since torch fixes a dim whose example is 0 or 1.  A dim the forward
  fixes all the same is refused with a ``ValueError``.
- The hand kernels' forwards are custom ops (``paddle_tpu_torch::
  flash_attention_fwd``, ``paddle_tpu_torch::fused_linear_epilogue_fwd``):
  each stays one node of the graph, and the tensors' device picks the
  CUDA kernel or the plain version when the program runs.  The header
  lists the custom-op nodes (``kernels``).

**Loading.**  :func:`load` imports the module that registers the custom
ops before it deserialises, so an artifact loads in a process that
never imported the model's code, and moves the program to the device
it runs on (``device=``, else ``set_device``'s choice, else the current
CUDA device; with no GPU and no request for the CPU it raises).  An
artifact of paddle_tpu's JAX format (``paddle_tpu.stablehlo.v1``) is
refused with a ``ValueError`` naming both formats.
"""
from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.placement import device as _resolve_device
from ..core.static_hooks import to_static_scope
from ..core.tensor import wrap
from .bind import bind
from .static_function import InputSpec, StaticFunction

__all__ = ["save", "load", "TranslatedLayer", "SUFFIX_MODEL",
           "SUFFIX_PARAMS", "FORMAT", "export_program", "write_artifact",
           "read_artifact"]

SUFFIX_MODEL = ".pdmodel"
SUFFIX_PARAMS = ".pdiparams"
FORMAT = "paddle_tpu_torch.export.v1"
JAX_FORMAT = "paddle_tpu.stablehlo.v1"
_OP_NAMESPACE = "paddle_tpu_torch"


def example_inputs(specs, device):
    """``(examples, dynamic_shapes, declared)``: one example tensor per
    spec (zeros; ``InputSpec``'s dynamic dims at their example sizes),
    its ``dynamic_shapes`` entry, and the dynamic dims declared per
    input."""
    examples, dyn, declared = [], [], []
    for spec in specs:
        if isinstance(spec, InputSpec):
            dims = spec.dynamic_dims()
            shape = [2 + i if i in dims else int(s)
                     for i, s in enumerate(spec.shape)]
            examples.append(torch.zeros(shape, dtype=spec.torch_dtype,
                                        device=device))
            dyn.append({i: torch.export.Dim.AUTO for i in dims} or None)
            declared.append(dims)
        else:
            t = (torch.Tensor.detach(spec) if isinstance(spec, torch.Tensor)
                 else torch.as_tensor(np.asarray(spec)))
            examples.append(torch.Tensor.as_subclass(t.to(device),
                                                     torch.Tensor))
            dyn.append(None)
            declared.append([])
    return examples, dyn, declared


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *flat):
        return self.fn(*flat)


def _is_data_dependent(e: BaseException) -> bool:
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)
    while e is not None:
        if isinstance(e, GuardOnDataDependentSymNode) or \
                "data-dependent" in str(e):
            return True
        e = e.__cause__ or e.__context__
    return False


def _graph_modules(ep):
    return [m for m in ep.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)]


def export_program(fn: Callable, state: Sequence[torch.Tensor],
                   examples: Sequence[torch.Tensor], dyn, declared,
                   what: str):
    """``torch.export`` of ``fn(*state, *inputs)`` (no grad, inside the
    ``to_static`` scope) -> ``(exported program, header fields)``: the
    custom-op kernels the graph holds with their node counts, and which
    outputs carry the dynamic leading dim."""
    plain = [torch.Tensor.as_subclass(torch.Tensor.detach(t), torch.Tensor)
             for t in state]
    try:
        with torch.no_grad(), to_static_scope():
            ep = torch.export.export(
                _Program(fn), tuple(plain) + tuple(examples),
                dynamic_shapes=(tuple([None] * len(plain) + list(dyn)),),
                strict=False)
    except NotImplementedError:
        raise
    except Exception as e:           # noqa: BLE001 - re-raised with a hint
        if _is_data_dependent(e):
            raise TypeError(
                f"{what}: a Python `if`/`while` reads a tensor's value, "
                f"which a saved program cannot keep; use paddle.cond / "
                f"paddle.where for branches and paddle.while_loop for "
                f"loops ({type(e).__name__}: {str(e).splitlines()[0]})"
            ) from e
        raise
    from torch.fx.experimental.symbolic_shapes import is_concrete_int
    user = ep.graph_signature.user_inputs
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes
            if n.op == "placeholder"}
    for i, dims in enumerate(declared):
        v = vals[user[len(plain) + i]]
        for d in dims:
            if is_concrete_int(v.shape[d]):
                raise ValueError(
                    f"{what}: dim {d} of input {i} is declared dynamic "
                    f"(None) but the forward fixes it to {v.shape[d]}")
    kernels: Dict[str, int] = {}
    for gm in _graph_modules(ep):
        for node in gm.graph.nodes:
            ns = getattr(node.target, "namespace", None)
            if node.op == "call_function" and ns == _OP_NAMESPACE:
                name = node.target._schema.name
                kernels[name] = kernels.get(name, 0) + 1
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta.get("val") if isinstance(a, torch.fx.Node) else a
            for a in torch.utils._pytree.tree_leaves(out_node.args[0])]
    batched = None
    if any(declared):
        batched = [isinstance(o, torch.Tensor) and o.dim() >= 1
                   and not is_concrete_int(o.shape[0]) for o in outs]
    return ep, {"kernels": kernels, "out_batched": batched}


def write_artifact(path: str, ep, meta: dict,
                   state: Dict[str, torch.Tensor]) -> None:
    """The ``.pdmodel`` (header + program) and the ``.pdiparams``."""
    from ..framework_io import save as _save_obj
    # the examples held the weights: the program is written without them
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    head = json.dumps(dict(meta, format=FORMAT,
                           torch=torch.__version__)).encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}{SUFFIX_MODEL}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        f.write(buf.getvalue())
    os.replace(tmp, path + SUFFIX_MODEL)
    _save_obj(dict(state), path + SUFFIX_PARAMS)


def read_artifact(path: str):
    """``(header, exported program)`` of ``<path>.pdmodel``."""
    from .. import ops  # noqa: F401 - registers the custom ops it names
    with open(path + SUFFIX_MODEL, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    head = raw[8:8 + n]
    if JAX_FORMAT.encode() in head:
        raise ValueError(
            f"{path}{SUFFIX_MODEL} is a paddle_tpu artifact "
            f"({JAX_FORMAT}: serialized StableHLO for JAX); "
            f"paddle_tpu_torch reads {FORMAT}: save the model again with "
            f"paddle_tpu_torch.jit.save or static.save_inference_model")
    try:
        meta = json.loads(head)
    except (UnicodeDecodeError, ValueError):
        meta = {}
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}{SUFFIX_MODEL} is not a {FORMAT} "
                         f"artifact")
    return meta, torch.export.load(io.BytesIO(raw[8 + n:]))


class TranslatedLayer:
    """A loaded artifact (reference: TranslatedLayer, io.py): calling it
    runs the saved program on its device with the saved weights."""

    def __init__(self, meta: dict, program, state: Dict[str, torch.Tensor],
                 device: torch.device):
        from torch.export.passes import move_to_device_pass
        self._meta = meta
        self.device = device
        self._state = {k: wrap(v.to(device, convert_dtype(dt)))
                       for (k, v), dt in zip(
                           ((n, state[n]) for n in meta["state_names"]),
                           meta["state_dtypes"])}
        self._flat = [torch.Tensor.as_subclass(t, torch.Tensor)
                      for t in self._state.values()]
        self._in_dtypes = [convert_dtype(d) for d in meta["in_dtypes"]]
        self.program = move_to_device_pass(program, device)
        self._module = self.program.module()
        self.training = False

    @property
    def meta(self) -> dict:
        return dict(self._meta)

    def _run(self, args):
        if len(args) != len(self._in_dtypes):
            raise ValueError(f"the program takes {len(self._in_dtypes)} "
                             f"inputs, got {len(args)}")
        tensors = []
        for a, dtype in zip(args, self._in_dtypes):
            t = (torch.Tensor.as_subclass(torch.Tensor.detach(a),
                                          torch.Tensor)
                 if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.asarray(a)))
            tensors.append(t.to(self.device, dtype))
        with torch.no_grad():
            return self._module(*self._flat, *tensors)

    def run_flat(self, inputs: Sequence) -> List[torch.Tensor]:
        """The program's outputs, flat, as plain tensors on the device."""
        return torch.utils._pytree.tree_leaves(self._run(inputs))

    def __call__(self, *args):
        return torch.utils._pytree.tree_map(
            lambda t: wrap(t) if isinstance(t, torch.Tensor) else t,
            self._run(args))

    forward = __call__

    def eval(self):
        self.training = False
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._state)

    def parameters(self) -> List[torch.Tensor]:
        return list(self._state.values())


def load_artifact(path: str, device=None, params_file: Optional[str] = None
                  ) -> TranslatedLayer:
    from ..framework_io import loads
    meta, program = read_artifact(path)
    dev = _resolve_device(device)
    state = {}
    if meta["state_names"]:
        with open(params_file or path + SUFFIX_PARAMS, "rb") as f:
            state = loads(f.read(), device=dev)
    missing = [n for n in meta["state_names"] if n not in state]
    if missing:
        raise ValueError(f"{params_file or path + SUFFIX_PARAMS} lacks "
                         f"{missing[:5]}")
    return TranslatedLayer(meta, program, state, dev)


def save(layer, path: str, input_spec=None, **configs):
    """Export ``layer`` (a Layer or any ``torch.nn.Module``, or a
    ``to_static`` function) for inference: ``<path>.pdmodel`` and
    ``<path>.pdiparams``.  The examples are made on the device of the
    layer's weights (a function without any: the default placement)."""
    if isinstance(layer, torch.nn.Module):
        fwd, mod = layer.forward, layer
    elif callable(layer):
        fwd, mod = layer, getattr(layer, "layer", None)
    else:
        raise TypeError(f"jit.save expects a Layer or a function, got "
                        f"{type(layer).__name__}")
    if isinstance(fwd, StaticFunction):
        spec = input_spec if input_spec is not None else fwd._input_spec
        fwd_fn = fwd._fn
    else:
        spec = input_spec
        fwd_fn = StaticFunction._convert_control_flow(fwd)
    if spec is None:
        raise ValueError(
            "jit.save needs input_spec (a list of InputSpec or example "
            "Tensors) unless the forward was decorated with "
            "to_static(input_spec=...)")
    named_p = list(mod.named_parameters()) if mod is not None else []
    named_b = list(mod.named_buffers()) if mod is not None else []
    n_p, n_b = len(named_p), len(named_b)
    state = [t for _, t in named_p + named_b]
    dev = state[0].device if state else _resolve_device(None)
    examples, dyn, declared = example_inputs(spec, dev)

    def forward(*flat):
        if mod is None:
            return fwd_fn(*flat)
        with bind(mod, flat[:n_p], flat[n_p:n_p + n_b]):
            return fwd_fn(*flat[n_p + n_b:])

    was_training = mod.training if mod is not None else False
    if mod is not None:
        mod.eval()
    try:
        ep, fields = export_program(forward, state, examples, dyn,
                                    declared, "jit.save")
    finally:
        if was_training:
            mod.train()
    names = [n for n, _ in named_p + named_b]
    meta = dict(fields, source="layer" if mod is not None else "function",
                state_names=names,
                state_dtypes=[str(t.dtype).replace("torch.", "")
                              for t in state],
                in_shapes=[[None if i in d else int(s)
                            for i, s in enumerate(e.shape)]
                           for e, d in zip(examples, declared)],
                in_dtypes=[str(e.dtype).replace("torch.", "")
                           for e in examples])
    write_artifact(path, ep, meta,
                   {n: torch.Tensor.detach(t) for n, t in zip(names, state)})


def load(path: str, **configs) -> TranslatedLayer:
    """Load what :func:`save` (or ``static.save_inference_model``)
    wrote; ``device=`` places it (default: ``set_device``'s choice,
    else the current CUDA device)."""
    return load_artifact(path, configs.get("device"))
