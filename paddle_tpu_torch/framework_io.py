"""Weights carried across from paddle_tpu.

paddle_tpu's layers and the port's share parameter names and layouts
(``Linear.weight`` is ``[in, out]`` in both), so a paddle_tpu state
dict maps onto the port's one-to-one: a name check and a copy.  A static
Program's parameters map by position: both packages list them in
first-use order.  A tensor-parallel model holds shards:
:func:`shard_state_from_paddle_tpu` cuts the full arrays to this rank's
shards first."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .core.placement import device as _resolve_device

__all__ = ["state_dict_from_paddle_tpu", "program_state_from_paddle_tpu",
           "shard_state_from_paddle_tpu"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy kernel
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def state_dict_from_paddle_tpu(
        np_state: Mapping[str, np.ndarray],
        device: Union[str, torch.device, None] = None,
        model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` from a paddle_tpu layer
    (``{k: np.asarray(v.data) for k, v in layer.state_dict().items()}``)
    -> tensors on ``device``, ready for ``load_state_dict``.  With
    ``model``, the names and shapes must be exactly the model's."""
    if model is not None:
        own = model.state_dict()
        missing = sorted(set(own) - set(np_state))
        unexpected = sorted(set(np_state) - set(own))
        if missing or unexpected:
            raise KeyError(f"state dict names differ: missing {missing}, "
                           f"unexpected {unexpected}")
        for k, v in np_state.items():
            if tuple(np.shape(v)) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(np.shape(v))}, the "
                                 f"model has {tuple(own[k].shape)}")
    dev = _resolve_device(device)
    return {k: _tensor(v).to(dev) for k, v in np_state.items()}


def program_state_from_paddle_tpu(program, arrays: Sequence[np.ndarray],
                                  constants: Sequence[np.ndarray] = ()
                                  ) -> None:
    """Load a paddle_tpu Program's parameters into the port's ``program``
    (the same model recorded by both packages): ``arrays`` in
    ``program.parameters()`` order, e.g. ``[np.asarray(p.data) for p in
    jax_program.parameters()]``.  ``constants``, when given, are the
    tensors the paddle_tpu Program recorded as constants, in node order
    (a layer called eagerly while the program was built, such as the
    position embedding of ``bench.build_bert_static``); the port's are
    overwritten with them.  Every count and shape is checked first."""
    params = program.parameters()
    consts = [v for node in program.nodes for tag, v in node.in_specs
              if tag == "c"] if len(constants) else []
    for kind, own, new in (("parameters", params, list(arrays)),
                           ("constants", consts, list(constants))):
        if len(own) != len(new):
            raise ValueError(f"{len(new)} {kind} given, the program has "
                             f"{len(own)}")
        for i, (t, a) in enumerate(zip(own, new)):
            if tuple(np.shape(a)) != tuple(t.shape):
                raise ValueError(f"{kind} {i}: shape {tuple(np.shape(a))}, "
                                 f"the program has {tuple(t.shape)}")
    with torch.no_grad():
        for own, new in ((params, arrays), (consts, constants)):
            for t, a in zip(own, new):
                t.copy_(_tensor(a))


def shard_state_from_paddle_tpu(np_state: Mapping[str, np.ndarray],
                                model: torch.nn.Module, mesh=None
                                ) -> Dict[str, np.ndarray]:
    """Full ``{name: np.ndarray}`` (e.g. the JAX model's) -> this rank's
    shards for ``model`` on ``mesh`` (default: the installed one), ready
    for :func:`state_dict_from_paddle_tpu`.  A parameter with a
    ``placement`` (the tensor-parallel layers set one) is cut along each
    dim named by a mesh axis, at this rank's index on that axis; a dim
    the axis does not divide is zero-padded to the next multiple first,
    as the layers pad (``VocabParallelEmbedding``).  The rest is copied
    whole."""
    from .distributed.mesh import get_mesh
    mesh = mesh or get_mesh()
    params = dict(model.named_parameters())
    out = {}
    for name, full in np_state.items():
        a = np.asarray(full)
        spec = getattr(params.get(name), "placement", None) or ()
        for dim, axis in enumerate(spec):
            n = 1 if mesh is None or axis is None else mesh.axis_size(axis)
            if n == 1:
                continue
            per = -(-a.shape[dim] // n)
            if per * n != a.shape[dim]:
                pad = [(0, 0)] * a.ndim
                pad[dim] = (0, per * n - a.shape[dim])
                a = np.pad(a, pad)
            i = mesh.axis_index(axis)
            a = np.take(a, np.arange(i * per, (i + 1) * per), axis=dim)
        out[name] = a
    return out
