"""``paddle.save`` / ``paddle.load``, and weights carried across from
paddle_tpu.

:func:`save` and :func:`load` use paddle_tpu's wire format
(``paddle_tpu/framework_io.py``): the magic ``PDTPU001``, the length and
pickle of a skeleton (nested dicts, lists and tuples whose leaves are
``("__tensor__", key)``, ``("__ndarray__", key)`` or ``("__leaf__",
value)``), then an ``npz`` payload of the arrays by key.  A file written
by either package loads in the other.  A loaded tensor is a paddle
Tensor on the device ``set_device`` chose (else the current CUDA
device); bfloat16 tensors are written as float32.  ``encryption_key``
encrypts a file at rest (``utils.crypto``) and a ``scheme://`` path goes
through that scheme's registered filesystem (``utils.fs``), as in
paddle_tpu.

paddle_tpu's layers and the port's share parameter names and layouts
(``Linear.weight`` is ``[in, out]`` in both), so a paddle_tpu state
dict maps onto the port's one-to-one: a name check and a copy.  A static
Program's parameters map by position: both packages list them in
first-use order.  A tensor-parallel model holds shards:
:func:`shard_state_from_paddle_tpu` cuts the full arrays to this rank's
shards first."""
from __future__ import annotations

import io as _io
import os
import pickle
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .core.placement import device as _resolve_device
from .core.tensor import wrap

__all__ = ["save", "load", "dumps", "loads", "state_dict_from_paddle_tpu",
           "program_state_from_paddle_tpu", "shard_state_from_paddle_tpu"]

_MAGIC = b"PDTPU001"


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return torch.Tensor.numpy(t)


def _flatten(obj, prefix, arrays):
    if isinstance(obj, torch.Tensor):
        arrays[prefix] = _host(obj)
        return ("__tensor__", prefix)
    if isinstance(obj, np.ndarray):
        arrays[prefix] = obj
        return ("__ndarray__", prefix)
    if isinstance(obj, dict):
        return {k: _flatten(v, f"{prefix}.{k}", arrays)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_flatten(v, f"{prefix}[{i}]", arrays) for i, v in enumerate(obj)]
        return tuple(t) if isinstance(obj, tuple) else t
    return ("__leaf__", obj)


def _unflatten(spec, arrays, dev):
    if isinstance(spec, dict):
        return {k: _unflatten(v, arrays, dev) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_unflatten(v, arrays, dev) for v in spec]
    if isinstance(spec, tuple):
        if len(spec) == 2 and spec[0] == "__tensor__":
            return wrap(_tensor(arrays[spec[1]]).to(dev))
        if len(spec) == 2 and spec[0] == "__ndarray__":
            return arrays[spec[1]]
        if len(spec) == 2 and spec[0] == "__leaf__":
            return spec[1]
        return tuple(_unflatten(v, arrays, dev) for v in spec)
    return spec


def dumps(obj: Any, protocol: int = 4, encryption_key=None) -> bytes:
    """``obj`` in the wire format, in memory; with ``encryption_key``,
    encrypted (``utils.crypto``, AES-256-GCM)."""
    arrays: dict = {}
    skeleton = _flatten(obj, "r", arrays)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    sk = pickle.dumps(skeleton, protocol=protocol)
    payload = _MAGIC + len(sk).to_bytes(8, "little") + sk + buf.getvalue()
    if encryption_key is not None:
        from .utils import crypto
        payload = crypto.encrypt(payload, encryption_key)
    return payload


def loads(payload: bytes, device=None, encryption_key=None,
          source: str = "<bytes>") -> Any:
    """:func:`dumps`'s inverse; tensors go to ``device`` (default: the
    device ``set_device`` chose, else the current CUDA device).  An
    encrypted payload needs its ``encryption_key``.  Bytes without the
    magic are read as a plain pickle, as paddle_tpu does."""
    from .utils import crypto
    if crypto.is_encrypted(payload[:8]):
        if encryption_key is None:
            raise ValueError(
                f"'{source}' is encrypted — pass encryption_key= to load")
        payload = crypto.decrypt(payload, encryption_key)
    f = _io.BytesIO(payload)
    if f.read(8) != _MAGIC:
        f.seek(0)
        return pickle.load(f)
    n = int.from_bytes(f.read(8), "little")
    skeleton = pickle.loads(f.read(n))
    arrays = dict(np.load(_io.BytesIO(f.read()), allow_pickle=False))
    dev = _resolve_device(device) if arrays else None
    return _unflatten(skeleton, arrays, dev)


def save(obj: Any, path, protocol: int = 4, encryption_key=None, **configs):
    """``paddle.save``: a state dict, or nested dicts/lists/tuples of
    tensors, arrays and Python values, to ``path`` (a local path or one
    with a registered scheme, ``utils.fs``), written to a temporary file
    and renamed, so a crash never leaves half a file; ``encryption_key``
    encrypts it at rest (``utils.crypto``)."""
    from .utils import fs
    fs.write_atomic(os.fspath(path),
                    dumps(obj, protocol=protocol,
                          encryption_key=encryption_key))


def load(path, encryption_key=None, **configs) -> Any:
    """``paddle.load``: what :func:`save` (of either package) wrote."""
    from .utils import fs
    path = os.fspath(path)
    with fs.open_read(path) as f:
        payload = f.read()
    return loads(payload, encryption_key=encryption_key, source=path)


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
