"""The eager ``Layer``, ``ParamAttr`` and the parameter-creation rule
(the counterparts of ``paddle_tpu.nn.layer_base``).

:class:`Layer` is a ``torch.nn.Module`` carrying paddle's methods, so
torch's machinery (``__call__``, hooks, ``to``, ``load_state_dict``,
``torch.autograd``) and paddle's (``parameters()`` as a list,
``sublayers``, ``create_parameter``, ``add_sublayer``,
``register_buffer(persistable=)``, ``state_dict``/``set_state_dict``,
``clear_gradients``, ``register_forward_post_hook``, ``full_name``)
both work.  Where the two share a name with different signatures
(``state_dict``, ``named_parameters``, ``parameters``, ``to``,
``register_buffer``), the method takes both: torch's own recursion
into sublayers keeps working.

A parameter is a paddle :class:`~..core.tensor.Parameter` (a
``torch.nn.Parameter``), made by :func:`create_parameter` from a
:class:`ParamAttr`: its initializer, ``trainable``, ``need_clip``, a
per-parameter ``learning_rate`` (``optimize_attr``) and a
``regularizer``, which the optimizers read.  It is drawn on the layer's
device: ``device=`` where a layer takes it, else the device
``set_device`` chose, else the current CUDA device (raising when there
is none)."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core.dtype import convert_dtype, get_default_dtype
from ..core.placement import device as _resolve_device
from ..core.tensor import Parameter, Tensor, wrap
from . import initializer as I

__all__ = ["ParamAttr", "create_parameter", "Layer", "unique_name"]


class ParamAttr:
    """How a layer makes one parameter: its ``name`` (kept as the
    parameter's ``param_name``: torch reserves ``Tensor.name``),
    ``initializer``, ``learning_rate`` (a factor on the optimizer's),
    ``regularizer`` (wins over the optimizer's ``weight_decay``),
    ``trainable`` (``requires_grad``) and ``need_clip`` (read by the
    global-norm clip)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the defaults; a ParamAttr as it is; a name or an
        Initializer -> a ParamAttr holding it; False -> False (no
        parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, device=None
                     ) -> Optional[Parameter]:
    """``Layer.create_parameter``'s rule: ``attr``'s initializer, else
    ``default_initializer``, else zeros for a bias and XavierNormal for a
    weight, drawn on ``device``; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    dtype = get_default_dtype() if dtype is None else convert_dtype(dtype)
    init = attr.initializer or default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierNormal())
    p = Parameter(init(tuple(int(s) for s in shape), dtype, device),
                  requires_grad=bool(attr.trainable))
    if attr.name is not None:
        p.param_name = attr.name
    if not attr.need_clip:
        p.need_clip = False
    if attr.regularizer is not None:
        p.regularizer = attr.regularizer
    if attr.learning_rate != 1.0:
        p.optimize_attr = {"learning_rate": float(attr.learning_rate)}
    return p


_unique_counters: Dict[str, int] = {}


def unique_name(prefix: str) -> str:
    """'prefix_N', N counting from 0 per prefix."""
    i = _unique_counters.get(prefix, 0)
    _unique_counters[prefix] = i + 1
    return f"{prefix}_{i}"


def _torch_device(d):
    if isinstance(d, str) and d.startswith("gpu"):
        return "cuda" + d[3:]
    return d


class Layer(nn.Module):
    """paddle's ``nn.Layer`` on ``torch.nn.Module``."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._full_name = unique_name(name_scope
                                      or type(self).__name__.lower())
        self._dtype = convert_dtype(dtype)
        self._param_suffix_counts: Dict[str, int] = {}

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None
                         ) -> Optional[Parameter]:
        """A parameter for this layer (see :func:`create_parameter`),
        named ``<full_name>.w_k`` / ``.b_k`` unless ``attr`` names it."""
        p = create_parameter(shape, attr, dtype or self._dtype, is_bias,
                             default_initializer, device)
        if p is not None and getattr(p, "param_name", None) is None:
            suffix = "b" if is_bias else "w"
            k = self._param_suffix_counts.get(suffix, 0)
            self._param_suffix_counts[suffix] = k + 1
            p.param_name = f"{self._full_name}.{suffix}_{k}"
        return p

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """``persistable`` (paddle) or ``persistent`` (torch): whether
        ``state_dict`` holds the buffer."""
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, wrap(tensor), persistent=bool(keep))
        return self._buffers[name]

    # -- traversal -----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None
                   ) -> List[Parameter]:
        rec = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=rec))

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None) -> List[Tensor]:
        rec = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=rec))

    def sublayers(self, include_self=False) -> List[nn.Module]:
        mods = list(self.modules())
        return mods if include_self else mods[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, mod in self.named_modules(prefix=prefix):
            if mod is not self or include_self:
                yield name, mod

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """paddle's call: the parameters and persistable buffers by
        structured name, as paddle Tensors (detached views).  torch's
        call (``prefix=``, ``keep_vars=``) is torch's."""
        if prefix is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        self._sync_owned_params()
        out = super().state_dict(destination=destination,
                                 prefix=structured_name_prefix,
                                 keep_vars=keep_vars)
        for k, v in out.items():
            wrap(v)
        return out

    def _sync_owned_params(self):
        """A step may hold a parameter's value elsewhere (ZeRO-3 rows
        between steps): let it give the parameter its full value before
        it is read or written here, as paddle_tpu's ``state_dict``
        does."""
        for p in self.parameters():
            ref = getattr(p, "_param_owner_step", None)
            owner = ref() if ref is not None else None
            if owner is not None:
                owner.sync_params()

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values into the existing parameters and buffers, shape
        checked (ValueError); returns ``(missing, unexpected)`` names."""
        self._sync_owned_params()
        own = super().state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                tgt = own[k]
                src = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"shape mismatch for {k}: loading {list(src.shape)} "
                        f"into {list(tgt.shape)}")
                torch.Tensor.copy_(tgt, src.to(tgt.device, tgt.dtype))
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype and device ----------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=, dtype=)`` with paddle's names ('gpu', 'float32')
        or torch's arguments.  A dtype casts the floating parameters and
        buffers (BatchNorm's running statistics too), as in paddle_tpu;
        the buffers stay paddle Tensors."""
        args = tuple(convert_dtype(a) if isinstance(a, str) and not (
            a.startswith(("cpu", "cuda", "gpu"))) else _torch_device(a)
            for a in args)
        if device is not None:
            kwargs["device"] = _torch_device(device)
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
            self._dtype = kwargs["dtype"]
        out = super().to(*args, **kwargs)
        for m in self.modules():
            for b in m._buffers.values():
                wrap(b)
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks, grads, names -------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after forward; a value it
        returns replaces the output.  The handle's ``remove()`` takes
        it off."""
        return self.register_forward_hook(hook)

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.grad = None

    def full_name(self) -> str:
        return self._full_name
