"""Framework-level names of the top level (``paddle_tpu.framework_compat``):
the ``*Place`` classes, the dygraph mode switches, the CUDA RNG state,
``get_cudnn_version``, ``set_printoptions``, ``create_parameter`` and
``flops``.

Where the card gives another answer than the JAX package's TPU build:
- ``get_cudnn_version()`` is ``torch.backends.cudnn.version()``: cuDNN's
  version on a CUDA build, None without one (paddle_tpu: always None);
- ``get_cuda_rng_state()`` / ``set_cuda_rng_state()`` take and put back
  ``core.rng``'s whole state (its seed, host and device generators), so
  the port's dropout and the flash kernels' seeds draw again what they
  drew after the ``get`` (paddle_tpu: its seed and key counter).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["CPUPlace", "TPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "XPUPlace", "enable_dygraph", "disable_dygraph",
           "in_dygraph_mode", "get_cuda_rng_state", "set_cuda_rng_state",
           "get_cudnn_version", "set_printoptions", "create_parameter",
           "flops"]


class _Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return type(self) is type(other) and \
            self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(_Place):
    pass


class TPUPlace(_Place):
    """Accepted for API compatibility; the port has no TPU."""


class CUDAPlace(_Place):
    """The CUDA device of ordinal ``device_id``."""


class CUDAPinnedPlace(_Place):
    """Page-locked host memory."""


class XPUPlace(_Place):
    pass


# -- dygraph mode ------------------------------------------------------------
_dygraph = True


def enable_dygraph(place=None):
    global _dygraph
    _dygraph = True


def disable_dygraph():
    global _dygraph
    _dygraph = False


def in_dygraph_mode() -> bool:
    return _dygraph


# -- the RNG state -----------------------------------------------------------
def get_cuda_rng_state():
    """``[core.rng.get_rng_state()]``: every draw's state, host and
    devices."""
    from .core import rng
    return [rng.get_rng_state()]


def set_cuda_rng_state(state):
    """Put back :func:`get_cuda_rng_state`'s list."""
    from .core import rng
    rng.set_rng_state(state[0])


def get_cudnn_version():
    """cuDNN's version as an int, or None without cuDNN."""
    return torch.backends.cudnn.version()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """The options a Tensor's ``repr`` follows: it prints through
    numpy, as paddle_tpu's does, so these are numpy's print options (an
    option left None keeps its value)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """``paddle.create_parameter``: ``default_initializer``, else
    Constant(0) for a bias and XavierNormal for a weight, on the current
    device; ``name`` becomes its ``param_name``."""
    from .nn.layer_base import create_parameter as _create
    p = _create(shape, attr, dtype, is_bias, default_initializer)
    if name is not None:
        p.param_name = name
    return p


def flops(net, input_size, custom_ops=None, print_detail=False) -> int:
    """``paddle.flops``: the multiply-adds of one forward on zeros of
    ``input_size`` (0 or None dims taken as 1), counted by forward hooks
    on the conv and linear layers as the reference counts them (one
    multiply-add is one, plus one an output element for a conv's
    bias); ``custom_ops`` maps a layer type to ``fn(layer, inputs,
    output)`` giving its count."""
    from . import nn
    from .core.tensor import wrap

    counts = {}
    handles = []

    def hook(name, kind):
        def fn(layer, inputs, outputs):
            o = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            w = layer.weight
            if kind == "conv":
                per_out = int(np.prod(w.shape[1:]))
                bias_ops = 1 if layer.bias is not None else 0
                counts[name] = counts.get(name, 0) + int(
                    np.prod(o.shape)) * (per_out + bias_ops)
            else:
                rows = int(np.prod(o.shape)) // int(o.shape[-1])
                counts[name] = counts.get(name, 0) + rows * int(
                    np.prod(w.shape))
        return fn

    for name, sub in net.named_sublayers():
        if isinstance(sub, (nn.Conv1D, nn.Conv2D, nn.Conv3D)):
            handles.append(sub.register_forward_post_hook(
                hook(name, "conv")))
        elif isinstance(sub, nn.Linear):
            handles.append(sub.register_forward_post_hook(
                hook(name, "linear")))
        elif custom_ops and type(sub) in custom_ops:
            cnt = custom_ops[type(sub)]
            handles.append(sub.register_forward_post_hook(
                lambda l, i, o, _n=name, _c=cnt: counts.__setitem__(
                    _n, _c(l, i, o))))
    first = next(iter(net.parameters()), None)
    dev = first.device if first is not None else torch.device("cpu")
    x = wrap(torch.zeros([d if d else 1 for d in input_size],
                         dtype=torch.float32, device=dev))
    was = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        if was:
            net.train()
        for h in handles:
            h.remove()
    total = sum(counts.values())
    if print_detail:
        for k, v in counts.items():
            print(f"{k}: {v:,}")
        print(f"Total FLOPs: {total:,}")
    return total
