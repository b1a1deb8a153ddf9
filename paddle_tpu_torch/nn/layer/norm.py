"""Normalisation layers (``paddle_tpu.nn.layer.norm``).

Batch norm keeps paddle's running statistics, which are not torch's:
buffers ``_mean`` and ``_variance`` (zeros and ones, named so that a
paddle_tpu ``state_dict`` loads by name), updated in training as
``momentum * old + (1 - momentum) * batch`` with the *biased* batch
variance.  The batch statistics come out of the normalising op itself
(``F.norm._batch_norm``), so the activation is read once; the buffers
are updated in place under ``no_grad``, once a forward: the forward a
recomputed segment replays in the backward (``core.autograd.
replaying()``) leaves them alone.  Eval mode, or ``use_global_stats``,
normalises with the buffers and updates nothing.

Weights are ones and biases zeros unless ``weight_attr`` /
``bias_attr`` say otherwise (False: none).
"""
from __future__ import annotations

import math
import warnings

import torch

from ...core import autograd
from ...core.dispatch import apply
from ...core.placement import device as _resolve_device
from .. import functional as F
from .. import initializer as I
from ..functional.norm import _batch_norm
from ..layer_base import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _Affine(Layer):
    """A layer with a weight (ones) and a bias (zeros) of one shape."""

    def _affine(self, shape, weight_attr, bias_attr, device):
        dev = _resolve_device(device)
        self.weight = self.create_parameter(
            shape, weight_attr, default_initializer=I.Constant(1.0),
            device=dev)
        self.bias = self.create_parameter(shape, bias_attr, is_bias=True,
                                          device=dev)
        return dev


class _BatchNormBase(_Affine):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = self._affine([num_features], weight_attr, bias_attr, device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        out = _batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training, self._epsilon,
                          self._data_format, training)
        if not training:
            return out
        out, mean, var = out
        if not autograd.replaying():
            with torch.no_grad():
                bufs = [self._mean, self._variance]
                dt = self._mean.dtype
                torch._foreach_mul_(bufs, self._momentum)
                torch._foreach_add_(bufs, torch._foreach_mul(
                    [mean.to(dt), var.to(dt)], 1.0 - self._momentum))
        return out

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCDHW"
                         else data_format, use_global_stats, name, device)


class BatchNorm(_BatchNormBase):
    """The old-style ``nn.BatchNorm``: ``act`` (a name in
    ``nn.functional``) after the normalisation."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the global batch, which every batch norm layer
    already is where it matters, as in the JAX package:

    - under ``parallel.SpmdTrainStep`` at dp > 1 the statistics are the
      global batch's (``F.norm.stats_over`` the 'dp' group: the
      per-channel sums are all-reduced forward and backward), and every
      rank's running buffers move by them;
    - on one process the batch is the global batch;
    - under eager ``DataParallel`` across processes each rank keeps its
      own batch's statistics, as paddle_tpu's eager path does
      (``convert_sync_batchnorm`` warns there)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` as it is (paddle_tpu's conversion is the
        identity); warns where more than one process trains."""
        from ...distributed.env import get_world_size
        if get_world_size() > 1:
            warnings.warn(
                "convert_sync_batchnorm: running stats are NOT synced "
                "across eager DataParallel processes; use the SPMD train "
                "step (batch sharded over 'dp') for global-batch BN "
                "statistics")
        return layer


class LayerNorm(_Affine):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self._affine(self._normalized_shape, weight_attr, bias_attr, device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}"


class GroupNorm(_Affine):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self._affine([num_channels], weight_attr, bias_attr, device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(_Affine):
    """Instance norm over the axes after 1 (``data_format`` and
    ``momentum`` are taken and unused, as in paddle_tpu)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self._affine([num_features], weight_attr, bias_attr, device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` the largest singular value of
    ``weight`` seen as ``[weight_shape[dim], -1]``, from ``power_iters``
    power iterations that start at the fixed ``weight_u``/``weight_v``
    (N(0, 1), not trained, not updated: paddle_tpu's)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        w = math.prod(s for i, s in enumerate(weight_shape) if i != dim)
        dev = _resolve_device(device)
        for name_, n in (("weight_u", weight_shape[dim]), ("weight_v", w)):
            p = self.create_parameter(
                [n], default_initializer=I.Normal(0.0, 1.0), device=dev)
            p.stop_gradient = True
            setattr(self, name_, p)

    def forward(self, weight):
        return apply(_spectral_norm, weight, self.weight_u, self.weight_v,
                     op_name="spectral_norm",
                     attrs={"dim": self._dim, "iters": self._power_iters,
                            "eps": self._eps})


def _spectral_norm(w, u, v, *, dim, iters, eps):
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    for _ in range(iters):
        v = torch.mv(torch.t(wm), u)
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = torch.mv(wm, v)
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / torch.dot(u, torch.mv(wm, v))
