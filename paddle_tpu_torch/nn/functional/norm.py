"""Normalisation functions (``paddle_tpu.nn.functional``'s batch_norm,
group_norm, instance_norm and local_response_norm), with paddle_tpu's
semantics:

- :func:`batch_norm` normalises with the batch's statistics (biased
  variance) in training, with ``running_mean``/``running_var`` otherwise
  or under ``use_global_stats``; it never updates them (the layer does,
  ``nn.BatchNorm*``).  The channel axis is 1 for an ``NC*`` format,
  else the last.  Training runs ``aten.native_batch_norm`` with no
  running buffers, whose saved mean and inverse std give the layer the
  batch's statistics without a second read of the activation.  Inside
  :func:`stats_over` a group of more than one rank (``parallel.
  SpmdTrainStep`` enters it over 'dp'), training normalises with the
  statistics of the global batch, as GSPMD gives the JAX package: the
  per-channel count and sum, then the sum of squared deviations from the
  global mean, are summed over the group in f32 by an all-reduce whose
  backward all-reduces the two per-channel gradients (two passes over
  the activation, as ``jnp.var``);
- :func:`group_norm` moves a channels-last input's channels to axis 1
  and back;
- :func:`instance_norm` normalises over the axes after 1 whatever
  ``data_format`` says, and never uses running statistics, as in
  paddle_tpu;
- :func:`local_response_norm` is ``x / (k + alpha * s) ** beta`` with
  ``s`` the *sum* of squares over ``size`` channels around each one
  (torch's divides ``alpha`` by ``size``).

A bias given without a weight is dropped by group_norm and
instance_norm, as in paddle_tpu.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply

__all__ = ["batch_norm", "group_norm", "instance_norm",
           "local_response_norm", "stats_over"]

# the groups batch norm's training statistics are taken over, innermost
# last; process-wide (not per thread): a CUDA backward, and a recompute's
# replay inside it, run on the autograd engine's thread
_STATS_GROUPS: list = []


@contextlib.contextmanager
def stats_over(group):
    """Batch norm in training, inside this block, takes the statistics of
    the batch split over ``group`` (a ``distributed.Group``): every rank
    normalises with, and reports, the global batch's.  A group of one
    changes nothing."""
    _STATS_GROUPS.append(group)
    try:
        yield
    finally:
        _STATS_GROUPS.pop()


def _stats_group():
    g = _STATS_GROUPS[-1] if _STATS_GROUPS else None
    return g if g is not None and g.nranks > 1 else None


class _SumOverGroup(torch.autograd.Function):
    """An all-reduced sum whose every rank's part feeds every rank's
    result: the backward sums the cotangents over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed.collective import all_reduce
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        from ...distributed.collective import all_reduce
        return all_reduce(dy.contiguous().clone(), group=ctx.group), None


def _channels_last(data_format, ndim):
    return not (data_format.startswith("NC") and ndim > 1)


def _bn(x, mean, var, weight, bias, *, training, epsilon, channels_last,
        stats):
    a = torch.movedim(x, -1, 1) if channels_last else x
    if training:
        out, m, invstd = torch.ops.aten.native_batch_norm(
            a, weight, bias, None, None, True, 0.0, epsilon)
    else:
        out = TF.batch_norm(a, mean, var, weight, bias, False, 0.0, epsilon)
    if channels_last:
        out = torch.movedim(out, 1, -1)
    if not stats:
        return out
    return out, m.detach(), invstd.detach().float().pow(-2) - epsilon


def _bn_over_group(x, mean, var, weight, bias, *, training, epsilon,
                   channels_last, stats, group):
    """Training batch norm with the statistics of the batch split over
    ``group``; the composite's autograd carries the backward."""
    a = torch.movedim(x, -1, 1) if channels_last else x
    af = a.float()
    dims = [0] + list(range(2, a.dim()))
    shape = [1, -1] + [1] * (a.dim() - 2)
    count = af.new_full((af.shape[1],), af.numel() // af.shape[1])
    total = _SumOverGroup.apply(torch.stack([af.sum(dims), count]), group)
    n = total[1].detach()
    m = total[0] / n
    d = af - m.reshape(shape)
    v = _SumOverGroup.apply((d * d).sum(dims), group) / n
    out = d * torch.rsqrt(v + epsilon).reshape(shape)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    out = out.to(x.dtype)
    if channels_last:
        out = torch.movedim(out, 1, -1)
    if not stats:
        return out
    return out, m.detach(), v.detach()


def _batch_norm(x, running_mean, running_var, weight, bias, training,
                epsilon, data_format, stats):
    """batch_norm's one op; with ``stats`` (training only) it gives
    ``(out, batch mean, batch biased variance)``, the last two f32 for a
    low-precision input.  Inside :func:`stats_over` a group of more than
    one rank, training takes the global batch's statistics."""
    group = _stats_group() if training else None
    if group is not None:
        return apply(_bn_over_group, x, running_mean, running_var, weight,
                     bias, op_name="batch_norm",
                     attrs={"training": True, "epsilon": float(epsilon),
                            "channels_last": _channels_last(
                                data_format, len(x.shape)),
                            "stats": bool(stats), "group": group})
    return apply(_bn, x, running_mean, running_var, weight, bias,
                 op_name="batch_norm",
                 attrs={"training": bool(training),
                        "epsilon": float(epsilon),
                        "channels_last": _channels_last(data_format,
                                                        len(x.shape)),
                        "stats": bool(stats)})


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    return _batch_norm(x, running_mean, running_var, weight, bias,
                       training and not use_global_stats, epsilon,
                       data_format, False)


def _affine(weight, bias):
    if weight is None:
        return []
    return [weight] if bias is None else [weight, bias]


def _weight_bias(wb):
    return (wb[0] if wb else None), (wb[1] if len(wb) > 1 else None)


def _gn(x, *wb, num_groups, epsilon, channels_last):
    a = torch.movedim(x, -1, 1) if channels_last else x
    out = TF.group_norm(a, num_groups, *_weight_bias(wb), epsilon)
    return torch.movedim(out, 1, -1) if channels_last else out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    return apply(_gn, x, *_affine(weight, bias), op_name="group_norm",
                 attrs={"num_groups": int(num_groups),
                        "epsilon": float(epsilon),
                        "channels_last": not data_format.startswith("NC")})


def _in(x, *wb, eps):
    return TF.instance_norm(x, None, None, *_weight_bias(wb), True, 0.0, eps)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    return apply(_in, x, *_affine(weight, bias), op_name="instance_norm",
                 attrs={"eps": float(eps)})


def _lrn(x, *, size, alpha, beta, k):
    sq = torch.square(x)
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = TF.pad(sq, pads)
    c = x.shape[1]
    win = padded[:, 0:c]
    for i in range(1, size):
        win = win + padded[:, i:i + c]
    return x / (k + alpha * win) ** beta


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return apply(_lrn, x, op_name="local_response_norm",
                 attrs={"size": int(size), "alpha": alpha, "beta": beta,
                        "k": k})
