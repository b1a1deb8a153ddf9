"""Sequence ops over (padded values, lengths) pairs
(paddle_tpu.ops.sequence).

A ragged (LoD) batch is a dense ``[B, T, ...]`` tensor plus a ``[B]``
lengths vector, and every op is a masked dense computation over it, as
in paddle_tpu: over each row's valid prefix the semantics are the
reference kernels', and the padding is deterministic (``pad_value`` or
zero).  Lengths are int64 on the values' device (paddle_tpu's are
int32).  Each op is one paddle op through ``core.dispatch.apply``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import wrap

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
    "sequence_softmax", "sequence_reverse", "sequence_expand_as",
    "sequence_concat", "sequence_slice", "sequence_erase",
    "sequence_enumerate", "sequence_conv", "sequence_first_step",
    "sequence_last_step",
]


def _t(x, device=None):
    """``x`` as a tensor (a copy for host data), on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _lengths(lengths, like):
    """Lengths as an int64 paddle Tensor on ``like``'s device."""
    return wrap(_t(lengths, _t(like).device).to(torch.int64))


def _full_lengths(x):
    x = _t(x)
    return wrap(torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                           device=x.device))


def _mask(lengths, maxlen):
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths[:, None])


def _trail(t, ndim):
    """``t`` ([B] or [B, T]) with singleton dims up to ``ndim``."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


def _take_time(x, idx):
    """``x[b, idx[b, t], ...]``: a gather along dim 1."""
    idx = _trail(idx, x.dim()).expand(tuple(idx.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[B]`` lengths -> ``[B, maxlen]`` 0/1 mask."""
    from ..nn import functional as F
    return F.sequence_mask(lengths, maxlen, dtype)


def _pad_fn(xv, lv, *, maxlen, pad_value):
    offs = torch.cat([lv.new_zeros(1), torch.cumsum(lv, 0)[:-1]])
    idx = offs[:, None] + torch.arange(maxlen, device=lv.device)[None, :]
    gathered = xv[torch.clamp(idx, 0, xv.shape[0] - 1)]
    valid = _trail(_mask(lv, maxlen), gathered.dim())
    return (torch.where(valid, gathered,
                        torch.as_tensor(pad_value, dtype=xv.dtype,
                                        device=xv.device)), lv)


def sequence_pad(x, lengths, maxlen=None, pad_value=0.0, name=None):
    """Packed ``[total, ...]`` rows + ``[B]`` lengths -> ``([B, maxlen,
    ...], lengths)``; ``maxlen`` defaults to the longest (read on the
    host)."""
    lv = _lengths(lengths, x)
    if maxlen is None:
        maxlen = int(lv.max())
    return apply(_pad_fn, x, lv, op_name="sequence_pad",
                 attrs={"maxlen": int(maxlen),
                        "pad_value": float(pad_value)})


def sequence_unpad(x, lengths, name=None):
    """Padded ``[B, T, ...]`` -> packed ``[sum(lengths), ...]``.  The
    output's length depends on the data: the lengths are read on the
    host."""
    x = _t(x)
    ln = _t(lengths).tolist()
    return wrap(torch.cat([x[i, :int(n)] for i, n in enumerate(ln)], 0))


def _pool_fn(xv, lv, *, pool_type, pad_value):
    nd = xv.dim()
    m = _trail(_mask(lv, xv.shape[1]), nd)
    cnt = _trail(torch.clamp(lv.to(xv.dtype), min=1.0), nd - 1)
    if pool_type == "sum":
        out = (xv * m).sum(1)
    elif pool_type == "average":
        out = (xv * m).sum(1) / cnt
    elif pool_type == "sqrt":
        out = (xv * m).sum(1) / torch.sqrt(cnt)
    elif pool_type == "max":
        neg = torch.finfo(xv.dtype).min
        out = torch.where(m, xv, torch.as_tensor(
            neg, dtype=xv.dtype, device=xv.device)).amax(1)
    elif pool_type == "first":
        out = xv[:, 0]
    elif pool_type == "last":
        idx = torch.clamp(lv - 1, min=0)[:, None]
        out = _take_time(xv, idx)[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    # an empty sequence pools to pad_value
    empty = _trail(lv == 0, nd - 1)
    return torch.where(empty, torch.as_tensor(pad_value, dtype=xv.dtype,
                                              device=xv.device), out)


def sequence_pool(x, lengths, pool_type="average", pad_value=0.0,
                  name=None):
    """Masked pooling over time: sum / average / sqrt / max / first /
    last of ``[B, T, ...]`` with ``[B]`` lengths."""
    return apply(_pool_fn, x, _lengths(lengths, x), op_name="sequence_pool",
                 attrs={"pool_type": pool_type.lower(),
                        "pad_value": float(pad_value)})


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def _softmax_fn(xv, lv):
    m = _trail(_mask(lv, xv.shape[1]), xv.dim())
    z = torch.where(m, xv, torch.as_tensor(-float("inf"), dtype=xv.dtype,
                                           device=xv.device))
    out = torch.softmax(z, dim=1)
    return torch.where(m, out, torch.zeros((), dtype=xv.dtype,
                                           device=xv.device))


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid prefix; zero beyond it."""
    return apply(_softmax_fn, x, _lengths(lengths, x),
                 op_name="sequence_softmax")


def _reverse_fn(xv, lv):
    t = torch.arange(xv.shape[1], device=xv.device)[None, :]
    idx = torch.where(t < lv[:, None], lv[:, None] - 1 - t, t)
    return _take_time(xv, idx)


def sequence_reverse(x, lengths=None, name=None):
    """Each row's valid prefix reversed; the padding stays in place."""
    lv = _full_lengths(x) if lengths is None else _lengths(lengths, x)
    return apply(_reverse_fn, x, lv, op_name="sequence_reverse")


def _expand_as_fn(xv, lv, *, maxlen):
    tiled = xv[:, None].expand((xv.shape[0], maxlen) + tuple(xv.shape[1:]))
    m = _trail(_mask(lv, maxlen), tiled.dim()).to(xv.dtype)
    return tiled * m


def sequence_expand_as(x, lengths, maxlen, name=None):
    """Row i of ``[B, ...]`` repeated into ``[B, maxlen, ...]``, valid
    for ``lengths[i]`` slots and zero beyond."""
    return apply(_expand_as_fn, x, _lengths(lengths, x),
                 op_name="sequence_expand_as", attrs={"maxlen": int(maxlen)})


def _concat_fn(a, la, b, lb):
    B, Ta = a.shape[:2]
    Tb = b.shape[1]
    t = torch.arange(Ta + Tb, device=a.device)[None, :]
    ia = torch.clamp(t, 0, Ta - 1).expand(B, Ta + Tb)
    ib = torch.clamp(t - la[:, None], 0, Tb - 1)
    sel = torch.where(_trail(t < la[:, None], a.dim()), _take_time(a, ia),
                      _take_time(b, ib))
    valid = _trail(t < (la + lb)[:, None], a.dim()).to(a.dtype)
    return sel * valid, la + lb


def sequence_concat(xs, lengths_list, name=None):
    """Sequences concatenated along time row by row: the time dim is the
    inputs' summed, the valid prefix the lengths' sum, the padding zero.
    Returns ``(values, lengths)``."""
    if len(xs) != len(lengths_list) or not xs:
        raise ValueError("sequence_concat takes as many lengths as "
                         "inputs, at least one")
    out = xs[0] if isinstance(xs[0], torch.Tensor) else wrap(_t(xs[0]))
    lo = _lengths(lengths_list[0], out)
    for x2, l2 in zip(xs[1:], lengths_list[1:]):
        out, lo = apply(_concat_fn, out, lo, x2, _lengths(l2, out),
                        op_name="sequence_concat")
    return out, lo


def _slice_fn(xv, off, ln):
    B, T = xv.shape[:2]
    t = torch.arange(T, device=xv.device)[None, :]
    g = _take_time(xv, torch.clamp(off[:, None] + t, 0, T - 1))
    return g * _trail(t < ln[:, None], xv.dim()).to(xv.dtype), ln


def sequence_slice(x, offset, length, name=None):
    """Row i's time slice ``[offset[i], offset[i] + length[i])``,
    left-packed and zero-padded; returns ``(values, length)``."""
    return apply(_slice_fn, x, _lengths(offset, x), _lengths(length, x),
                 op_name="sequence_slice")


def _erase_fn(ids, lv, *, tokens):
    T = ids.shape[1]
    t = torch.arange(T, device=ids.device)[None, :]
    erase = torch.zeros_like(ids, dtype=torch.bool)
    for tok in tokens:
        erase = erase | (ids == tok)
    keep = (t < lv[:, None]) & ~erase
    # stable left compaction: order by (dropped, position)
    order = torch.argsort(torch.where(keep, t, T + t), dim=1)
    packed = torch.gather(ids, 1, order)
    new_len = keep.sum(1)
    return torch.where(t < new_len[:, None], packed,
                       torch.zeros((), dtype=ids.dtype,
                                   device=ids.device)), new_len


def sequence_erase(x, tokens, lengths=None, name=None):
    """Every id in ``tokens`` removed, the rest left-compacted and
    zero-padded; returns ``(ids, new_lengths)``."""
    lv = _full_lengths(x) if lengths is None else _lengths(lengths, x)
    return apply(_erase_fn, x, lv, op_name="sequence_erase",
                 attrs={"tokens": tuple(int(v) for v in tokens)})


def _enumerate_fn(ids, lv, *, win_size, pad_value):
    T = ids.shape[1]
    t = (torch.arange(T, device=ids.device)[:, None]
         + torch.arange(win_size, device=ids.device)[None, :])   # [T, W]
    g = ids[:, torch.clamp(t, 0, T - 1)]                        # [B, T, W]
    ok = t[None] < lv[:, None, None]
    return torch.where(ok, g, torch.as_tensor(pad_value, dtype=ids.dtype,
                                              device=ids.device))


def sequence_enumerate(x, win_size, pad_value=0, lengths=None, name=None):
    """Sliding windows of ids: ``[B, T]`` -> ``[B, T, win_size]``, a
    window that crosses its row's end padded with ``pad_value``."""
    lv = _full_lengths(x) if lengths is None else _lengths(lengths, x)
    return apply(_enumerate_fn, x, lv, op_name="sequence_enumerate",
                 attrs={"win_size": int(win_size),
                        "pad_value": int(pad_value)})


def _seq_conv_fn(xv, lv, w, *maybe_b, context_length, context_start):
    T = xv.shape[1]
    m = _mask(lv, T).to(xv.dtype)[..., None]
    xm = xv * m
    t = torch.arange(T, device=xv.device)
    cols = []
    for k in range(context_length):
        shift = context_start + k
        ok = ((t + shift >= 0) & (t + shift < T))[None, :, None]
        cols.append(torch.roll(xm, -shift, dims=1) * ok)
    out = torch.matmul(torch.cat(cols, dim=-1), w)   # [B, T, ctx*D] @ w
    if maybe_b:
        out = out + maybe_b[0]
    return out * m


def sequence_conv(x, lengths, weight, bias=None, context_length=3,
                  context_start=None, name=None):
    """Context-window convolution over time: ``context_length`` shifted
    copies of the masked input side by side, times ``weight`` (``[
    context_length * D, out]``), plus ``bias``, masked."""
    if context_start is None:
        context_start = -(context_length // 2)
    args = [x, _lengths(lengths, x), weight]
    if bias is not None:
        args.append(bias)
    return apply(_seq_conv_fn, *args, op_name="sequence_conv",
                 attrs={"context_length": int(context_length),
                        "context_start": int(context_start)})
