"""Shape, layout, indexing, gather/scatter, sort and search ops
(``paddle_tpu.ops.manipulation``).

Semantics are paddle_tpu's: ``split`` takes a number of equal sections
or a list of sizes (one may be -1), ``gather`` takes rows along
``axis`` (an ``index_select``), ``scatter`` overwrites (or zeroes and
accumulates) rows of dim 0, ``pad``'s short form pads the last spatial
dims first, ``sort`` gives the values only.  Indices come out int64
(int32 in paddle_tpu without x64).  ``unique`` runs on the host, as
there."""
from __future__ import annotations

import builtins
from builtins import slice as builtins_slice

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dispatch import apply
from ..core.dtype import convert_dtype, get_default_dtype
from ..core.tensor import wrap

__all__ = [
    "cast", "reshape", "reshape_", "transpose", "t", "moveaxis", "swapaxes",
    "flatten", "squeeze", "squeeze_", "unsqueeze", "unsqueeze_", "concat",
    "stack", "split", "chunk", "unbind", "unstack", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "flip", "rot90",
    "roll", "repeat_interleave", "gather", "gather_nd", "take_along_axis",
    "put_along_axis", "scatter", "scatter_", "scatter_nd_add", "scatter_nd",
    "index_select", "index_sample", "masked_select", "masked_fill", "where",
    "nonzero", "pad", "sort", "argsort", "topk", "kthvalue", "mode",
    "unique", "searchsorted", "bucketize", "one_hot", "diff", "as_strided",
    "getitem", "setitem", "slice", "strided_slice", "crop_tensor",
    "shard_index"]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _ints(seq):
    if isinstance(seq, torch.Tensor):
        return tuple(int(s) for s in seq.tolist())
    return tuple(_int(s) for s in seq)


def _cast(a, *, dtype):
    return a.to(dtype)


def cast(x, dtype):
    return apply(_cast, x, op_name="cast",
                 attrs={"dtype": convert_dtype(dtype)})


def _reshape(a, *, shape):
    return torch.reshape(a, shape)


def reshape(x, shape, name=None):
    return apply(_reshape, x, op_name="reshape",
                 attrs={"shape": _ints(shape)})


def reshape_(x, shape, name=None):
    x.data = torch.reshape(x.data, _ints(shape))
    return x


def _transpose(x, perm):
    return x.permute(perm)


def transpose(x, perm, name=None):
    """``x`` with its dims in the order ``perm``: a view, so autograd
    carries the gradient to ``x``."""
    return apply(_transpose, x, op_name="transpose",
                 attrs={"perm": tuple(int(p) for p in perm)})


def _t(a):
    return a if a.dim() < 2 else torch.t(a)


def t(x, name=None):
    return apply(_t, x, op_name="t")


def _moveaxis(a, *, source, destination):
    return torch.movedim(a, source, destination)


def moveaxis(x, source, destination, name=None):
    return apply(_moveaxis, x, op_name="moveaxis",
                 attrs={"source": source, "destination": destination})


def _swapaxes(a, *, axis1, axis2):
    return torch.swapaxes(a, axis1, axis2)


def swapaxes(x, axis1, axis2, name=None):
    return apply(_swapaxes, x, op_name="swapaxes",
                 attrs={"axis1": int(axis1), "axis2": int(axis2)})


def _flatten(a, *, start_axis, stop_axis):
    if a.dim() == 0:
        return torch.reshape(a, (1,))
    return torch.flatten(a, start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply(_flatten, x, op_name="flatten",
                 attrs={"start_axis": int(start_axis),
                        "stop_axis": int(stop_axis)})


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(_int(a) for a in axis)
    return (_int(axis),)


def _squeeze(a, *, axis):
    if axis is None:
        return torch.squeeze(a)
    return torch.squeeze(a, axis) if a.dim() else a


def squeeze(x, axis=None, name=None):
    return apply(_squeeze, x, op_name="squeeze", attrs={"axis": _axes(axis)})


def squeeze_(x, axis=None, name=None):
    x.data = _squeeze(x.data, axis=_axes(axis))
    return x


def _unsqueeze(a, *, axis):
    for ax in sorted(axis):
        a = torch.unsqueeze(a, ax)
    return a


def unsqueeze(x, axis, name=None):
    return apply(_unsqueeze, x, op_name="unsqueeze",
                 attrs={"axis": _axes(axis)})


def unsqueeze_(x, axis, name=None):
    x.data = _unsqueeze(x.data, axis=_axes(axis))
    return x


def _concat(*xs, axis):
    return torch.cat(xs, axis)


def concat(x, axis=0, name=None):
    return apply(_concat, *list(x), op_name="concat",
                 attrs={"axis": _int(axis)})


def _stack(*xs, axis):
    return torch.stack(xs, axis)


def stack(x, axis=0, name=None):
    return apply(_stack, *list(x), op_name="stack",
                 attrs={"axis": _int(axis)})


def _sections(total, num_or_sections):
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into "
                             f"{num_or_sections} equal sections")
        return [total // num_or_sections] * num_or_sections
    sections = [_int(s) for s in num_or_sections]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return sections


def _split(a, *, num_or_sections, axis):
    return tuple(torch.Tensor.split(
        a, _sections(a.shape[axis], num_or_sections), axis))


def split(x, num_or_sections, axis=0, name=None):
    nos = (num_or_sections if isinstance(num_or_sections, int)
           else tuple(_int(s) for s in num_or_sections))
    return list(apply(_split, x, op_name="split",
                      attrs={"num_or_sections": nos, "axis": _int(axis)}))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def _unbind(a, *, axis):
    return tuple(torch.unbind(a, axis))


def unbind(x, axis=0, name=None):
    return list(apply(_unbind, x, op_name="unbind",
                      attrs={"axis": _int(axis)}))


unstack = unbind


def _tile(a, *, repeat_times):
    return torch.tile(a, repeat_times)


def tile(x, repeat_times, name=None):
    return apply(_tile, x, op_name="tile",
                 attrs={"repeat_times": _ints(repeat_times)})


def _expand(a, *, shape):
    return torch.Tensor.expand(a, *shape)


def expand(x, shape, name=None):
    return apply(_expand, x, op_name="expand", attrs={"shape": _ints(shape)})


def expand_as(x, y, name=None):
    return apply(_expand, x, op_name="expand_as",
                 attrs={"shape": tuple(y.shape)})


def _broadcast_to(a, *, shape):
    return torch.broadcast_to(a, shape)


def broadcast_to(x, shape, name=None):
    return apply(_broadcast_to, x, op_name="broadcast_to",
                 attrs={"shape": _ints(shape)})


def _broadcast_tensors(*xs):
    return tuple(torch.broadcast_tensors(*xs))


def broadcast_tensors(inputs, name=None):
    return list(apply(_broadcast_tensors, *inputs,
                      op_name="broadcast_tensors"))


def _flip(a, *, axis):
    return torch.flip(a, axis)


def flip(x, axis, name=None):
    return apply(_flip, x, op_name="flip", attrs={"axis": _axes(axis)})


def _rot90(a, *, k, axes):
    return torch.rot90(a, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(_rot90, x, op_name="rot90",
                 attrs={"k": int(k), "axes": tuple(axes)})


def _roll(a, *, shifts, axis):
    if axis is None:
        return torch.roll(a, shifts)
    return torch.roll(a, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    return apply(_roll, x, op_name="roll",
                 attrs={"shifts": shifts if isinstance(shifts, int)
                        else tuple(shifts),
                        "axis": axis if axis is None or isinstance(axis, int)
                        else tuple(axis)})


def _repeat_interleave(a, repeats, *, axis):
    return torch.repeat_interleave(a, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply(_repeat_interleave, x, repeats,
                 op_name="repeat_interleave", attrs={"axis": axis})


# -- gather / scatter ----------------------------------------------------------

def _gather(a, i, *, axis):
    return torch.index_select(a, axis, i.reshape(-1))


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` at ``index`` along ``axis`` (an index_select; a
    multi-dim index is flattened, as in paddle_tpu)."""
    return apply(_gather, x, index, op_name="gather",
                 attrs={"axis": _int(axis)})


def _gather_nd(a, idx):
    return a[tuple(torch.unbind(idx.long(), -1))]


def gather_nd(x, index, name=None):
    return apply(_gather_nd, x, index, op_name="gather_nd")


def _take_along_axis(a, i, *, axis):
    return torch.take_along_dim(a, i.long(), axis)


def take_along_axis(arr, indices, axis, name=None):
    return apply(_take_along_axis, arr, indices, op_name="take_along_axis",
                 attrs={"axis": int(axis)})


def _put_along_axis(a, i, v, *, axis, reduce):
    i = i.long()
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=a.device)
    v = torch.broadcast_to(v.to(a.dtype), i.shape)
    if reduce == "assign":
        return torch.scatter(a, axis, i, v)
    if reduce == "add":
        return torch.scatter_add(a, axis, i, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(a, axis, i, v, "prod")
    raise ValueError(f"put_along_axis: reduce={reduce!r}")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    return apply(_put_along_axis, arr, indices, values,
                 op_name="put_along_axis",
                 attrs={"axis": int(axis), "reduce": reduce})


def _scatter(a, i, u, *, overwrite):
    i = (i.reshape(-1).long(),)
    if overwrite:
        return torch.index_put(a, i, u.to(a.dtype))
    zeroed = torch.index_put(a, i, torch.zeros_like(u, dtype=a.dtype))
    return torch.index_put(zeroed, i, u.to(a.dtype), accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of dim 0 set to ``updates`` (``overwrite``), or
    zeroed and then summed over repeated indices."""
    return apply(_scatter, x, index, updates, op_name="scatter",
                 attrs={"overwrite": bool(overwrite)})


def scatter_(x, index, updates, overwrite=True, name=None):
    out = _scatter(x.detach(), index, updates.detach(), overwrite=overwrite)
    with torch.no_grad():
        torch.Tensor.copy_(x, out)
    return x


def _scatter_nd_add(a, i, u):
    return torch.index_put(a, tuple(torch.unbind(i.long(), -1)),
                           u.to(a.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return apply(_scatter_nd_add, x, index, updates, op_name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    z = wrap(torch.zeros(_ints(shape), dtype=updates.dtype,
                         device=updates.device))
    return scatter_nd_add(z, index, updates)


def _index_select(a, i, *, axis):
    return torch.index_select(a, axis, i)


def index_select(x, index, axis=0, name=None):
    return apply(_index_select, x, index, op_name="index_select",
                 attrs={"axis": int(axis)})


def _index_sample(a, i):
    return torch.gather(a, 1, i.long())


def index_sample(x, index, name=None):
    return apply(_index_sample, x, index, op_name="index_sample")


def masked_select(x, mask, name=None):
    return apply(torch.masked_select, x, mask, op_name="masked_select")


def _masked_fill(a, m, v):
    if not isinstance(v, torch.Tensor):
        return torch.masked_fill(a, m, v)
    return torch.where(m, v.to(a.dtype), a)


def masked_fill(x, mask, value, name=None):
    return apply(_masked_fill, x, mask, value, op_name="masked_fill")


def _where(c, a, b):
    return torch.where(c, a, b)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply(_where, condition, x, y, op_name="where")


def nonzero(x, as_tuple=False):
    if as_tuple:
        return wrap(tuple(torch.nonzero(x, as_tuple=True)))
    return wrap(torch.nonzero(x))


def _pad_widths(a, pad, data_format):
    """Per-dim (before, after), from the full form (a pair per dim, in
    dim order) or paddle's short form (pairs from the last spatial dim
    inward)."""
    p = [_int(v) for v in pad]
    if len(p) == a.dim() * 2:
        return [(p[2 * i], p[2 * i + 1]) for i in range(a.dim())]
    width = [(0, 0)] * a.dim()
    n = len(p) // 2
    first = a.dim() - 1 if data_format.startswith("NC") else a.dim() - 2
    for j in range(n):
        width[first - j] = (p[2 * j], p[2 * j + 1])
    return width


def _pad(a, *, pad, mode, value, data_format):
    flat = []                       # torch's order: last dim first
    for w in reversed(_pad_widths(a, pad, data_format)):
        flat += list(w)
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    if mode == "constant":
        return TF.pad(a, flat, value=value)
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    return TF.pad(a, flat, mode=tmode)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return apply(_pad, x, op_name="pad",
                 attrs={"pad": tuple(_int(v) for v in pad), "mode": mode,
                        "value": value, "data_format": data_format})


# -- sort / search ---------------------------------------------------------------

def _sort(a, *, axis, descending):
    return torch.sort(a, dim=axis, descending=descending, stable=True).values


def sort(x, axis=-1, descending=False, name=None):
    return apply(_sort, x, op_name="sort",
                 attrs={"axis": int(axis), "descending": bool(descending)})


def _argsort(a, *, axis, descending):
    return torch.argsort(a, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, name=None):
    return apply(_argsort, x, op_name="argsort",
                 attrs={"axis": int(axis), "descending": bool(descending)})


def _topk(a, *, k, axis, largest, sorted):
    r = torch.topk(a, k, dim=axis, largest=largest, sorted=sorted)
    return r.values, r.indices


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    return apply(_topk, x, op_name="topk",
                 attrs={"k": _int(k), "axis": int(axis),
                        "largest": bool(largest), "sorted": bool(sorted)})


def _kthvalue(a, *, k, axis, keepdim):
    r = torch.kthvalue(a, k, dim=axis, keepdim=keepdim)
    return r.values, r.indices


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply(_kthvalue, x, op_name="kthvalue",
                 attrs={"k": int(k), "axis": int(axis),
                        "keepdim": bool(keepdim)})


def _mode(a, *, axis, keepdim):
    r = torch.mode(a, dim=axis, keepdim=keepdim)
    return r.values, r.indices


def mode(x, axis=-1, keepdim=False, name=None):
    return apply(_mode, x, op_name="mode",
                 attrs={"axis": int(axis), "keepdim": bool(keepdim)})


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique`` of ``x``'s values, on the host, as in paddle_tpu;
    the results go back to ``x``'s device."""
    a = x.detach().cpu().numpy()
    res = np.unique(a, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    back = lambda r: wrap(torch.from_numpy(np.asarray(r)).to(  # noqa: E731
        x.device))
    if not isinstance(res, tuple):
        return back(res)
    return tuple(back(r) for r in res)


def _searchsorted(s, v, *, out_int32, right):
    return torch.searchsorted(s, v, out_int32=out_int32, right=right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply(_searchsorted, sorted_sequence, values,
                 op_name="searchsorted",
                 attrs={"out_int32": bool(out_int32), "right": bool(right)})


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def _one_hot(a, *, num_classes):
    return TF.one_hot(a.long(), num_classes).to(get_default_dtype())


def one_hot(x, num_classes, name=None):
    return apply(_one_hot, x, op_name="one_hot",
                 attrs={"num_classes": int(num_classes)})


def _diff(a, *, n, axis):
    return torch.diff(a, n, axis)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply(_diff, x, op_name="diff", attrs={"n": int(n),
                                                  "axis": int(axis)})


def as_strided(x, shape, stride, offset=0, name=None):
    raise NotImplementedError(
        "as_strided has no counterpart in paddle_tpu; use reshape/slice")


# -- indexing (the __getitem__/__setitem__ backends) --------------------------

def _getitem(a, *, idx):
    return a[idx]


def getitem(x, idx):
    return apply(_getitem, x, op_name="slice", attrs={"idx": idx})


def setitem(x, idx, value):
    """``x[idx] = value`` in place."""
    torch.Tensor.__setitem__(x, idx, value)
    return x


def _slice_index(a, axes, starts, ends):
    idx = [builtins_slice(None)] * a.dim()
    for ax, s, e in zip(axes, starts, ends):
        dim = a.shape[ax]
        s, e = _int(s), _int(e)
        s = s if s >= 0 else s + dim
        e = e if e >= 0 else e + dim
        idx[ax] = builtins_slice(builtins.max(s, 0), builtins.min(e, dim))
    return tuple(idx)


def _slice(a, *, axes, starts, ends):
    return a[_slice_index(a, axes, starts, ends)]


def slice(input, axes, starts, ends, name=None):  # noqa: A001
    """reference: operators/slice_op.cc — slice along the given axes."""
    return apply(_slice, input, op_name="slice",
                 attrs={"axes": tuple(axes), "starts": _ints(starts),
                        "ends": _ints(ends)})


def _strided_slice(a, *, axes, starts, ends, strides):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        dim = a.shape[ax]
        s = s if s >= 0 else s + dim
        e = e if e >= 0 else e + dim
        keep = list(range(dim))[builtins_slice(s, e, st)]
        a = torch.index_select(a, ax, torch.tensor(keep, dtype=torch.long,
                                                   device=a.device))
    return a


def strided_slice(x, axes, starts, ends, strides, name=None):
    return apply(_strided_slice, x, op_name="strided_slice",
                 attrs={"axes": tuple(axes), "starts": _ints(starts),
                        "ends": _ints(ends), "strides": _ints(strides)})


def _crop(a, *, shape, offsets):
    shape = list(shape if shape is not None else a.shape)
    offsets = list(offsets if offsets is not None else [0] * a.dim())
    shape = [a.shape[i] - offsets[i] if s in (-1, None) else s
             for i, s in enumerate(shape)]
    return a[tuple(builtins_slice(o, o + s) for o, s in zip(offsets, shape))]


def crop_tensor(x, shape=None, offsets=None, name=None):
    return apply(_crop, x, op_name="crop_tensor",
                 attrs={"shape": None if shape is None else tuple(shape),
                        "offsets": None if offsets is None
                        else tuple(offsets)})


def _shard_index(ids, *, lo, size, ignore_value):
    inside = (ids >= lo) & (ids < lo + size)
    return torch.where(inside, ids - lo, torch.full_like(ids, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Global ids -> this shard's local ids; others -> ``ignore_value``."""
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    size = (index_num + nshards - 1) // nshards
    return apply(_shard_index, input, op_name="shard_index",
                 attrs={"lo": shard_id * size, "size": size,
                        "ignore_value": ignore_value})
