"""Convolutions (``paddle_tpu.nn.functional`` conv*d and
conv*d_transpose), on torch's (cuDNN on the card).

The kernel layout is paddle's, which is torch's: ``[out_c, in_c/groups,
*k]`` for a convolution and ``[in_c, out_c/groups, *k]`` for a
transposed one.  ``padding`` is an int, one int a spatial dim, a
(before, after) pair a spatial dim flattened, or 'SAME'/'VALID' (XLA's
rule: SAME puts the odd pixel after); an uneven padding is applied with
``F.pad`` before a convolution with none.  A transposed convolution is
computed in full and cut to paddle_tpu's window: ``padding`` off the
ends, ``output_padding`` (or what ``output_size`` asks) added at the
end.  ``data_format`` may put the channels last."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _pads(padding, n, sizes, kernel, stride, dilation):
    """(before, after) for each spatial dim."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        if padding.upper() != "SAME":
            raise ValueError(f"bad conv padding: {padding!r}")
        out = []
        for i in range(n):
            kk = (kernel[i] - 1) * dilation[i] + 1
            total = max((math.ceil(sizes[i] / stride[i]) - 1) * stride[i]
                        + kk - sizes[i], 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, int):
        return [(padding, padding)] * n
    p = [int(x) for x in padding]
    if len(p) == n:
        return [(x, x) for x in p]
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    raise ValueError(f"bad conv padding: {padding}")


def _torch_pad(pads):
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return flat


def _conv(a, w, *bias, n, stride, padding, dilation, groups, channels_last):
    if channels_last:
        a = torch.movedim(a, -1, 1)
    pads = _pads(padding, n, a.shape[2:], w.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        a, sym = TF.pad(a, _torch_pad(pads)), 0
    out = _CONV[n](a, w, bias[0] if bias else None, stride, sym, dilation,
                   groups)
    return torch.movedim(out, 1, -1) if channels_last else out


def _convnd(x, weight, bias, stride, padding, dilation, groups, data_format,
            n):
    args = (x, weight) + (() if bias is None else (bias,))
    return apply(_conv, *args, op_name=f"conv{n}d",
                 attrs={"n": n, "stride": _tuple(stride, n),
                        "padding": padding if isinstance(padding, (str, int))
                        else tuple(padding),
                        "dilation": _tuple(dilation, n), "groups": groups,
                        "channels_last": not data_format.startswith("NC")})


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 3)


def _conv_t(a, w, *bias, n, stride, padding, output_padding, dilation,
            groups, output_size, channels_last):
    if channels_last:
        a = torch.movedim(a, -1, 1)
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for conv_transpose")
    pads = _pads(padding, n, a.shape[2:], w.shape[2:], stride, dilation)
    outpad = list(output_padding)
    if output_size is not None:
        want = _tuple(tuple(output_size), n)
        for i in range(n):
            kk = (w.shape[2 + i] - 1) * dilation[i] + 1
            base = ((a.shape[2 + i] - 1) * stride[i] - pads[i][0]
                    - pads[i][1] + kk)
            op = want[i] - base
            if not 0 <= op < max(stride[i], 1) + 1:
                raise ValueError(
                    f"conv_transpose: output_size[{i}]={want[i]} not "
                    f"reachable (base {base}, stride {stride[i]})")
            outpad[i] = op
    full = _CONV_T[n](a, w, None, stride, 0, 0, groups, dilation)
    extra = [max(0, op - hi) for op, (_, hi) in zip(outpad, pads)]
    if any(extra):
        full = TF.pad(full, _torch_pad([(0, e) for e in extra]))
    cut = [slice(None), slice(None)]
    for i in range(n):
        length = full.shape[2 + i] - extra[i]
        cut.append(slice(pads[i][0], length + outpad[i] - pads[i][1]))
    out = full[tuple(cut)]
    if bias:
        out = out + bias[0].reshape([1, -1] + [1] * n)
    return torch.movedim(out, 1, -1) if channels_last else out


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, output_size, data_format, n):
    args = (x, weight) + (() if bias is None else (bias,))
    return apply(_conv_t, *args, op_name=f"conv{n}d_transpose",
                 attrs={"n": n, "stride": _tuple(stride, n),
                        "padding": padding if isinstance(padding, (str, int))
                        else tuple(padding),
                        "output_padding": _tuple(output_padding, n),
                        "dilation": _tuple(dilation, n), "groups": groups,
                        "output_size": None if output_size is None
                        else tuple(output_size) if not isinstance(
                            output_size, int) else (output_size,),
                        "channels_last": not data_format.startswith("NC")})


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, output_size, data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, output_size, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, output_size, data_format, 3)
