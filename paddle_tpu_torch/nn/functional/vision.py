"""Resampling and patch functions of paddle_tpu's ``nn.functional``:
``interpolate`` (``upsample``), ``pixel_shuffle``, ``unfold``,
``temporal_shift``, ``affine_grid`` and ``grid_sample``.

``interpolate`` resizes as ``jax.image.resize`` does, which is what
paddle_tpu calls: half-pixel centres; ``nearest`` takes the input pixel
``floor((i + 0.5) * in / out)``; ``bilinear``/``linear``/``trilinear``
and ``area`` are the triangle filter and ``bicubic`` Keys' cubic (a =
-0.5), each a weight matrix a resized dim, widened by ``in / out`` when
it shrinks (antialiasing) and normalised per output pixel.
``align_corners`` and ``align_mode`` are ignored, as in paddle_tpu.

``grid_sample`` and ``affine_grid`` default to ``align_corners=True``;
``grid_sample`` takes the modes paddle_tpu takes (bilinear, nearest;
zeros or border padding) and raises NotImplementedError on others.
``pixel_shuffle`` and ``temporal_shift`` take NCHW only (paddle_tpu
ignores ``data_format``), and raise on another layout.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import apply

__all__ = ["interpolate", "upsample", "pixel_shuffle", "unfold",
           "temporal_shift", "affine_grid", "grid_sample"]

_RESIZE_KERNEL = {"nearest": "nearest", "bilinear": "linear",
                  "linear": "linear", "trilinear": "linear",
                  "bicubic": "cubic", "area": "linear"}


def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(m, n, kernel, device):
    """jax.image's ``compute_weight_mat`` for a resize from ``m`` to
    ``n`` samples (scale n / m, no translation, antialiased): ``[m, n]``
    f32."""
    inv_scale = np.float32(1.0) / np.float32(n / m)
    kernel_scale = max(float(inv_scale), 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * float(inv_scale) - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32)
                                                      .eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _interpolate(a, *, out_sp, kernel, channels_last):
    first = 1 if channels_last else 2
    out = a
    for i, n in enumerate(out_sp):
        d = first + i
        m = out.shape[d]
        if m == n:
            continue
        if kernel == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=a.device) + 0.5)
                              * m / n).long()
            out = torch.index_select(out, d, idx)
        else:
            fn = _triangle if kernel == "linear" else _keys_cubic
            w = _weight_mat(m, n, fn, a.device).to(out.dtype)
            out = torch.movedim(torch.tensordot(
                torch.movedim(out, d, -1), w, dims=1), -1, d)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size``, or to ``int(s * f)`` for
    ``scale_factor`` f (see the module docstring for the filters)."""
    channels_last = not data_format.startswith("NC")
    spatial = (x.shape[1:-1] if channels_last else x.shape[2:])
    if size is not None:
        out_sp = ((int(size),) * len(spatial) if isinstance(size, int)
                  else tuple(int(s) for s in size))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        out_sp = tuple(int(s * f) for s, f in zip(spatial, sf))
    return apply(_interpolate, x, op_name="interpolate",
                 attrs={"out_sp": out_sp, "kernel": _RESIZE_KERNEL[mode],
                        "channels_last": channels_last})


upsample = interpolate


def _nchw_only(fn_name, data_format):
    if data_format != "NCHW":
        raise NotImplementedError(f"{fn_name}: data_format "
                                  f"{data_format!r}; only 'NCHW'")


def _pixel_shuffle(a, *, r):
    return TF.pixel_shuffle(a, r)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C r^2, H, W]`` -> ``[N, C, H r, W r]``."""
    _nchw_only("pixel_shuffle", data_format)
    return apply(_pixel_shuffle, x, op_name="pixel_shuffle",
                 attrs={"r": int(upscale_factor)})


def _pair(v):
    return (int(v),) * 2 if isinstance(v, int) else tuple(int(u) for u in v)


def _unfold(a, *, k, s, d, pads):
    (pt, pb), (pl, pr) = pads
    a = TF.pad(a, (pl, pr, pt, pb))
    return TF.unfold(a, k, dilation=d, stride=s)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C kh kw, L]``, channel-major.
    ``paddings``: an int, ``[ph, pw]`` or ``[top, bottom, left,
    right]``."""
    p = paddings
    if isinstance(p, int):
        pads = ((p, p), (p, p))
    elif len(p) == 2:
        pads = ((int(p[0]),) * 2, (int(p[1]),) * 2)
    elif len(p) == 4:
        pads = ((int(p[0]), int(p[1])), (int(p[2]), int(p[3])))
    else:
        raise ValueError(f"bad unfold paddings: {paddings}")
    return apply(_unfold, x, op_name="unfold",
                 attrs={"k": _pair(kernel_sizes), "s": _pair(strides),
                        "d": _pair(dilations), "pads": pads})


def _temporal_shift(a, *, seg_num, shift_ratio):
    NT, C, H, W = a.shape
    v = torch.reshape(a, (NT // seg_num, seg_num, C, H, W))
    fold = int(C * shift_ratio)
    out = torch.zeros_like(v)
    out[:, :-1, :fold] = v[:, 1:, :fold]                   # shift left
    out[:, 1:, fold:2 * fold] = v[:, :-1, fold:2 * fold]   # shift right
    out[:, :, 2 * fold:] = v[:, :, 2 * fold:]
    return torch.reshape(out, (NT, C, H, W))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift over the ``seg_num`` frames of each clip: the first
    ``C * shift_ratio`` channels come from the next frame, the next as
    many from the previous one, zeros at the clip's ends."""
    _nchw_only("temporal_shift", data_format)
    return apply(_temporal_shift, x, op_name="temporal_shift",
                 attrs={"seg_num": int(seg_num),
                        "shift_ratio": float(shift_ratio)})


def _affine_grid(th, *, H, W, align_corners):
    kw = dict(dtype=th.dtype, device=th.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, H, **kw)
        xs = torch.linspace(-1.0, 1.0, W, **kw)
    else:
        ys = (torch.arange(H, **kw) * 2 + 1) / H - 1.0
        xs = (torch.arange(W, **kw) * 2 + 1) / W - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)        # [H, W, 3]
    return torch.einsum("hwk,njk->nhwj", base, th)              # [N, H, W, 2]


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` (x, y) sampling grid of ``[N, 2, 3]`` affine
    matrices over ``out_shape`` ``[N, C, H, W]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, H, W = (int(v) for v in out_shape)
    return apply(_affine_grid, theta, op_name="affine_grid",
                 attrs={"H": H, "W": W,
                        "align_corners": bool(align_corners)})


def _grid_sample(a, g, *, mode, padding_mode, align_corners):
    N, C, H, W = a.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1.0) * (W - 1) / 2.0, (gy + 1.0) * (H - 1) / 2.0
    else:
        fx, fy = ((gx + 1.0) * W - 1.0) / 2.0, ((gy + 1.0) * H - 1.0) / 2.0
    bidx = torch.arange(N, device=a.device)[:, None, None]

    def tap(yi, xi):
        # each tap's value [N, H', W', C]; under zeros padding a tap
        # outside the input counts 0, so a sample straddling the border
        # keeps its inside taps
        v = a[bidx, :, torch.clamp(yi, 0, H - 1),
              torch.clamp(xi, 0, W - 1)]
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            v = v * inside[..., None]
        return v

    if mode == "nearest":
        out = tap(torch.round(fy).long(), torch.round(fx).long())
    else:
        y0, x0 = torch.floor(fy).long(), torch.floor(fx).long()
        wy, wx = fy - y0, fx - x0
        out = 0.0
        for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                          (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
            out = out + tap(y0 + dy, x0 + dx) * w[..., None]
    return torch.movedim(out, -1, 1)                        # [N, C, H', W']


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample NCHW ``x`` at the normalised (x, y) locations of ``grid``
    ``[N, H', W', 2]``."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"grid_sample mode {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample padding_mode {padding_mode!r}")
    return apply(_grid_sample, x, grid, op_name="grid_sample",
                 attrs={"mode": mode, "padding_mode": padding_mode,
                        "align_corners": bool(align_corners)})
