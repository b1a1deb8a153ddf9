"""vision.ops (``paddle_tpu.vision.ops``): detection primitives.

The same functions as paddle_tpu's, in the shapes a card runs well:

- Greedy NMS (``nms`` and ``multiclass_nms``) is one device step per
  sorted candidate, batched over every (image, class) row at once; the
  IoU rows are computed a block of candidates at a time, so no [M, M]
  matrix is built.  ``multiclass_nms`` sweeps only as far as the
  longest row's count of positive scores after the ``nms_top_k`` cut: a
  zero score is never kept, never suppresses and never moves the
  adaptive threshold, so the rest of the sweep changes nothing.  It
  also stops once each image holds ``keep_top_k`` kept candidates
  scoring above every candidate left in its rows (one host read a
  block of 64 steps): the rest cannot enter the output.  Ties
  at the k-th score keep paddle_tpu's rule (``sc >= top`` may keep
  more than k), and sorts are stable, so equal scores keep their index
  order as ``jnp.argsort`` and ``lax.top_k`` do.
- ``roi_align`` is separable: out[r, c, i, j] = sum_y sum_x
  A_y[r, i, y] A_x[r, j, x] x[b_r, c, y, x], where A_y and A_x hold the
  bilinear weights, the validity masks and the 1/S averages.  It runs as
  two batched products over the RoIs of each image, chunked so the
  intermediate stays bounded, and is differentiable in ``x`` and in the
  boxes.
- The detection zoo (``yolo_box``, ``prior_box``, ``box_coder``,
  ``box_clip``, the IoU functions) is elementwise tensor code.

Eager ``nms`` returns its variable-length result through the host, as
paddle_tpu's does; the indices are int64 (paddle_tpu's are int32 without
x64).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import Tensor  # noqa: F401  (paddle_tpu's module name)
from ..core.tensor import wrap

__all__ = ["box_iou", "nms", "box_area", "roi_align", "yolo_box",
           "prior_box", "box_coder", "multiclass_nms", "box_clip",
           "iou_similarity"]

# RoIs a roi_align product takes at once (bounds the [R, ph, C, W]
# intermediate: 128 RoIs at 14 bins, 1024 channels and 84 columns is
# 0.6 GB in f32)
_ROI_CHUNK = 128
# NMS candidates whose IoU rows are computed at once (64 x 1000
# candidates x 640 rows is 0.16 GB in f32)
_NMS_BLOCK = 64


def _t(x, like: Optional[torch.Tensor] = None, dtype=None):
    """``x`` as a torch tensor (numpy and Python data go to ``like``'s
    device)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x), device=dev, dtype=dtype)


def _area(b):
    return (torch.clamp(b[..., 2] - b[..., 0], min=0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0))


def box_area(boxes, name=None):
    """[..., 4] xyxy boxes -> areas."""
    return apply(_area, _t(boxes), op_name="box_area")


def _iou_matrix(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[:, None] + _area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def box_iou(boxes1, boxes2, name=None):
    """Pairwise IoU [N, M] for xyxy boxes (reference: iou_similarity_op)."""
    a = _t(boxes1)
    return apply(_iou_matrix, a, _t(boxes2, a), op_name="box_iou")


def _iou_block(bb, b, area_b, area):
    """IoU of the boxes ``bb`` [B, k, 4] against each row's boxes ``b``
    [B, n, 4] -> [B, k, n] (``_iou_matrix``'s arithmetic, a block of
    its rows)."""
    lt = torch.maximum(bb[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(bb[:, :, None, 2:], b[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_b[:, :, None] + area[:, None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _greedy_keep(boxes, live, iou_threshold, eta=1.0, settled=None):
    """Greedy NMS over rows already in score order.

    ``boxes`` [B, K, 4], ``live`` [B, K] (a candidate that may be kept:
    paddle_tpu's ``sc > 0`` in ``multiclass_nms``, every box in ``nms``).
    One step per candidate, every row at once: candidate ``i`` is kept
    unless live is false or an earlier kept candidate suppressed it, and
    a kept one suppresses the later candidates whose IoU with it passes
    the (adaptive) threshold.  The IoU of a block of ``_NMS_BLOCK``
    candidates against the candidates from the block on is computed at
    once, so no [K, K] matrix is held.  A candidate's suppression is
    final once the sweep reaches it, so keep is ``live & ~suppressed``
    at the end; returns it, [B, K].  ``settled(c, keep)``, asked after
    each block with the first ``c`` candidates' keep, may end the sweep
    there: the rest are returned as not kept."""
    B, K = live.shape
    area = _area(boxes)
    suppressed = torch.zeros(B, K, dtype=torch.bool, device=boxes.device)
    thresh = torch.full((B, 1), float(iou_threshold), dtype=boxes.dtype,
                        device=boxes.device)
    for c0 in range(0, K, _NMS_BLOCK):
        c1 = min(K, c0 + _NMS_BLOCK)
        iou = _iou_block(boxes[:, c0:c1], boxes[:, c0:], area[:, c0:c1],
                         area[:, c0:])
        over = iou > thresh[:, :, None] if eta == 1.0 else None
        for i in range(c0, c1):
            keep_i = live[:, i:i + 1] & ~suppressed[:, i:i + 1]
            if over is not None:
                hit = over[:, i - c0, i + 1 - c0:]
            else:
                hit = iou[:, i - c0, i + 1 - c0:] > thresh
                thresh = torch.where(keep_i & (thresh > 0.5), thresh * eta,
                                     thresh)
            suppressed[:, i + 1:] |= hit & keep_i
        if settled is not None and c1 < K and settled(
                c1, live[:, :c1] & ~suppressed[:, :c1]):
            keep = live & ~suppressed
            keep[:, c1:] = False
            return keep
    return live & ~suppressed


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None,
        name=None):
    """Greedy hard NMS (reference: vision/ops.py nms:1586).

    Returns kept box indices, best score first.  Eager returns the
    variable-length result like the reference; pass ``top_k`` for a
    static-size result (padded with -1).  ``category_idxs``/
    ``categories`` run class-aware NMS (boxes of different categories
    never suppress each other)."""
    b = _t(boxes).detach()
    n = b.shape[0]
    s = (_t(scores, b).detach() if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))

    if category_idxs is not None:
        # class-aware: offset boxes per category so cross-class IoU = 0
        # (the standard batched-NMS trick)
        ci = _t(category_idxs, b)
        if categories is not None:
            cats = set(int(v) for v in np.asarray(categories).reshape(-1))
            bad = set(int(v) for v in torch.unique(ci).tolist()) - cats
            if bad:
                raise ValueError(
                    f"category_idxs contains {sorted(bad)} not present "
                    f"in categories {sorted(cats)}")
        c = ci.to(b.dtype)
        span = b.max() - b.min() + 1.0
        b = b + (c * span)[:, None]

    order = torch.argsort(-s, stable=True)
    keep = _greedy_keep(b[order][None], torch.ones(1, n, dtype=torch.bool,
                                                   device=b.device),
                        iou_threshold)[0]
    if top_k is not None:
        # static result: rank kept entries first, pad with -1
        ar = torch.arange(n, device=b.device)
        rank = torch.where(keep, ar, n)
        srt, sel = torch.sort(rank, stable=True)
        idx = order[sel[:top_k]]
        valid = srt[:top_k] < n
        return wrap(torch.where(valid, idx, -1))
    return wrap(order[keep])


# ---------------------------------------------------------------------------
# detection zoo: fixed shapes, masked outputs instead of LoD
# ---------------------------------------------------------------------------

def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU matrix (reference: iou_similarity_op.cc)."""
    return box_iou(x, y)


def _clip_fn(b, im_info):
    # im_info rows: [h, w, scale]; boxes clipped to [0, dim - 1]
    h = im_info[..., 0:1] - 1.0
    w = im_info[..., 1:2] - 1.0
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_clip(input, im_info, name=None):
    """Clip [.., 4] xyxy boxes to image bounds (box_clip_op.cc).
    ``im_info``: [h, w, scale] (broadcast over leading dims)."""
    b = _t(input)
    return apply(_clip_fn, b, _t(im_info, b), op_name="box_clip")


def _bilinear_1d(coord, size):
    c = torch.clamp(coord, 0.0, size - 1.0)
    lo = torch.clamp(torch.floor(c).to(torch.int64), 0, size - 1)
    hi = torch.clamp(lo + 1, max=size - 1)
    frac = c - lo.to(c.dtype)
    # out-of-range samples contribute 0 (roi_align_op.h: skip when
    # y < -1 or y > height, clamp the [-1, 0) band to 0)
    valid = ((coord >= -1.0) & (coord <= size)).to(c.dtype)
    return lo, hi, frac, valid


def _axis_weights(coord, size, S):
    """[R, P, S] sample coordinates -> [R, P, size] weights: each
    sample's two bilinear taps, masked, averaged over its S samples."""
    lo, hi, frac, valid = _bilinear_1d(coord, size)
    R, P, _ = coord.shape
    w = torch.zeros(R, P, size, dtype=coord.dtype, device=coord.device)
    w = w.scatter_add(2, lo, (1.0 - frac) * valid / S)
    return w.scatter_add(2, hi, frac * valid / S)


def _roi_align_fn(x, boxes, batch_idx, *, output_size, spatial_scale,
                  sampling_ratio, aligned):
    R = boxes.shape[0]
    C, H, W = x.shape[1:]
    ph, pw = output_size
    S = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    b = boxes * spatial_scale
    x1 = b[:, 0] - off
    y1 = b[:, 1] - off
    roi_w = b[:, 2] - b[:, 0]
    roi_h = b[:, 3] - b[:, 1]
    if not aligned:                      # legacy: min size 1 (roi_align_op.h)
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / pw
    bin_h = roi_h / ph
    # sample grid: for output bin (i,j), S x S points at
    # y = y1 + (i + (sy + .5)/S) * bin_h   (roi_align_op.h bilinear loop)
    dev, dt = x.device, x.dtype
    sub = (torch.arange(S, device=dev, dtype=dt)[None, :] + 0.5) / S
    iy = torch.arange(ph, device=dev, dtype=dt)[:, None] + sub
    ix = torch.arange(pw, device=dev, dtype=dt)[:, None] + sub
    ys = y1[:, None, None] + iy[None] * bin_h[:, None, None]   # [R,ph,S]
    xs = x1[:, None, None] + ix[None] * bin_w[:, None, None]   # [R,pw,S]
    ay = _axis_weights(ys, H, S)                               # [R,ph,H]
    ax = _axis_weights(xs, W, S)                               # [R,pw,W]
    if R == 0:
        return x.new_zeros((0, C, ph, pw))
    parts = []
    for n in range(x.shape[0]):
        rows = (batch_idx == n).nonzero().flatten()
        if rows.numel() == 0:
            continue
        xn = x[n].permute(1, 0, 2).reshape(H, C * W)           # [H, C*W]
        for c0 in range(0, rows.numel(), _ROI_CHUNK):
            r = rows[c0:c0 + _ROI_CHUNK]
            k = r.numel()
            t = (ay[r].reshape(k * ph, H) @ xn).reshape(k, ph * C, W)
            o = torch.bmm(t, ax[r].transpose(1, 2))            # [k,ph*C,pw]
            parts.append((r, o.reshape(k, ph, C, pw).permute(0, 2, 1, 3)))
    order = torch.cat([r for r, _ in parts])
    vals = torch.cat([o for _, o in parts])
    return torch.empty_like(vals).index_copy(0, order, vals)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference: roi_align_op.cc / vision/ops.py roi_align).

    ``x``: [N, C, H, W]; ``boxes``: [R, 4] xyxy in input-image coords;
    ``boxes_num``: [N] rois per image.  Output [R, C, ph, pw].

    As in paddle_tpu, ``sampling_ratio=-1`` uses a fixed 2x2 sample grid
    per bin instead of the reference's per-RoI adaptive
    ``ceil(roi_size / pooled_size)``; pass an explicit
    ``sampling_ratio`` for the reference kernel's grid."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    xa = _t(x)
    ba = _t(boxes, xa)
    bn = _t(boxes_num, xa).to(torch.int64)
    # roi -> image index: searchsorted over the cumulative roi counts
    # (replaces the reference's LoD offsets, roi_align_op.cc:74)
    batch_idx = torch.searchsorted(
        torch.cumsum(bn, 0), torch.arange(ba.shape[0], device=xa.device),
        right=True)
    return apply(_roi_align_fn, xa, ba, batch_idx, op_name="roi_align",
                 attrs=dict(output_size=tuple(output_size),
                            spatial_scale=float(spatial_scale),
                            sampling_ratio=int(sampling_ratio),
                            aligned=bool(aligned)))


def _yolo_box_fn(x, img_size, *, anchors, class_num, conf_thresh,
                 downsample_ratio, clip_bbox, scale_x_y):
    n, c, h, w = x.shape
    an = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=x.dtype, device=x.device).reshape(an, 2)
    bias = -0.5 * (scale_x_y - 1.0)
    xv = x.reshape(n, an, class_num + 5, h, w)
    tx, ty, tw, th = xv[:, :, 0], xv[:, :, 1], xv[:, :, 2], xv[:, :, 3]
    obj = torch.sigmoid(xv[:, :, 4])                        # [n,an,h,w]
    cls = torch.sigmoid(xv[:, :, 5:])                       # [n,an,cls,h,w]
    img_h = img_size[:, 0].to(x.dtype)[:, None, None, None]
    img_w = img_size[:, 1].to(x.dtype)[:, None, None, None]
    in_h, in_w = downsample_ratio * h, downsample_ratio * w
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    cx = (gx + torch.sigmoid(tx) * scale_x_y + bias) * img_w / w
    cy = (gy + torch.sigmoid(ty) * scale_x_y + bias) * img_h / h
    bw = torch.exp(tw) * anc[None, :, 0, None, None] * img_w / in_w
    bh = torch.exp(th) * anc[None, :, 1, None, None] * img_h / in_h
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = torch.clamp(x1, min=0.0)
        y1 = torch.clamp(y1, min=0.0)
        x2 = torch.minimum(x2, img_w - 1.0)
        y2 = torch.minimum(y2, img_h - 1.0)
    keep = (obj >= conf_thresh).to(x.dtype)                 # [n,an,h,w]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    scores = obj[:, :, None] * cls * keep[:, :, None]       # [n,an,cls,h,w]
    # layout parity (yolo_box_op.h GetEntryIndex): anchor-major, then h, w
    boxes = boxes.reshape(n, an * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, an * h * w, class_num)
    return boxes, scores


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, name=None):
    """YOLOv3 box decode (reference: yolo_box_op.cc/.h).

    ``x``: [N, an*(5+classes), H, W]; ``img_size``: [N, 2] (h, w).
    Returns (boxes [N, an*H*W, 4] xyxy, scores [N, an*H*W, classes]);
    entries with objectness below ``conf_thresh`` are zeroed (the masked
    analog of the reference's sparse write into zeroed outputs)."""
    xa = _t(x)
    return apply(_yolo_box_fn, xa, _t(img_size, xa), op_name="yolo_box",
                 attrs=dict(anchors=tuple(int(a) for a in anchors),
                            class_num=int(class_num),
                            conf_thresh=float(conf_thresh),
                            downsample_ratio=int(downsample_ratio),
                            clip_bbox=bool(clip_bbox),
                            scale_x_y=float(scale_x_y)))


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes (reference: prior_box_op.cc/.h).

    Returns (boxes [H, W, P, 4] normalized xyxy, variances [H, W, P, 4])
    on ``input``'s device.  Built on the host (priors depend only on
    shapes and attributes, like the reference's CPU kernel)."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    # ExpandAspectRatios (prior_box_op.h:28): dedup, keep 1.0 first
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    min_sizes = [float(s) for s in np.atleast_1d(min_sizes)]
    max_sizes = ([float(s) for s in np.atleast_1d(max_sizes)]
                 if max_sizes is not None else [])
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    cx = (np.arange(fw) + offset) * step_w          # [fw]
    cy = (np.arange(fh) + offset) * step_h          # [fh]
    whs = []
    for s, mn in enumerate(min_sizes):
        variants = []
        if min_max_aspect_ratios_order:
            variants.append((mn / 2.0, mn / 2.0))
            if max_sizes:
                m = (mn * max_sizes[s]) ** 0.5 / 2.0
                variants.append((m, m))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                variants.append((mn * ar ** 0.5 / 2.0, mn / ar ** 0.5 / 2.0))
        else:
            for ar in ars:
                variants.append((mn * ar ** 0.5 / 2.0, mn / ar ** 0.5 / 2.0))
            if max_sizes:
                m = (mn * max_sizes[s]) ** 0.5 / 2.0
                variants.append((m, m))
        whs.extend(variants)
    whs_np = np.asarray(whs, np.float32)            # [P, 2] half sizes
    P = whs_np.shape[0]
    gx = np.broadcast_to(cx[None, :, None], (fh, fw, P))
    gy = np.broadcast_to(cy[:, None, None], (fh, fw, P))
    hw = np.broadcast_to(whs_np[None, None, :, 0], (fh, fw, P))
    hh = np.broadcast_to(whs_np[None, None, :, 1], (fh, fw, P))
    boxes = np.stack([(gx - hw) / iw, (gy - hh) / ih,
                      (gx + hw) / iw, (gy + hh) / ih], axis=-1)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          (fh, fw, P, 4)).copy()
    dev = input.device if isinstance(input, torch.Tensor) else None
    return (wrap(torch.as_tensor(boxes.astype(np.float32), device=dev)),
            wrap(torch.as_tensor(var, device=dev)))


def _encode_center(t, p, pv, normalized):
    norm = 0.0 if normalized else 1.0
    pw = p[:, 2] - p[:, 0] + norm
    ph = p[:, 3] - p[:, 1] + norm
    px = p[:, 0] + pw * 0.5
    py = p[:, 1] + ph * 0.5
    tw = t[:, 2] - t[:, 0] + norm
    th = t[:, 3] - t[:, 1] + norm
    tx = t[:, 0] + tw * 0.5
    ty = t[:, 1] + th * 0.5
    out = torch.stack([
        (tx[:, None] - px[None]) / pw[None],
        (ty[:, None] - py[None]) / ph[None],
        torch.log(tw[:, None] / pw[None]),
        torch.log(th[:, None] / ph[None])], dim=-1)     # [N, M, 4]
    if pv is not None:
        out = out / pv[None]
    return out


def _decode_center(t, p, pv, normalized, axis):
    norm = 0.0 if normalized else 1.0
    pw = p[:, 2] - p[:, 0] + norm
    ph = p[:, 3] - p[:, 1] + norm
    px = p[:, 0] + pw * 0.5
    py = p[:, 1] + ph * 0.5
    # box_coder_op.h DecodeCenterSize: axis==0 indexes priors by the
    # COLUMN (dim 1) of the [N, M, 4] codes; axis==1 by the row
    ex = (slice(None), None) if axis == 1 else (None, slice(None))
    pw, ph, px, py = (a[ex] for a in (pw, ph, px, py))
    v = (pv[ex + (slice(None),)] if pv is not None
         else torch.ones(4, dtype=t.dtype, device=t.device))
    ox = v[..., 0] * t[..., 0] * pw + px
    oy = v[..., 1] * t[..., 1] * ph + py
    ow = torch.exp(v[..., 2] * t[..., 2]) * pw
    oh = torch.exp(v[..., 3] * t[..., 3]) * ph
    return torch.stack([ox - ow / 2 + norm * 0.5, oy - oh / 2 + norm * 0.5,
                        ox + ow / 2 - norm * 0.5, oy + oh / 2 - norm * 0.5],
                       dim=-1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode/decode boxes against priors (reference: box_coder_op.cc/.h).

    encode: target [N, 4], priors [M, 4] -> [N, M, 4] offsets.
    decode: target [N, M, 4] codes -> [N, M, 4] xyxy boxes (``axis``
    selects which dim the priors broadcast over, as in the reference)."""
    p = _t(prior_box)
    args = [p, _t(target_box, p)]
    if prior_box_var is not None:
        args.append(_t(prior_box_var, p, dtype=torch.float32))

    def fn(p, t, *rest):
        v = rest[0] if rest else None
        if v is not None and v.ndim == 1:
            v = torch.broadcast_to(v, p.shape)
        if code_type == "encode_center_size":
            return _encode_center(t, p, v, box_normalized)
        return _decode_center(t, p, v, box_normalized, axis)

    return apply(fn, *args, op_name="box_coder")


def _class_keep(bboxes, scores, *, score_threshold, nms_top_k,
                nms_threshold, nms_eta, keep_top_k, background_label):
    """paddle_tpu's per-class stage (multiclass_nms_op.cc NMSFast) over
    every (image, class) row at once -> kept scores [N, C, M], exact
    where an image's ``keep_top_k`` best can be (the sweep stops once
    each image's top k is among the candidates swept)."""
    N, C, M = scores.shape
    sc = torch.where(scores > score_threshold, scores,
                     torch.zeros((), dtype=scores.dtype,
                                 device=scores.device))
    if 0 < nms_top_k < M:
        top = torch.sort(sc, dim=-1, descending=True).values[
            ..., nms_top_k - 1:nms_top_k]
        sc = torch.where(sc >= torch.clamp(top, min=1e-38), sc,
                         torch.zeros((), dtype=sc.dtype, device=sc.device))
    # stable, so equal scores keep index order as jnp.argsort(-sc) does
    order = torch.argsort(-sc, dim=-1, stable=True)           # [N, C, M]
    # the sweep ends at the longest row's positive count: a zero score is
    # never kept, never suppresses and never moves the threshold
    k = int((sc > 0).sum(-1).max()) if sc.numel() else 0
    kept = torch.zeros_like(sc)
    if k == 0:
        return kept
    cand = order[..., :k]                                     # [N, C, k]
    csc = torch.gather(sc, 2, cand)
    cbox = torch.gather(bboxes[:, None].expand(N, C, M, 4), 2,
                        cand[..., None].expand(N, C, k, 4))
    counted = csc
    if background_label >= 0:         # its scores are zeroed afterwards
        counted = csc.clone()
        counted[:, background_label] = 0.0

    def settled(c, keep):
        # each image has keep_top_k kept candidates scoring above the
        # best one left in any of its rows: no later candidate can enter
        # its top k, ties included
        front = counted[:, :, c].amax(1)[:, None, None]
        above = (keep.reshape(N, C, c) & (counted[:, :, :c] > front))
        return bool((above.sum((1, 2)) >= keep_top_k).all())

    keep = _greedy_keep(cbox.reshape(N * C, k, 4),
                        (csc > 0).reshape(N * C, k), nms_threshold,
                        nms_eta, settled if keep_top_k > 0 else None
                        ).reshape(N, C, k)
    return kept.scatter(2, cand, torch.where(keep, csc, 0.0))


def _multiclass_nms_fn(bboxes, scores, *, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold, normalized, nms_eta,
                       background_label):
    N, M, _ = bboxes.shape
    C = scores.shape[1]
    kept = _class_keep(bboxes, scores, score_threshold=score_threshold,
                       nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                       nms_eta=nms_eta, keep_top_k=keep_top_k,
                       background_label=background_label)    # [N, C, M]
    if background_label >= 0:
        kept[:, background_label] = 0.0
    flat = kept.reshape(N, C * M)
    K = keep_top_k if keep_top_k > 0 else flat.shape[1]
    K = min(K, flat.shape[1])
    # lax.top_k's order: score descending, equal scores by index
    srt = torch.sort(flat, dim=1, descending=True, stable=True)
    top_sc, top_ix = srt.values[:, :K], srt.indices[:, :K]
    label = (top_ix // M).to(torch.float32)
    box = torch.gather(bboxes, 1, (top_ix % M)[..., None].expand(N, K, 4))
    valid = top_sc > 0.0
    out = torch.cat([torch.where(valid, label, -1.0)[..., None],
                     top_sc[..., None], box], dim=2)
    index = torch.where(valid, top_ix % M, -1)
    return out, index, valid.sum(1).to(torch.int32)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=-1, name=None):
    """Multi-class NMS (reference: multiclass_nms_op.cc).

    ``bboxes`` [N, M, 4], ``scores`` [N, C, M].  Returns
    (out [N, K, 6] rows ``[label, score, x1, y1, x2, y2]``,
    index [N, K] box indices (int64), nms_num [N]) where K =
    keep_top_k; invalid rows carry label/index -1 (the masked
    fixed-shape form of the reference's LoD output)."""
    b = _t(bboxes).detach()
    with torch.no_grad():
        return apply(_multiclass_nms_fn, b, _t(scores, b).detach(),
                     op_name="multiclass_nms",
                     attrs=dict(score_threshold=float(score_threshold),
                                nms_top_k=int(nms_top_k),
                                keep_top_k=int(keep_top_k),
                                nms_threshold=float(nms_threshold),
                                normalized=bool(normalized),
                                nms_eta=float(nms_eta),
                                background_label=int(background_label)))
