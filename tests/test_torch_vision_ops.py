"""``vision.ops`` held to paddle_tpu's on the CPU: the cases of
``tests/test_vision_ops.py`` and the vision-op and detection-head cases
of ``tests/test_detection_sequence.py``, each run on both packages from
the same seeded numpy inputs.

Tolerances: IoU, the detection zoo and ``roi_align`` within ``ATOL``
(the same float32 formulas; ``roi_align``'s two products sum in another
order than paddle_tpu's gathers); NMS results (indices, kept scores,
labels, boxes) exactly.  The numpy oracles keep their files' bounds.

Kept difference: eager ``nms`` and ``multiclass_nms``'s ``index`` are
int64 (paddle_tpu's are int32 without x64)."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.vision import ops as JV

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.vision import ops as TV

ATOL = 1e-5
SIDES = {"jax": (jpaddle, JV), "torch": (tpaddle, TV)}


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


def _np(t):
    return np.asarray(t.numpy())


def _both(fn):
    """``fn(paddle, ops)`` on each package -> {side: result}."""
    return {k: fn(*v) for k, v in SIDES.items()}


def _jax(fn, *arrays):
    """``fn(ops, *tensors)`` on paddle_tpu under one ``jax.jit`` (one
    compile where the eager ops compile each primitive) -> numpy
    array(s)."""
    import jax
    from paddle_tpu.core.tensor import Tensor as JT

    def run(*a):
        out = fn(JV, *[JT(x) for x in a])
        return ([t.data for t in out] if isinstance(out, (tuple, list))
                else out.data)

    out = jax.jit(run)(*arrays)
    return ([np.asarray(o) for o in out] if isinstance(out, list)
            else np.asarray(out))


def _naive_nms(boxes, scores, thr):
    order = np.argsort(-scores, kind="stable")
    keep, suppressed = [], np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order:
            if j == i or suppressed[j]:
                continue
            xa1, ya1, xa2, ya2 = boxes[i]
            xb1, yb1, xb2, yb2 = boxes[j]
            iw = max(0, min(xa2, xb2) - max(xa1, xb1))
            ih = max(0, min(ya2, yb2) - max(ya1, yb1))
            inter = iw * ih
            ua = ((xa2 - xa1) * (ya2 - ya1) + (xb2 - xb1) * (yb2 - yb1)
                  - inter)
            if inter / max(ua, 1e-9) > thr:
                suppressed[j] = True
    return keep


def _rand_boxes(r, *lead, span=10.0, size=4.0):
    xy = r.rand(*lead, 2) * span
    wh = r.rand(*lead, 2) * size + 0.5
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# -- IoU and the elementwise zoo ------------------------------------------

def test_box_iou_known_values():
    a = np.array([[0, 0, 2, 2]], np.float32)
    b = np.array([[1, 1, 3, 3], [0, 0, 2, 2], [5, 5, 6, 6]], np.float32)
    got = _both(lambda P, V: _np(V.box_iou(P.to_tensor(a), P.to_tensor(b))))
    np.testing.assert_allclose(got["torch"][0], [1 / 7, 1.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(got["torch"], got["jax"], atol=ATOL)


@pytest.mark.parametrize("op", ["box_iou", "iou_similarity", "box_area"])
def test_iou_and_area_match_paddle_tpu(op):
    r = np.random.RandomState(10)
    a, b = _rand_boxes(r, 7), _rand_boxes(r, 5)
    args = (a,) if op == "box_area" else (a, b)
    got = _np(getattr(TV, op)(*[tpaddle.to_tensor(v) for v in args]))
    want = _jax(lambda V, *t: getattr(V, op)(*t), *args)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_box_clip():
    b = np.array([[[-5.0, -5.0, 50.0, 20.0], [3.0, 4.0, 9.0, 8.0]]],
                 np.float32)
    im = np.array([[16.0, 32.0, 1.0]], np.float32)
    got = _both(lambda P, V: _np(V.box_clip(P.to_tensor(b),
                                            P.to_tensor(im))))
    np.testing.assert_allclose(got["torch"][0, 0], [0, 0, 31, 15])
    np.testing.assert_array_equal(got["torch"], got["jax"])


def _yolo_box_np(x, img_size, anchors, class_num, conf_thresh, ds, clip,
                 scale):
    n, c, h, w = x.shape
    an = len(anchors) // 2
    bias = -0.5 * (scale - 1.0)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    boxes = np.zeros((n, an * h * w, 4))
    scores = np.zeros((n, an * h * w, class_num))
    xv = x.reshape(n, an, class_num + 5, h, w)
    for b in range(n):
        ih, iw = img_size[b]
        for a in range(an):
            for i in range(h):
                for j in range(w):
                    conf = sig(xv[b, a, 4, i, j])
                    k = a * h * w + i * w + j
                    if conf < conf_thresh:
                        continue
                    cx = (j + sig(xv[b, a, 0, i, j]) * scale + bias) * iw / w
                    cy = (i + sig(xv[b, a, 1, i, j]) * scale + bias) * ih / h
                    bw = np.exp(xv[b, a, 2, i, j]) * anchors[2 * a] * iw / (
                        ds * w)
                    bh = np.exp(xv[b, a, 3, i, j]) * anchors[2 * a + 1] * \
                        ih / (ds * h)
                    box = [cx - bw / 2, cy - bh / 2, cx + bw / 2,
                           cy + bh / 2]
                    if clip:
                        box = [max(box[0], 0), max(box[1], 0),
                               min(box[2], iw - 1), min(box[3], ih - 1)]
                    boxes[b, k] = box
                    scores[b, k] = conf * sig(xv[b, a, 5:, i, j])
    return boxes, scores


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.2)])
def test_yolo_box_matches_oracle_and_paddle_tpu(clip, scale):
    r = np.random.RandomState(3)
    anchors = [10, 13, 16, 30]
    class_num = 3
    x = r.randn(2, 2 * (5 + class_num), 4, 4).astype(np.float32)
    img = np.array([[64, 96], [32, 32]], np.int32)
    args = (anchors, class_num, 0.3, 8)
    kw = dict(clip_bbox=clip, scale_x_y=scale)
    got = [_np(t) for t in TV.yolo_box(tpaddle.to_tensor(x),
                                       tpaddle.to_tensor(img), *args, **kw)]
    want = _jax(lambda V, x, i: V.yolo_box(x, i, *args, **kw), x, img)
    be, se = _yolo_box_np(x, img, anchors, class_num, 0.3, 8, clip, scale)
    np.testing.assert_allclose(got[0], be, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], se, rtol=1e-4, atol=1e-5)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("order", [False, True])
def test_prior_box_reference_semantics(order):
    feat = np.zeros((1, 8, 4, 4), np.float32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    got = _both(lambda P, V: [_np(t) for t in V.prior_box(
        P.to_tensor(feat), P.to_tensor(img), min_sizes=[8.0],
        max_sizes=[16.0], aspect_ratios=[2.0], flip=True, clip=True,
        min_max_aspect_ratios_order=order)])
    b, v = got["torch"]
    assert b.shape == (4, 4, 4, 4) and v.shape == (4, 4, 4, 4)
    if not order:
        np.testing.assert_allclose(b[0, 0, 0], [0, 0, 0.25, 0.25],
                                   atol=1e-6)
        w2, h2 = 8 * np.sqrt(2) / 2, 8 / np.sqrt(2) / 2
        np.testing.assert_allclose(
            b[0, 0, 1], np.clip([(4 - w2) / 32, (4 - h2) / 32,
                                 (4 + w2) / 32, (4 + h2) / 32], 0, 1),
            atol=1e-6)
        m = np.sqrt(8 * 16.0) / 2
        np.testing.assert_allclose(
            b[0, 0, 3], np.clip([(4 - m) / 32] * 2 + [(4 + m) / 32] * 2,
                                0, 1), atol=1e-6)
    np.testing.assert_allclose(v[0, 0, 0], [0.1, 0.1, 0.2, 0.2])
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_decode_matches_paddle_tpu(normalized):
    r = np.random.RandomState(4)
    priors = np.abs(r.rand(5, 4)).astype(np.float32)
    priors[:, 2:] = priors[:, :2] + 0.5 + priors[:, 2:]
    targets = np.abs(r.rand(3, 4)).astype(np.float32)
    targets[:, 2:] = targets[:, :2] + 0.4 + targets[:, 2:]
    pv = np.array([0.1, 0.1, 0.2, 0.2], np.float32)

    def run(V, priors, targets):
        enc = V.box_coder(priors, pv, targets,
                          code_type="encode_center_size",
                          box_normalized=normalized)
        dec0 = V.box_coder(priors, pv, enc, code_type="decode_center_size",
                           box_normalized=normalized, axis=0)
        dec1 = V.box_coder(priors[:3], None, enc,
                           code_type="decode_center_size",
                           box_normalized=normalized, axis=1)
        return [enc, dec0, dec1]

    got = {"torch": [_np(t) for t in run(TV, tpaddle.to_tensor(priors),
                                         tpaddle.to_tensor(targets))],
           "jax": _jax(run, priors, targets)}
    assert got["torch"][0].shape == (3, 5, 4)
    if normalized:      # decoding the encoding recovers the targets
        exp = np.broadcast_to(targets[:, None, :], (3, 5, 4))
        np.testing.assert_allclose(got["torch"][1], exp, rtol=1e-4,
                                   atol=1e-4)
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=ATOL)


# -- roi_align ------------------------------------------------------------

def _roi_align_np(x, boxes, batch_idx, ph, pw, scale, ratio, aligned):
    R = boxes.shape[0]
    N, C, H, W = x.shape
    out = np.zeros((R, C, ph, pw), np.float64)
    off = 0.5 if aligned else 0.0
    for r in range(R):
        b = boxes[r] * scale
        x1, y1 = b[0] - off, b[1] - off
        rw, rh = b[2] - b[0], b[3] - b[1]
        if not aligned:
            rw, rh = max(rw, 1.0), max(rh, 1.0)
        bw, bh = rw / pw, rh / ph
        S = ratio if ratio > 0 else 2
        for i in range(ph):
            for j in range(pw):
                acc = np.zeros(C)
                for sy in range(S):
                    for sx in range(S):
                        y = y1 + (i + (sy + 0.5) / S) * bh
                        xx = x1 + (j + (sx + 0.5) / S) * bw
                        if y < -1.0 or y > H or xx < -1.0 or xx > W:
                            continue
                        y = min(max(y, 0.0), H - 1)
                        xx = min(max(xx, 0.0), W - 1)
                        y0, x0 = int(np.floor(y)), int(np.floor(xx))
                        y1_, x1_ = min(y0 + 1, H - 1), min(x0 + 1, W - 1)
                        fy, fx = y - y0, xx - x0
                        v = (x[batch_idx[r], :, y0, x0] * (1 - fy) * (1 - fx)
                             + x[batch_idx[r], :, y0, x1_] * (1 - fy) * fx
                             + x[batch_idx[r], :, y1_, x0] * fy * (1 - fx)
                             + x[batch_idx[r], :, y1_, x1_] * fy * fx)
                        acc += v
                out[r, :, i, j] = acc / (S * S)
    return out


@pytest.mark.parametrize("ratio", [2, 1, -1])
@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_matches_oracle_and_paddle_tpu(ratio, aligned):
    r = np.random.RandomState(0)
    x = r.randn(2, 3, 8, 8).astype(np.float32)
    # the last box reaches past the map: samples beyond -1 / size count 0
    boxes = np.array([[0.5, 0.5, 6.0, 6.0], [1.0, 2.0, 7.5, 7.0],
                      [0.0, 0.0, 4.0, 3.0], [-4.0, 10.0, 19.0, 21.0]],
                     np.float32)
    boxes_num = np.array([2, 2], np.int32)
    kw = dict(spatial_scale=0.5, sampling_ratio=ratio, aligned=aligned)
    got = _np(TV.roi_align(tpaddle.to_tensor(x), tpaddle.to_tensor(boxes),
                           tpaddle.to_tensor(boxes_num), (4, 3), **kw))
    exp = _roi_align_np(x, boxes, [0, 0, 1, 1], 4, 3, 0.5, ratio, aligned)
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)
    want = _jax(lambda V, *t: V.roi_align(*t, (4, 3), **kw), x, boxes,
                boxes_num)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_roi_align_grad_finite_difference_and_paddle_tpu():
    """d/dx of sum(roi_align(x)^2): torch's autograd against central
    differences (the JAX file's bound) and against ``jax.grad`` of
    paddle_tpu's (whose eager ``roi_align`` takes ``x`` off the tape)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Tensor as JT
    r = np.random.RandomState(1)
    x = r.randn(1, 2, 6, 6).astype(np.float32)
    boxes = np.array([[1.0, 1.0, 5.0, 4.0]], np.float32)
    bn = np.array([1], np.int32)

    def f(xa, grad=False):
        xt = tpaddle.to_tensor(xa, stop_gradient=not grad)
        o = TV.roi_align(xt, tpaddle.to_tensor(boxes),
                         tpaddle.to_tensor(bn), 2, sampling_ratio=2)
        loss = (o * o).sum()
        if grad:
            loss.backward()
            return _np(xt.grad)
        return float(loss)

    g = f(x, grad=True)
    eps = 1e-3
    for idx in [(0, 0, 2, 2), (0, 1, 3, 4)]:
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        fd = (f(xp) - f(xm)) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), fd, rtol=2e-2, atol=1e-3)
    jg = jax.jit(jax.grad(lambda xa: (JV.roi_align(
        JT(xa), JT(jnp.asarray(boxes)), JT(jnp.asarray(bn)), 2,
        sampling_ratio=2).data ** 2).sum()))(jnp.asarray(x))
    np.testing.assert_allclose(g, np.asarray(jg), atol=ATOL)


def test_roi_align_many_rois_cross_chunks(monkeypatch):
    """RoIs of several images, more than one product chunk an image,
    in an interleaved order: every row lands at its own index."""
    monkeypatch.setattr(TV, "_ROI_CHUNK", 3)
    r = np.random.RandomState(11)
    x = r.randn(3, 2, 9, 7).astype(np.float32)
    boxes = _rand_boxes(r, 11, span=5.0, size=3.0)
    bn = np.array([4, 0, 7], np.int32)
    got = _np(TV.roi_align(tpaddle.to_tensor(x), tpaddle.to_tensor(boxes),
                           tpaddle.to_tensor(bn), 2, sampling_ratio=2))
    want = _jax(lambda V, *t: V.roi_align(*t, 2, sampling_ratio=2), x,
                boxes, bn)
    np.testing.assert_allclose(got, want, atol=ATOL)


# -- NMS ------------------------------------------------------------------

def test_nms_matches_naive_oracle_and_paddle_tpu():
    rng = np.random.RandomState(0)
    for _ in range(5):
        boxes = _rand_boxes(rng, 40)
        scores = rng.rand(40).astype(np.float32)
        want = _naive_nms(boxes, scores, 0.4)
        got = _np(TV.nms(tpaddle.to_tensor(boxes), 0.4,
                         tpaddle.to_tensor(scores))).tolist()
        # paddle_tpu's static-size form (kept first, -1 after), one jit
        jax = [int(k) for k in _jax(lambda V, b, s: V.nms(
            b, 0.4, s, top_k=40), boxes, scores) if k >= 0]
        assert got == want == jax, (got, jax)


def test_nms_indices_are_int64_and_default_order_is_input_order():
    import torch
    boxes = np.array([[0, 0, 2, 2], [0, 0, 2.1, 2.1], [5, 5, 7, 7]],
                     np.float32)
    got = _both(lambda P, V: V.nms(P.to_tensor(boxes), 0.5))
    assert got["torch"].dtype == torch.int64
    assert _np(got["torch"]).tolist() == _np(got["jax"]).tolist() == [0, 2]


def test_nms_static_topk():
    boxes = np.array([[0, 0, 2, 2], [0, 0, 2.1, 2.1], [5, 5, 7, 7]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got = _both(lambda P, V: _np(V.nms(
        P.to_tensor(boxes), 0.5, P.to_tensor(scores), top_k=3)).tolist())
    assert got["torch"] == got["jax"] == [0, 2, -1]


def test_nms_class_aware():
    boxes = np.array([[0, 0, 2, 2], [0, 0, 2, 2]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    cats = np.array([0, 1])
    got = _both(lambda P, V: _np(V.nms(
        P.to_tensor(boxes), 0.5, P.to_tensor(scores),
        category_idxs=P.to_tensor(cats), categories=[0, 1])).tolist())
    assert got["torch"] == got["jax"] == [0, 1]
    for P, V in SIDES.values():
        with pytest.raises(ValueError, match="not present"):
            V.nms(P.to_tensor(boxes), 0.5, P.to_tensor(scores),
                  category_idxs=P.to_tensor(np.array([0, 3])),
                  categories=[0, 1])


def _mc(boxes, scores, **kw):
    """multiclass_nms on both packages (paddle_tpu's under jit)."""
    return {"torch": [_np(t) for t in TV.multiclass_nms(
                tpaddle.to_tensor(boxes), tpaddle.to_tensor(scores), **kw)],
            "jax": _jax(lambda V, b, s: V.multiclass_nms(b, s, **kw),
                        boxes, scores)}


def test_multiclass_nms_basic():
    boxes = np.array([[[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                       [0, 0, 9, 9]]], np.float32)
    scores = np.zeros((1, 2, 4), np.float32)
    scores[0, 0] = [0.9, 0.8, 0.7, 0.05]   # class 0
    scores[0, 1] = [0.0, 0.0, 0.95, 0.0]   # class 1
    got = _mc(boxes, scores, score_threshold=0.1, nms_top_k=4,
              keep_top_k=5, nms_threshold=0.5)
    o, ix, nm = got["torch"]
    assert nm[0] == 3  # box1 suppressed by box0 in class 0
    valid = o[0][o[0, :, 0] >= 0]
    np.testing.assert_allclose(valid[:, 1], [0.95, 0.9, 0.7], atol=1e-6)
    np.testing.assert_allclose(valid[:, 0], [1, 0, 0])
    np.testing.assert_allclose(valid[0, 2:], [50, 50, 60, 60])
    assert ix[0, 0] == 2
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.2, keep_top_k=4, background_label=0),
    dict(score_threshold=0.05, nms_top_k=9, keep_top_k=30,
         nms_threshold=0.45),
    dict(score_threshold=0.01, nms_top_k=-1, keep_top_k=-1,
         nms_threshold=0.6, nms_eta=0.8),
], ids=["background", "topk", "eta"])
def test_multiclass_nms_matches_paddle_tpu(kw):
    r = np.random.RandomState(5)
    boxes = np.abs(r.rand(2, 24, 4)).astype(np.float32) * 20
    boxes[..., 2:] += boxes[..., :2] + 5
    scores = r.rand(2, 3, 24).astype(np.float32)
    got = _mc(boxes, scores, **kw)
    if kw.get("background_label") == 0:
        assert not np.any(got["torch"][0][:, :, 0] == 0)
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("eta,background", [(1.0, -1), (0.8, 0)])
def test_multiclass_nms_early_stop_is_exact(monkeypatch, eta, background):
    """The sweep stops once each image's keep_top_k best are settled
    (blocks of 8 here, so it stops after a few): the output equals
    paddle_tpu's full sweep, with ties at the stopping score (scores on
    a 0.05 grid) and a high-scoring background class that must not
    count."""
    monkeypatch.setattr(TV, "_NMS_BLOCK", 8)
    r = np.random.RandomState(13)
    boxes = _rand_boxes(r, 2, 120, span=40.0, size=12.0)
    scores = np.round(r.rand(2, 4, 120) * 20) / 20
    scores[:, 0] += 0.5
    got = _mc(boxes, scores.astype(np.float32), score_threshold=0.05,
              nms_top_k=90, keep_top_k=6, nms_threshold=0.3, nms_eta=eta,
              background_label=background)
    assert got["torch"][2].tolist() == [6, 6]
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)


def test_multiclass_nms_tie_rule_at_the_kth_score():
    """paddle_tpu keeps every score >= the k-th (``sc >= top``), so a tie
    at the cut keeps more than ``nms_top_k`` candidates, and equal
    scores go in index order; the sweep over positive counts keeps it."""
    boxes = np.array([[[10 * i, 0, 10 * i + 8, 8] for i in range(8)]],
                     np.float32)                   # disjoint: none suppress
    scores = np.zeros((1, 2, 8), np.float32)
    scores[0, 0] = [0.9, 0.5, 0.5, 0.3, 0.5, 0.5, 0.2, 0.8]
    scores[0, 1] = [0.4, 0.4, 0.4, 0.4, 0.1, 0.0, 0.0, 0.0]
    got = _mc(boxes, scores, score_threshold=0.05, nms_top_k=3,
              keep_top_k=-1, nms_threshold=0.5)
    out, index, num = got["torch"]
    # class 0: top-3 cut is 0.5, tied four ways -> 0.9, 0.8 and four 0.5s
    # class 1: cut 0.4, tied four ways -> four 0.4s
    assert num[0] == 10
    valid = out[0][out[0, :, 0] >= 0]
    np.testing.assert_allclose(valid[:, 1], [0.9, 0.8] + [0.5] * 4
                               + [0.4] * 4)
    assert index[0, :10].tolist() == [0, 7, 1, 2, 4, 5, 0, 1, 2, 3]
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)


# -- end-to-end detection heads -------------------------------------------

def test_ssd_style_head_end_to_end():
    """prior_box -> head codes -> box_coder decode -> multiclass_nms (the
    reference SSD eval graph): the port's eagerly, paddle_tpu's inside
    one jit, as its file runs it."""
    feat = np.zeros((1, 8, 4, 4), np.float32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    priors = {}
    for k, (P, V) in SIDES.items():
        pb, pv = V.prior_box(P.to_tensor(feat), P.to_tensor(img),
                             min_sizes=[8.0], aspect_ratios=[2.0], flip=True)
        priors[k] = (_np(pb).reshape(-1, 4), _np(pv).reshape(-1, 4))
    np.testing.assert_array_equal(priors["torch"][0], priors["jax"][0])
    pri, var = priors["torch"]
    rr = np.random.RandomState(6)
    codes = (rr.randn(1, pri.shape[0], 4) * 0.1).astype(np.float32)
    logits = rr.randn(1, 3, pri.shape[0]).astype(np.float32)

    def head(P, V, pri, var, codes, logits):
        dec = V.box_coder(pri, var, codes, code_type="decode_center_size",
                          axis=0)
        sc = P.nn.functional.softmax(logits, axis=1)
        return V.multiclass_nms(dec, sc, score_threshold=0.01,
                                keep_top_k=10, background_label=0)

    t = [tpaddle.to_tensor(a) for a in (pri, var, codes, logits)]
    got = [_np(o) for o in head(tpaddle, TV, *t)]
    want = _jax(lambda V, *a: head(jpaddle, V, *a), pri, var, codes, logits)
    out, _, num = got
    assert out.shape == (1, 10, 6) and int(num[0]) > 0
    valid = out[0][out[0, :, 0] >= 0]
    assert np.all(valid[:, 1] > 0.0) and np.all(valid[:, 0] >= 1)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


def test_yolo_head_end_to_end():
    """yolo_box -> the best class score -> static-size nms: the port's
    eagerly, paddle_tpu's inside one jit."""
    r = np.random.RandomState(7)
    anchors = [10, 13, 16, 30]
    x = r.randn(1, 2 * 7, 4, 4).astype(np.float32)
    img = np.array([[64, 64]], np.int32)
    boxes, scores = TV.yolo_box(tpaddle.to_tensor(x), tpaddle.to_tensor(img),
                                anchors, 2, 0.1, 16)
    got = _np(TV.nms(boxes[0], 0.5, scores.max(axis=-1)[0],
                     top_k=8)).tolist()

    def head(V, x, img):
        from paddle_tpu.core.tensor import Tensor as JT
        b, s = V.yolo_box(x, img, anchors, 2, 0.1, 16)
        return V.nms(JT(b.data[0]), 0.5, JT(s.data.max(axis=-1)[0]),
                     top_k=8)

    want = _jax(head, x, img).tolist()
    assert len(got) == 8 and sum(k >= 0 for k in got) > 0
    assert got == want
