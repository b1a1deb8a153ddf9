"""Cases for the rest of ``nn`` and ``nn.functional``, shared by the CPU
parity tests (the port against paddle_tpu, ``tests/test_torch_nn_tail.py``)
and ``chip_smoke.py``'s card-against-CPU phase.

A function case is ``(name, fn(pkg, *tensors) -> tensor, inputs,
grad)``: ``pkg`` is a package with paddle's API (paddle_tpu or the
port), ``inputs`` numpy arrays made from a seed, ``grad`` the indices of
the inputs that take a gradient.  A layer case is ``(name, make(nn) ->
layer, inputs, grad)``.  Numpy only: nothing here imports either
package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["INTERPOLATE", "function_cases", "layer_cases", "ctc_inputs"]


def _f32(rs, *shape, lo=None, hi=None):
    if lo is None:
        return rs.randn(*shape).astype(np.float32)
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _F(pkg):
    return pkg.nn.functional


def ctc_inputs():
    """``[T, B, C]`` logits, ``[B, L]`` padded labels, input and label
    lengths."""
    rs = np.random.RandomState(1)
    return [_f32(rs, 12, 3, 6), rs.randint(1, 6, (3, 4)).astype(np.int64),
            np.array([12, 10, 9], np.int64), np.array([4, 2, 3], np.int64)]


# name, input shape, interpolate's keyword arguments
INTERPOLATE = [
    ("nearest-up", (2, 3, 4, 5), dict(scale_factor=2, mode="nearest")),
    ("nearest-down", (2, 3, 9, 10), dict(size=[4, 3], mode="nearest")),
    ("bilinear-up", (2, 3, 4, 5), dict(size=[7, 9], mode="bilinear")),
    ("bilinear-down", (2, 3, 12, 10), dict(size=[5, 4], mode="bilinear")),
    ("bilinear-align_corners-ignored", (1, 2, 4, 5),
     dict(size=[7, 9], mode="bilinear", align_corners=True)),
    ("bicubic-up", (1, 2, 5, 4), dict(size=[9, 11], mode="bicubic")),
    ("bicubic-down", (1, 2, 11, 9), dict(size=[4, 5], mode="bicubic")),
    ("area-down", (1, 2, 8, 8), dict(size=[3, 3], mode="area")),
    ("linear-1d", (2, 3, 7), dict(size=[12], mode="linear",
                                  data_format="NCW")),
    ("trilinear-3d", (1, 2, 4, 3, 5), dict(size=[6, 2, 7], mode="trilinear",
                                           data_format="NCDHW")),
    ("bilinear-nhwc", (2, 4, 5, 3), dict(size=[7, 3], mode="bilinear",
                                         data_format="NHWC")),
]


def _in_place(name, *args):
    def run(pkg, t):
        y = t * 1.0
        getattr(_F(pkg), name)(y, *args)
        return y
    return run


def function_cases():
    rs = np.random.RandomState(0)
    x, y = _f32(rs, 6, 5), _f32(rs, 6, 5)
    logp = np.log(np.exp(x) / np.exp(x).sum(-1, keepdims=True)).astype(
        np.float32)
    t = np.exp(y) / np.exp(y).sum(-1, keepdims=True)
    t = t.astype(np.float32)
    pm = np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    prob = _f32(rs, 6, 5, lo=0.05, hi=0.95)
    bits = (rs.rand(6, 5) > 0.5).astype(np.float32)
    seg = rs.randint(0, 4, (3, 5, 1)).astype(np.int64)
    seg_p = np.exp(_f32(rs, 3, 5, 4))
    seg_p = (seg_p / seg_p.sum(-1, keepdims=True)).astype(np.float32)
    x4 = _f32(rs, 2, 8, 5, 6)
    F = _F
    cases = [("kl_div-" + r, lambda p, a, b, r=r: F(p).kl_div(a, b, r),
              [logp, t], (0, 1))
             for r in ("mean", "batchmean", "sum", "none")]
    cases += [
        ("margin_ranking_loss", lambda p, a, b, c: F(p).margin_ranking_loss(
            a, b, c, margin=0.3), [x[:, 0], y[:, 0], pm], (0, 1)),
        ("hinge_embedding_loss", lambda p, a, c: F(p).hinge_embedding_loss(
            a, c, margin=0.8, reduction="sum"), [x[:, 0], pm], (0,)),
        ("cosine_embedding_loss", lambda p, a, b, c:
         F(p).cosine_embedding_loss(a, b, c, margin=0.1), [x, y, pm],
         (0, 1)),
        ("sigmoid_focal_loss", lambda p, a, b: F(p).sigmoid_focal_loss(a, b),
         [x, bits], (0,)),
        ("sigmoid_focal_loss-normalizer", lambda p, a, b, n:
         F(p).sigmoid_focal_loss(a, b, n, reduction="mean"),
         [x, bits, np.float32([3.0])], (0,)),
        ("square_error_cost", lambda p, a, b: F(p).square_error_cost(a, b),
         [x, y], (0, 1)),
        ("log_loss", lambda p, a, b: F(p).log_loss(a, b), [prob, bits],
         (0,)),
        ("dice_loss", lambda p, a, b: F(p).dice_loss(a, b), [seg_p, seg],
         (0,)),
        ("npair_loss", lambda p, a, b, c: F(p).npair_loss(a, b, c),
         [x, y, np.array([0, 1, 0, 2, 1, 3], np.int64)], (0, 1)),
        ("smooth_l1_loss", lambda p, a, b: F(p).smooth_l1_loss(
            a, b, delta=0.5), [x, y], (0, 1)),
    ]
    cases += [("ctc_loss-" + r, lambda p, a, b, c, d, r=r: F(p).ctc_loss(
        a, b, c, d, blank=0, reduction=r), ctc_inputs(), (0,))
        for r in ("mean", "sum", "none")]
    w, b = _f32(rs, 5, 5), _f32(rs, 5)
    label = np.array([0, 3, 5, 2], np.int64)
    table = np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3], [0, -1, -1]],
                     np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]],
                    np.float32)
    cases += [
        ("hsigmoid_loss", lambda p, a, l, ww, bb: F(p).hsigmoid_loss(
            a, l, 6, ww, bb), [x[:4], label, w, b], (0, 2, 3)),
        ("hsigmoid_loss-custom-paths", lambda p, a, l, ww, tb, c:
         F(p).hsigmoid_loss(a, l, 6, ww, path_table=tb, path_code=c),
         [x[:4], label, w, table, code], (0, 2)),
    ]
    for name, shape, kw in INTERPOLATE:
        cases.append(("interpolate-" + name,
                      lambda p, a, kw=kw: F(p).interpolate(a, **kw),
                      [_f32(rs, *shape)], (0,)))
    cases.append(("upsample", lambda p, a: F(p).upsample(a, size=[7, 4]),
                  [x4], (0,)))
    img = _f32(rs, 2, 3, 5, 6)
    grid = _f32(rs, 2, 4, 7, 2, lo=-1.2, hi=1.2)        # some taps outside
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border"):
            for ac in (True, False):
                cases.append((
                    f"grid_sample-{mode}-{pad}-align_corners={ac}",
                    lambda p, a, g, m=mode, pm=pad, c=ac: F(p).grid_sample(
                        a, g, mode=m, padding_mode=pm, align_corners=c),
                    [img, grid], (0, 1) if mode == "bilinear" else (0,)))
    theta = np.eye(2, 3, dtype=np.float32)[None] + 0.2 * _f32(rs, 2, 2, 3)
    for ac in (True, False):
        cases.append((
            f"affine_grid-align_corners={ac}", lambda p, th, a, c=ac:
            F(p).grid_sample(a, F(p).affine_grid(th, [2, 3, 6, 5],
                                                 align_corners=c),
                             align_corners=c),
            [theta, _f32(rs, 2, 3, 5, 4)], (0, 1)))
    cases += [
        ("pixel_shuffle", lambda p, a: F(p).pixel_shuffle(a, 2), [x4], (0,)),
        ("unfold", lambda p, a: F(p).unfold(a, [2, 3]), [x4], (0,)),
        ("unfold-stride-pad-dilation", lambda p, a: F(p).unfold(
            a, 3, strides=2, paddings=1, dilations=[1, 2]), [x4], (0,)),
        ("unfold-4-sided", lambda p, a: F(p).unfold(
            a, 2, paddings=[1, 0, 2, 1]), [x4], (0,)),
        ("temporal_shift", lambda p, a: F(p).temporal_shift(a, 2, 0.25),
         [_f32(rs, 4, 8, 3, 3)], (0,)),
        ("bilinear", lambda p, a, b_, w_, c: F(p).bilinear(a, b_, w_, c),
         [_f32(rs, 3, 4), _f32(rs, 3, 5), _f32(rs, 2, 4, 5), _f32(rs, 2)],
         (0, 1, 2, 3)),
        ("cosine_similarity", lambda p, a, b_: F(p).cosine_similarity(
            a, b_, axis=1), [_f32(rs, 3, 6), _f32(rs, 3, 6)], (0, 1)),
        ("diag_embed", lambda p, a: F(p).diag_embed(a), [_f32(rs, 2, 4)],
         (0,)),
        ("label_smooth", lambda p, a: F(p).label_smooth(a, epsilon=0.2),
         [np.eye(5, dtype=np.float32)[[1, 3, 0]]], (0,)),
        ("label_smooth-prior", lambda p, a, q: F(p).label_smooth(
            a, prior_dist=q, epsilon=0.1),
         [np.eye(4, dtype=np.float32)[[2, 0]],
          np.float32([[0.1, 0.2, 0.3, 0.4]])], (0, 1)),
        ("gather_tree", lambda p, i, par: F(p).gather_tree(i, par),
         [np.array([[[1, 2]], [[3, 4]]], np.int64),
          np.array([[[0, 0]], [[1, 0]]], np.int64)], ()),
    ]
    cases += [(name, _in_place(name, *args), [_f32(rs, 3, 4)], (0,))
              for name, args in (("elu_", (0.7,)), ("relu_", ()),
                                 ("softmax_", (0,)), ("tanh_", ()))]
    return cases


def layer_cases():
    rs = np.random.RandomState(8)
    x4 = _f32(rs, 2, 4, 5, 6)
    x2, y2 = _f32(rs, 5, 6), _f32(rs, 5, 6)
    pm = np.where(rs.rand(5) > 0.5, 1.0, -1.0).astype(np.float32)
    logp = np.log(np.full((5, 6), 1 / 6, np.float32))
    return [
        ("Identity", lambda n: n.Identity(), [x2], (0,)),
        ("Flatten", lambda n: n.Flatten(), [x4], (0,)),
        ("Flatten-axes", lambda n: n.Flatten(0, 2), [x4], (0,)),
        ("Upsample", lambda n: n.Upsample(scale_factor=2, mode="bilinear"),
         [x4], (0,)),
        ("UpsamplingNearest2D", lambda n: n.UpsamplingNearest2D(
            size=[3, 9]), [x4], (0,)),
        ("UpsamplingBilinear2D", lambda n: n.UpsamplingBilinear2D(
            size=[3, 9]), [x4], (0,)),
        ("PixelShuffle", lambda n: n.PixelShuffle(2), [x4], (0,)),
        ("Pad1D-reflect", lambda n: n.Pad1D([2, 1], mode="reflect"),
         [_f32(rs, 2, 3, 6)], (0,)),
        ("Pad2D-constant", lambda n: n.Pad2D([1, 2, 0, 1], value=0.5),
         [x4], (0,)),
        ("Pad2D-replicate", lambda n: n.Pad2D([1, 1, 2, 0],
                                              mode="replicate"), [x4], (0,)),
        ("Pad3D", lambda n: n.Pad3D([1, 0, 0, 1, 2, 0]),
         [_f32(rs, 1, 2, 3, 4, 5)], (0,)),
        ("CosineSimilarity", lambda n: n.CosineSimilarity(axis=1),
         [x2, y2], (0, 1)),
        ("Unfold", lambda n: n.Unfold([2, 2], strides=2), [x4], (0,)),
        ("PairwiseDistance", lambda n: n.PairwiseDistance(), [x2, y2],
         (0, 1)),
        ("PairwiseDistance-p1-keepdim", lambda n: n.PairwiseDistance(
            p=1.0, keepdim=True), [x2, y2], (0, 1)),
        ("Dropout2D-eval", lambda n: n.Dropout2D(0.5).eval(), [x4], (0,)),
        ("Dropout3D-eval", lambda n: n.Dropout3D(0.5).eval(),
         [_f32(rs, 1, 2, 3, 4, 5)], (0,)),
        ("AlphaDropout-eval", lambda n: n.AlphaDropout(0.5).eval(), [x2],
         (0,)),
        ("KLDivLoss", lambda n: n.KLDivLoss("batchmean"),
         [logp, np.abs(y2)], (0, 1)),
        ("SmoothL1Loss", lambda n: n.SmoothL1Loss(delta=0.7), [x2, y2],
         (0, 1)),
        ("MarginRankingLoss", lambda n: n.MarginRankingLoss(0.2),
         [x2[:, 0], y2[:, 0], pm], (0, 1)),
        ("HingeEmbeddingLoss", lambda n: n.HingeEmbeddingLoss(0.5),
         [x2[:, 0], pm], (0,)),
        ("CosineEmbeddingLoss", lambda n: n.CosineEmbeddingLoss(0.1),
         [x2, y2, pm], (0, 1)),
        ("CTCLoss", lambda n: n.CTCLoss(blank=0), ctc_inputs(), (0,)),
        ("Bilinear", lambda n: n.Bilinear(6, 6, 3), [x2, y2], (0, 1)),
        ("HSigmoidLoss", lambda n: n.HSigmoidLoss(6, 5),
         [x2, np.array([0, 4, 2, 1, 3], np.int64)], (0,)),
        ("weight_norm", lambda n: n.weight_norm(n.Linear(6, 4)), [x2],
         (0,)),
    ]
