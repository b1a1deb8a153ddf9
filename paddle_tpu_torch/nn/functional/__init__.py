"""nn.functional: the subset of ``paddle_tpu.nn.functional`` the BERT
training paths run, in PyTorch.

Layouts and semantics are paddle_tpu's: ``linear`` takes its weight as
``[in, out]``, attention takes ``[B, L, H, D]``, dropout keeps a value
iff a 16-bit draw is ``>= round(p * 65536)`` (``_u16_dropout_mask``).
:func:`scaled_dot_product_attention` sends every shape the flash gate
takes to :func:`~paddle_tpu_torch.ops.flash_attention.flash_attention`
(the CUDA kernels on the card, their plain versions on the CPU) while
``FLAGS_use_pallas_kernels`` is on; a mask or ``return_weights`` takes
the unfused path, as in paddle_tpu.

Activations, convolutions, normalisation, pooling and the other losses
are in :mod:`.activation`, :mod:`.conv`, :mod:`.norm`, :mod:`.pooling`
and :mod:`.loss`; the channel and alpha dropouts, ``bilinear`` and
``label_smooth`` in :mod:`.common`; resampling and patches in
:mod:`.vision`.

The JAX package's helper names have counterparts over the port's core:
``Tensor`` is the paddle Tensor, ``as_array`` gives the torch tensor
under it, ``np_asarray`` a numpy array, ``next_key`` a fresh int32 seed
(``core.rng.next_seed``; the JAX package's is a threefry key) and
``stable_draw`` a ``core.rng.StableDraw``.

Each public function is one paddle op: it goes through
:func:`~paddle_tpu_torch.core.dispatch.apply` under paddle_tpu's op
name, with its parameters as attrs, so that on a static ``Variable`` it
records a node the static Executor's fusion pass can read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

import numpy as np

from ...core import rng
from ...core.dispatch import Symbolic, apply
from ...core.rng import StableDraw
from ...core.tensor import Tensor, _plain
from ...core.dtype import convert_dtype
from ...core.static_hooks import current_replay
from ...core.flags import get_flag
from ...ops.flash_attention import flash_attention, flash_attention_supported

from ...ops.manipulation import one_hot, pad, squeeze, unsqueeze  # noqa
from ..decode import gather_tree  # noqa: F401
from . import activation, common, conv, loss, norm, pooling  # noqa: F401
from . import vision  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403

__all__ = (["linear", "embedding", "layer_norm", "gelu", "relu", "dropout",
            "scaled_dot_product_attention", "cross_entropy", "mse_loss",
            "linear_cross_entropy", "softmax_with_cross_entropy", "one_hot",
            "pad", "squeeze", "unsqueeze", "sequence_mask", "gather_tree",
            "Tensor", "as_array", "np_asarray", "next_key", "stable_draw"]
           + activation.__all__ + common.__all__
           + conv.__all__ + loss.__all__ + norm.__all__ + pooling.__all__
           + vision.__all__)


next_key = rng.next_key


def as_array(x):
    """The torch tensor under a paddle Tensor; anything else as it is."""
    return x.as_subclass(torch.Tensor) if isinstance(x, Tensor) else x


def np_asarray(x):
    """``x`` as a numpy array (a tensor is copied to the host)."""
    return (_plain(x).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def stable_draw():
    """A seed fixed now and given again by every ``key()``."""
    return StableDraw()


def _relu(x):
    return torch.relu(x)


def relu(x, name=None):
    return apply(_relu, x, op_name="relu")


def _gelu(x, approximate):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU by default, tanh form with ``approximate``."""
    return apply(_gelu, x, op_name="gelu",
                 attrs={"approximate": bool(approximate)})


def _linear(x, weight, bias=None):
    if bias is None:
        return torch.matmul(x, weight)
    y = torch.addmm(bias, x.reshape(-1, x.shape[-1]), weight)
    return y.reshape(*x.shape[:-1], weight.shape[-1])


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias``; ``weight`` is ``[in, out]``."""
    if bias is None:
        return apply(_linear, x, weight, op_name="linear")
    return apply(_linear, x, weight, bias, op_name="linear")


def _embedding(x, weight, padding_idx):
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


class _SparseEmbedding(torch.autograd.Function):
    """The lookup with a sparse weight gradient: an uncoalesced
    ``sparse_coo`` tensor whose rows are the ids (duplicates kept, the
    rows at ``padding_idx`` with zero values), as paddle_tpu's
    SelectedRows vjp gives.  A weight with a backward hook gets the
    dense gradient: paddle_tpu's hooks see the densified gradient and
    deposit it."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.weight = weight
        ctx.padding_idx = padding_idx
        return _embedding(ids, weight, padding_idx)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        rows = ids.reshape(-1)
        vals = g.reshape(-1, g.shape[-1])
        if ctx.padding_idx is not None:
            vals = vals * (rows != ctx.padding_idx).unsqueeze(1).to(
                vals.dtype)
        shape = tuple(ctx.weight.shape)
        if ctx.weight._backward_hooks:
            dense = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
            return None, dense.index_add_(0, rows, vals), None
        return None, torch.sparse_coo_tensor(
            rows.unsqueeze(0), vals, shape, check_invariants=False), None


def _embedding_sparse(x, weight, padding_idx):
    return _SparseEmbedding.apply(x, weight, padding_idx)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` are zero (in
    the output, as in paddle_tpu).  ``sparse=True`` gives a leaf weight
    that takes a gradient a sparse one (:class:`_SparseEmbedding`; the
    optimizers read it as a ``core.selected_rows.SelectedRows``); in a
    static Program, or for a weight that is not a leaf, the gradient is
    dense, as in paddle_tpu."""
    sparse = (sparse and torch.is_grad_enabled()
              and isinstance(weight, torch.Tensor) and weight.requires_grad
              and weight.is_leaf and not isinstance(x, Symbolic)
              and current_replay() is None)
    return apply(_embedding_sparse if sparse else _embedding, x, weight,
                 op_name="embedding", attrs={"padding_idx": padding_idx})


def _sequence_mask(lengths, maxlen, dtype):
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[B]`` lengths -> ``[B, maxlen]`` 0/1 mask of ``dtype``;
    ``maxlen`` defaults to the longest (read on the host)."""
    ml = int(maxlen) if maxlen else int(torch.as_tensor(lengths).max())
    return apply(_sequence_mask, lengths, op_name="sequence_mask",
                 attrs={"maxlen": ml, "dtype": convert_dtype(dtype)})


def _layer_norm(x, *wb, n, epsilon):
    return TF.layer_norm(x, tuple(x.shape[x.dim() - n:]),
                         wb[0] if wb else None,
                         wb[1] if len(wb) > 1 else None, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the last ``len(normalized_shape)`` dims; ``n`` and
    ``epsilon`` ride the node as attrs.  As in paddle_tpu, a bias
    without a weight is dropped."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    args = [x]
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    return apply(_layer_norm, *args, op_name="layer_norm",
                 attrs={"n": len(tuple(normalized_shape)),
                        "epsilon": float(epsilon)})


def _u16_keep(shape, p, x, upscale=True):
    """paddle_tpu's ``_u16_dropout_mask``: None keeps everything, 0.0
    drops everything, else a mask in ``x``'s dtype (scaled when
    ``upscale``) drawn from the device's generator."""
    t, scale = rng.dropout_threshold(p)
    if t <= 0:
        return None
    if t >= 65536:
        return 0.0
    if x.device.type == "meta":
        # a static Program records on meta tensors: the mask takes its
        # shape there and is drawn when the Executor replays the node
        return torch.empty(tuple(shape), dtype=x.dtype, device="meta")
    bits = torch.randint(0, 65536, tuple(shape), dtype=torch.int32,
                         device=x.device, generator=rng.generator(x.device))
    keep = (bits >= t).to(x.dtype)
    return keep * scale if upscale else keep


def _dropout(x, p, axis, mode):
    shape = list(x.shape)
    if axis is not None:
        shape = [s if i in axis else 1 for i, s in enumerate(shape)]
    mask = _u16_keep(shape, p, x, upscale=(mode == "upscale_in_train"))
    return x if mask is None else x * mask


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if axis is not None:
        axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply(_dropout, x, op_name="dropout",
                 attrs={"p": p, "axis": axis, "mode": mode})


def _sdpa(query, key, value, *mask, dropout_p, is_causal, training,
          return_weights):
    attn_mask = mask[0] if mask else None
    eff = dropout_p if training else 0.0
    if (get_flag("use_pallas_kernels") and not return_weights
            and flash_attention_supported(tuple(query.shape),
                                          tuple(key.shape), query.dtype,
                                          attn_mask, eff)):
        seed = rng.next_seed() if eff > 0.0 else None
        return flash_attention(query, key, value, causal=is_causal,
                               dropout_p=eff, seed=seed)
    B, Lq, H, D = query.shape
    s = torch.einsum("blhd,bshd->bhls", query, key) * (1.0 / math.sqrt(D))
    if is_causal:
        causal = torch.ones((Lq, key.shape[1]), dtype=torch.bool,
                            device=s.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            s = s.masked_fill(~attn_mask, float("-inf"))
        else:
            s = s + attn_mask
    w = torch.softmax(s, dim=-1)
    if eff > 0.0:
        keep = _u16_keep(w.shape, eff, w)
        if keep is not None:
            w = w * keep
    out = torch.einsum("bhls,bshd->blhd", w, value)
    return (out, w) if return_weights else out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None,
                                 return_weights=False):
    """``[B, L, H, D]`` attention.  ``return_weights=True`` takes the
    unfused path and returns ``(out, weights [B, H, Lq, Lk])``, the
    post-dropout probabilities in training mode."""
    args = (query, key, value) + (() if attn_mask is None else (attn_mask,))
    return apply(_sdpa, *args, op_name="scaled_dot_product_attention",
                 attrs={"dropout_p": dropout_p, "is_causal": is_causal,
                        "training": training,
                        "return_weights": return_weights})


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _cross_entropy(input, label, *weight, ignore_index, reduction,
                   soft_label, axis, use_softmax, label_smoothing):
    weight = weight[0] if weight else None
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(input.clamp_min(1e-30))
    nclass = input.shape[axis]
    lab = label
    if not soft_label and lab.dim() == logp.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    if soft_label or label_smoothing > 0.0:
        if soft_label:
            tgt = lab
        else:
            safe = torch.where(lab == ignore_index, 0, lab).long()
            tgt = TF.one_hot(safe, nclass).to(logp.dtype).movedim(-1, axis)
        if label_smoothing > 0.0:
            tgt = tgt * (1.0 - label_smoothing) + label_smoothing / nclass
        loss = -(tgt * logp).sum(dim=axis)
    else:
        # the one-hot sum picks one term exactly: a gather is the same
        # value without the [rows, classes] target
        safe = torch.where(lab == ignore_index, 0, lab).long()
        loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if soft_label:
        return _reduce(loss, reduction)
    w_row = None
    if weight is not None:
        w_row = weight[torch.where(lab == ignore_index, 0, lab).long()]
        loss = loss * w_row
    mask = (lab != ignore_index).to(loss.dtype)
    loss = loss * mask
    if reduction == "mean":
        denom = (mask * w_row).sum() if w_row is not None else mask.sum()
        return loss.sum() / denom.clamp_min(1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """paddle_tpu's cross entropy: hard or soft labels, class weights,
    ``ignore_index`` and label smoothing; the mean over hard labels
    divides by the (weighted) count of rows not ignored."""
    args = (input, label) + (() if weight is None else (weight,))
    return apply(_cross_entropy, *args, op_name="cross_entropy",
                 attrs={"ignore_index": ignore_index,
                        "reduction": reduction, "soft_label": soft_label,
                        "axis": axis, "use_softmax": use_softmax,
                        "label_smoothing": float(label_smoothing)})


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The unreduced cross entropy with ``axis`` kept (size 1), and the
    softmax when ``return_softmax``."""
    out = cross_entropy(logits, label, reduction="none",
                        soft_label=soft_label, ignore_index=ignore_index,
                        axis=axis)
    out = unsqueeze(out, axis)
    if return_softmax:
        return out, activation.softmax(logits, axis=axis)
    return out


def _mse_loss(input, label, reduction):
    return _reduce((input - label) ** 2, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return apply(_mse_loss, input, label, op_name="mse_loss",
                 attrs={"reduction": reduction})


def _chunk_logits(h, w, b):
    logits = torch.matmul(h, w)
    if b is not None:
        logits = logits + b
    return logits.float()


class _LinearCrossEntropy(torch.autograd.Function):
    """Mean NLL of ``h @ w + b`` over labels not ignored, one row chunk
    at a time: a chunk's logits live only inside the loop, in the
    forward and again (recomputed) in the backward, as the JAX
    package's ``jax.checkpoint`` per chunk does."""

    @staticmethod
    def forward(ctx, h, w, b, label, per, ignore_index):
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, h.shape[0], per):
            logits = _chunk_logits(h[c0:c0 + per], w, b)
            lc = label[c0:c0 + per]
            keep = lc != ignore_index
            tgt = logits.gather(1, torch.where(keep, lc, 0).long()[:, None])
            nll = torch.logsumexp(logits, dim=-1) - tgt[:, 0]
            total = total + (nll * keep).sum()
        count = (label != ignore_index).sum().clamp_min(1).float()
        ctx.save_for_backward(h, w, b, label, count)
        ctx.per, ctx.ignore_index = per, ignore_index
        return total / count

    @staticmethod
    def backward(ctx, g):
        h, w, b, label, count = ctx.saved_tensors
        per, ignore_index = ctx.per, ctx.ignore_index
        coef = g.float() / count
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (torch.zeros(b.shape, dtype=torch.float32, device=b.device)
              if b is not None else None)
        for c0 in range(0, h.shape[0], per):
            hc, lc = h[c0:c0 + per], label[c0:c0 + per]
            keep = lc != ignore_index
            dl = torch.softmax(_chunk_logits(hc, w, b), dim=-1)
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, torch.where(keep, lc, 0).long()] -= 1.0
            dl = (dl * (keep[:, None] * coef)).to(h.dtype)
            dh[c0:c0 + per] = torch.matmul(dl, w.t())
            dw += torch.matmul(hc.t(), dl).float()
            if db is not None:
                db += dl.float().sum(dim=0)
        return (dh, dw.to(w.dtype), None if db is None else db.to(b.dtype),
                None, None, None)


def _linear_ce(hidden, weight, bias, label, chunk, ignore_index):
    T = hidden.shape[0]
    n = max(1, -(-T // chunk))
    per = -(-T // n)
    return _LinearCrossEntropy.apply(hidden, weight, bias, label, per,
                                     ignore_index)


def linear_cross_entropy(hidden, weight, bias, label, chunk: int = 1024,
                         ignore_index: int = -100, name=None):
    """``cross_entropy(hidden @ weight + bias, label)`` (mean) without
    the ``[T, vocab]`` logits ever existing whole: ``hidden`` [T, H],
    ``weight`` [H, vocab], ``label`` [T].  Rows are cut into
    ``ceil(T / chunk)`` equal chunks, as paddle_tpu's ``_linear_ce_fn``
    cuts them."""
    return apply(_linear_ce, hidden, weight, bias, label,
                 op_name="linear_cross_entropy",
                 attrs={"chunk": int(chunk),
                        "ignore_index": int(ignore_index)})
