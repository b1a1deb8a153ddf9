"""The dyadic models of ``paddle_tpu.testing.chaos`` (the port's own
copy; the chaos gates themselves are not ported).

Weights that are small dyadic rationals, fed inputs that are dyadic
too, make every product and partial sum exactly representable in
float32: outputs are bitwise the same whatever the batch coalescing,
padding or reduction order.  The serving engines' tests hold that."""
from __future__ import annotations

import numpy as np

__all__ = ["make_dyadic_model", "make_dyadic_lm"]


def make_dyadic_model(in_dim=8, hidden=16, out_dim=4):
    """A tiny MLP whose weights are rounded to k/8, on the default
    device (``set_device``)."""
    from .. import nn

    model = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                          nn.Linear(hidden, out_dim))
    for p in model.parameters():
        p.set_value(np.round(p.numpy() * 8.0) / 8.0)
    return model


def make_dyadic_lm(**kw):
    """A tiny ``PagedDecoderLM`` with k/64 dyadic weights: per-row
    decode math reproduces bitwise in any slot, batch or page
    placement."""
    from ..serving import PagedDecoderLM

    kw.setdefault("vocab_size", 32)
    kw.setdefault("hidden", 16)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("seed", 3)
    return PagedDecoderLM(dyadic=True, **kw)
