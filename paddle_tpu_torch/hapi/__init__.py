"""hapi, the Keras-like high-level API (the counterpart of
``paddle_tpu/hapi``; reference: python/paddle/hapi/model.py:810 — Model.fit
:1299, evaluate, predict): :class:`Model`, the callbacks, and
:func:`summary`.  ``paddle.Model`` and ``paddle.summary`` are these."""
from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401
from .callbacks import (Callback, Checkpoint, EarlyStopping,  # noqa: F401
                        LRScheduler, MetricsDump, ModelCheckpoint,
                        ProgBarLogger, ReduceLROnPlateau, VisualDL)


def summary(net, input_size=None, dtypes=None):
    """paddle.summary parity (reference: hapi/model_summary.py:summary):
    per-layer table with OUTPUT SHAPES (captured via forward hooks on a
    zero-input forward when ``input_size`` is given) and parameter
    counts, split into trainable / non-trainable totals."""
    import numpy as np
    import torch

    from ..core.tensor import to_tensor

    def _params_of(layer):
        n = t = 0
        for p in layer.parameters(include_sublayers=False):
            n += p.numel()
            if not p.stop_gradient:
                t += p.numel()
        return n, t

    out_shapes = {}
    if input_size is not None:
        sizes = (input_size if isinstance(input_size, list)
                 else [input_size])
        dts = dtypes if isinstance(dtypes, list) else [
            dtypes or "float32"] * len(sizes)
        feeds = [to_tensor(np.zeros([d if d is not None and d > 0 else 1
                                     for d in s], np.dtype(dt)))
                 for s, dt in zip(sizes, dts)]
        handles = []

        def mk_hook(name):
            def hook(layer, inputs, outputs):
                o = outputs[0] if isinstance(outputs, (list, tuple)) \
                    else outputs
                if hasattr(o, "shape"):
                    out_shapes[name] = list(o.shape)
                return outputs
            return hook

        for name, sub in net.named_sublayers():
            handles.append(sub.register_forward_post_hook(mk_hook(name)))
        was = net.training
        net.eval()
        try:
            with torch.no_grad():
                net(*feeds)
        finally:
            if was:
                net.train()
            for h in handles:
                h.remove()

    rows = []
    for name, sub in net.named_sublayers():
        n, _ = _params_of(sub)
        rows.append((f"{name} ({type(sub).__name__})",
                     str(out_shapes.get(name, "-")), n))
    root_n, _ = _params_of(net)
    if root_n or not rows:      # params registered directly on the root
        rows.insert(0, (f"({type(net).__name__})", "-", root_n))
    # totals from the deduped parameter set (shared/tied params count
    # once; per-row numbers above are per-layer attributions)
    seen = {}
    for _, p in net.named_parameters():
        seen[id(p)] = p
    total = sum(p.numel() for p in seen.values())
    trainable = sum(p.numel() for p in seen.values()
                    if not p.stop_gradient)
    w0 = max(max((len(r[0]) for r in rows), default=10), 14) + 2
    w1 = max(max((len(r[1]) for r in rows), default=10), 14) + 2
    lines = ["-" * (w0 + w1 + 12),
             f"{'Layer (type)':<{w0}}{'Output Shape':<{w1}}{'Param #':>12}",
             "=" * (w0 + w1 + 12)]
    for name, shape, n in rows:
        lines.append(f"{name:<{w0}}{shape:<{w1}}{n:>12,}")
    lines += ["=" * (w0 + w1 + 12),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}",
              "-" * (w0 + w1 + 12)]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
