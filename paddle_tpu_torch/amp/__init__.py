"""Automatic mixed precision (paddle_tpu.amp): ``auto_cast`` at O1 and
O2, ``decorate`` and ``GradScaler``.

- :func:`auto_cast` turns on the cast hook at the port's one dispatch
  point (``core.dispatch.apply``), as the JAX package's sits in its
  ``dispatch.apply``: inside it, every paddle op's floating tensor
  inputs (f16, bf16, f32) are cast before the op runs, by the op's
  paddle name: to float32 for the black list, to the low type for the
  white list at O1 and for every op not black at O2.  Static
  ``Variable``s are recorded, never cast.  Plain torch operators
  (``+``, ``reshape``) are not paddle ops here and follow torch's type
  promotion.
- :func:`decorate` at O2 casts the models' parameters to the low type
  and turns on the optimizers' f32 master weights; at O1 it casts
  nothing and only records the type (``model._amp_dtype``, which
  ``jit.TrainStep(amp_level=...)`` reads).
- :class:`GradScaler`: dynamic loss scaling on the eager
  ``Optimizer.step()`` path (one host read of the overflow flag a
  step, as in paddle_tpu) and, bound to ``jit.TrainStep(scaler=...)``,
  inside the step with its state on the device.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtype import convert_dtype
from ..core.tensor import Tensor

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "amp_active", "amp_cast_inputs", "amp_state", "decorate",
           "GradScaler", "Tensor"]

# op lists, by paddle op name (paddle_tpu/amp/__init__.py:24-39)
WHITE_LIST = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention",
    "flash_attention",
}
BLACK_LIST = {
    "exp", "log", "square", "mean", "sum", "softmax", "log_softmax",
    "cross_entropy", "nll_loss", "bce_with_logits", "binary_cross_entropy",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "norm",
    "logsumexp", "softmax_with_cross_entropy", "cosine_similarity",
    "kl_div", "sigmoid_focal_loss", "erf", "erfinv", "pow", "cumsum",
}
_CASTABLE = (torch.float16, torch.bfloat16, torch.float32)
_LOW = {"bfloat16": torch.bfloat16, "float16": torch.float16}

_tls = threading.local()


class _AmpState:
    __slots__ = ("dtype", "level", "white", "black")

    def __init__(self, dtype, level, white, black):
        self.dtype, self.level = dtype, level
        self.white, self.black = white, black


def amp_state():
    """This thread's ``auto_cast`` state (None when off), which
    ``parallel.recompute`` carries into its second forward."""
    return getattr(_tls, "amp", None)


def amp_active() -> bool:
    return amp_state() is not None


def amp_cast_inputs(op_name: str, inputs):
    """The inputs of op ``op_name`` as ``auto_cast`` wants them (called
    by ``core.dispatch.apply`` while it is on)."""
    st = amp_state()
    if st is None:
        return inputs
    if op_name in st.black:
        dt = torch.float32
    elif op_name in st.white or st.level == "O2":
        dt = st.dtype
    else:
        return inputs
    return tuple(x.to(dt) if isinstance(x, torch.Tensor)
                 and x.dtype in _CASTABLE and x.dtype != dt else x
                 for x in inputs)


@contextlib.contextmanager
def _entered(state):
    prev = amp_state()
    _tls.amp = state
    try:
        yield
    finally:
        _tls.amp = prev


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Inside the block, paddle ops run in mixed precision: at O1 the
    white-listed ones in ``dtype`` and the black-listed in float32; at
    O2 every op not black-listed in ``dtype``.  A custom white name
    leaves the black list and the other way round."""
    if not enable:
        return _entered(None)
    if level not in ("O1", "O2"):
        raise ValueError(f"auto_cast level {level!r}: O1 or O2")
    white, black = set(WHITE_LIST), set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    return _entered(_AmpState(convert_dtype(dtype), level, white, black))


amp_guard = auto_cast  # fluid-era alias


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast ``models`` to ``dtype`` and turn on the ``optimizers``'
    master weights (unless ``master_weight`` is False).  O1: cast
    nothing.  Either way the models record ``dtype`` as
    ``_amp_dtype``.  Returns what it was given: ``models`` alone, or
    ``(models, optimizers)``.  ``save_dtype`` is taken and, as in
    paddle_tpu, changes nothing."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp.decorate level {level!r}: O1 or O2")
    if dtype not in _LOW:
        raise ValueError(f"amp.decorate: dtype {dtype!r} not in "
                         f"{sorted(_LOW)}")
    dt = _LOW[dtype]
    single = not isinstance(models, (list, tuple))
    for m in [models] if single else list(models):
        if m is not None:
            if level == "O2":
                m.to(dtype=dt)
            m._amp_dtype = dt
    if optimizers is None:
        return models
    if level == "O2":
        single_opt = not isinstance(optimizers, (list, tuple))
        for o in [optimizers] if single_opt else list(optimizers):
            o._multi_precision = (True if master_weight is None
                                  else bool(master_weight))
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (paddle_tpu.amp.GradScaler).

    Eager: ``scaler.scale(loss).backward()``, then ``scaler.step(opt)``
    (unscale the gradients, and step unless one is not finite) and
    ``scaler.update()`` (grow the scale after ``incr_every_n_steps``
    finite steps, shrink it after ``decr_every_n_nan_or_inf`` others);
    ``minimize`` does all three.  Given to ``jit.TrainStep(scaler=)``,
    the step does the same on the device and :meth:`state_dict` reads
    its state back."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = {}  # id(optimizer) -> found_inf for this step
        self._bound_step = None

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        if not self._unscaled:
            # the first unscale of a step decides afresh
            self._found_inf = False
        from ..core.tensor import raw_grad
        # a sparse embedding gradient unscales its values in place
        grads = [g._values() if g.is_sparse else g
                 for g in (raw_grad(p) for p in optimizer._parameter_list
                           or []) if g is not None]
        found = False
        if grads:
            torch._foreach_mul_(grads, 1.0 / self._scale)
            # one host read for the whole list
            found = not bool(torch.stack(
                [torch.isfinite(g).all() for g in grads]).all())
        self._unscaled[id(optimizer)] = found
        self._found_inf = self._found_inf or found

    def step(self, optimizer):
        """Unscale (unless done) and step unless a gradient is not
        finite.  Call :meth:`update` once an iteration after it."""
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        # pop: the entry covers one step, so the next iteration's step()
        # unscales again even if update() was skipped
        if not self._unscaled.pop(id(optimizer)):
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        step = self._bound_step
        st = getattr(step, "_scaler_state", None)
        if st is not None:
            # the step's state, read from the device (checkpoint time)
            self._scale = float(st["scale"])
            self._good_steps = int(st["good"])
            self._bad_steps = int(st["bad"])
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]
        if self._bound_step is not None:
            # the bound step starts again from the loaded values
            self._bound_step._scaler_state = None
