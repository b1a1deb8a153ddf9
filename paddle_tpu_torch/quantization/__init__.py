"""quantization (``paddle_tpu.quantization``): QAT, PTQ and int8 layers.

Quantization is simulated in the graph (quantize, then dequantize, with
a straight-through estimator), as the reference's fake-quant training
ops are; PTQ observers are abs-max and moving-average statistics taken
over calibration forwards.  ``convert_to_int8`` then makes real int8
layers whose int8 weights and scales are buffers, so ``jit.save`` writes
an int8 artifact the ``Predictor`` serves.

How it maps onto torch:

- The wrappers feed the fake-quantised weight, ``w + (w_q - w).detach()``,
  to the inner layer's functional form (``F.linear``, ``F.conv2d``;
  ``torch.func.functional_call`` for another layer): autograd saves
  that tensor for the input gradient, so ``dx`` is taken through
  ``w_q`` (paddle_tpu's tape captured ``w_q``) and ``dw`` is the
  straight-through identity.  Swapping ``w.data`` around the call, as
  paddle_tpu does, would leave autograd holding the float weight.
- The activation scale is read on the host once a wrapped layer a
  forward (``float(...)``), as paddle_tpu reads it.
- ``Int8Linear`` with a calibrated activation scale computes int8 x int8
  -> int32 with ``torch._int_mm``; the f32 epilogue is paddle_tpu's,
  ``acc * (act_scale / qmax) * w_scale``.  On CUDA ``_int_mm`` asks for
  more than 16 rows and for K and N in multiples of 8: a product outside
  that is zero-padded (exact in int32) and sliced back, so it still runs
  on the card.  ``torch.round`` and ``jnp.round`` both round half to
  even.
- ``Int8Conv2D`` is weight-only: dequantise, then ``F.conv2d``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as TF
from torch.func import functional_call

from ..core.dispatch import apply
from ..core.tensor import Tensor  # noqa: F401  (paddle_tpu's module name)
from .. import nn
from ..nn import functional as F

__all__ = [
    "fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
    "QuantConfig", "QAT", "PTQ", "QuantizedLinear", "QuantizedConv2D",
    "Int8Linear", "Int8Conv2D", "convert_to_int8",
]


# ---------------------------------------------------------------------------
# fake-quant ops (reference: operators/fake_quantize_op.cc)
# ---------------------------------------------------------------------------

def _ste(a, quantized):
    """Straight-through estimator over the whole quantize step: the
    reference's FakeQuantize*Grad ops are pure identity (dx = dout)."""
    return a + (quantized - a).detach()


def _fq_fn(a, *, bits, axis):
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        scale = a.abs().max()
    else:
        red = tuple(i for i in range(a.ndim) if i != axis)
        scale = torch.amax(a.abs(), dim=red, keepdim=True)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(torch.clamp(a / scale * qmax, -qmax, qmax))
    return _ste(a, q * scale / qmax)


def fake_quantize_abs_max(x, bit_length: int = 8, name=None):
    """Per-tensor abs-max fake quant (reference: FakeQuantizeAbsMax)."""
    return apply(_fq_fn, x, op_name="fake_quantize_abs_max",
                 attrs=dict(bits=int(bit_length), axis=None))


def fake_channel_wise_quantize_abs_max(x, bit_length: int = 8,
                                       quant_axis: int = 0, name=None):
    """Per-channel abs-max fake quant (reference:
    FakeChannelWiseQuantizeAbsMax)."""
    return apply(_fq_fn, x, op_name="fake_channel_wise_quantize_abs_max",
                 attrs=dict(bits=int(bit_length), axis=int(quant_axis)))


def _fq_with_scale_fn(a, scale, *, bits):
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.round(torch.clamp(a / scale * qmax, -qmax, qmax))
    return _ste(a, q * scale / qmax)


# ---------------------------------------------------------------------------
# config + quantized layers
# ---------------------------------------------------------------------------

class QuantConfig:
    """reference: quantization/config.py QuantConfig.

    Custom quanter objects (the reference's activation=/weight= quanters)
    are not supported: the built-in scheme is moving-average abs-max
    activations + channel-wise abs-max weights; passing quanters raises
    rather than silently running the wrong scheme."""

    def __init__(self, activation=None, weight=None, weight_bits: int = 8,
                 activation_bits: int = 8, moving_rate: float = 0.9):
        if activation is not None or weight is not None:
            raise NotImplementedError(
                "custom activation/weight quanters are not supported; use "
                "weight_bits/activation_bits/moving_rate to configure the "
                "built-in abs-max scheme")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate


def _param_device(layer):
    p = next(iter(layer.parameters()), None)
    return p.device if p is not None else None


class _QuantWrapper(nn.Layer):
    """Wraps a layer: fake-quants activations (moving-average abs-max
    observer, reference: FakeQuantizeMovingAverageAbsMax) and weights
    (channel-wise abs-max) around the wrapped forward."""

    def __init__(self, layer: nn.Layer, config: QuantConfig,
                 weight_name: str = "weight"):
        super().__init__()
        self._inner = layer
        self._cfg = config
        self._weight_name = weight_name
        self.register_buffer("act_scale", torch.zeros(
            (), dtype=torch.float32, device=_param_device(layer)))
        self._observing = False

    def observe(self, flag: bool = True):
        self._observing = flag
        return self

    def forward(self, x):
        cfg = self._cfg
        if self._observing:
            cur = float(x.detach().abs().max())
            prev = float(self.act_scale)
            r = cfg.moving_rate
            new = cur if prev == 0.0 else (r * prev + (1 - r) * cur)
            self.act_scale.fill_(new)
        if self.training or not self._observing:
            if float(self.act_scale) > 0:
                x = apply(_fq_with_scale_fn, x, self.act_scale,
                          op_name="fake_quantize_moving_average_abs_max",
                          attrs=dict(bits=cfg.activation_bits))
            else:
                x = fake_quantize_abs_max(x, cfg.activation_bits)
        inner = self._inner
        w = getattr(inner, self._weight_name)
        w_q = fake_channel_wise_quantize_abs_max(
            w, cfg.weight_bits,
            quant_axis=(1 if isinstance(inner, nn.Linear) else 0))
        # the inner layer's functional form with the fake-quantised weight
        if type(inner) is nn.Linear:
            return F.linear(x, w_q, inner.bias)
        if type(inner) is nn.Conv2D:
            return F.conv2d(x, w_q, inner.bias, inner._stride,
                            inner._padding, inner._dilation, inner._groups,
                            inner._data_format)
        return functional_call(inner, {self._weight_name: w_q}, (x,))


class QuantizedLinear(_QuantWrapper):
    def __init__(self, layer: nn.Linear, config: Optional[QuantConfig] = None):
        super().__init__(layer, config or QuantConfig())


class QuantizedConv2D(_QuantWrapper):
    def __init__(self, layer: nn.Conv2D, config: Optional[QuantConfig] = None):
        super().__init__(layer, config or QuantConfig())


def _swap_quantable(model: nn.Layer, config: QuantConfig) -> List[str]:
    """Replace Linear/Conv2D sublayers with quant wrappers, in place."""
    swapped = []
    for name, child in list(model.named_children()):
        if isinstance(child, _QuantWrapper):
            continue
        if isinstance(child, nn.Linear):
            setattr(model, name, QuantizedLinear(child, config))
            swapped.append(name)
        elif isinstance(child, nn.Conv2D):
            setattr(model, name, QuantizedConv2D(child, config))
            swapped.append(name)
        else:
            swapped += [f"{name}.{s}" for s in
                        _swap_quantable(child, config)]
    return swapped


class QAT:
    """Quantization-aware training (reference: quantization/qat.py).

    ``quanted = QAT(config).quantize(model)`` swaps Linear/Conv2D for
    fake-quant wrappers; train as usual (STE gradients flow through the
    rounding), then deploy through jit.save: the fake-quant ops are part
    of the exported program."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Layer, inplace: bool = True) -> nn.Layer:
        assert inplace, "QAT.quantize is in-place (pass the model you train)"
        _swap_quantable(model, self.config)
        return model

    convert = staticmethod(lambda model: model)  # fake-quant stays in-graph


class PTQ:
    """Post-training quantization (reference: quantization/ptq.py).

    ``q = PTQ(config).quantize(model)`` inserts observers; run
    calibration batches through the model, then ``PTQ.convert(q)``
    freezes the observed activation scales (weights quantize from their
    values directly)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Layer, inplace: bool = True) -> nn.Layer:
        assert inplace, "PTQ.quantize is in-place"
        _swap_quantable(model, self.config)
        for w in _wrappers(model):
            w.observe(True)
        model.eval()
        return model

    @staticmethod
    def convert(model: nn.Layer, inplace: bool = True) -> nn.Layer:
        for w in _wrappers(model):
            w.observe(False)
        return model


def _wrappers(model):
    return [c for c in model.sublayers(include_self=True)
            if isinstance(c, _QuantWrapper)]


# ---------------------------------------------------------------------------
# int8 deployment (reference: contrib/slim post-training quant convert
# flow, the quant2_int8 pass): fake-quant programs become real int8
# weights + scale metadata baked into the jit.save artifact
# ---------------------------------------------------------------------------

def _quantize_weight(w, bits, axis):
    qmax = 2.0 ** (bits - 1) - 1
    red = tuple(i for i in range(w.ndim) if i != axis)
    scale = torch.clamp(torch.amax(w.abs(), dim=red, keepdim=True),
                        min=1e-8)
    q = torch.round(torch.clamp(w / scale * qmax, -qmax, qmax)
                    ).to(torch.int8)
    return q, (scale / qmax).to(torch.float32)


def _pad_to(n, multiple, least):
    return max(least, -(-n // multiple) * multiple)


def int8_matmul(aq, qw):
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] by ``torch._int_mm``.

    On CUDA the product is zero-padded to more than 16 rows and to K and
    N in multiples of 8 (``_int_mm``'s limits there), then sliced back;
    the zeros add nothing to an int32 sum.  On the CPU it takes any
    shape."""
    M, K = aq.shape
    N = qw.shape[1]
    if aq.device.type != "cuda":
        return torch._int_mm(aq, qw)
    Mp = _pad_to(M, 8, 32) if M <= 16 else M
    Kp, Np = _pad_to(K, 8, 16), _pad_to(N, 8, 16)
    if (Mp, Kp, Np) == (M, K, N):
        return torch._int_mm(aq, qw)
    acc = torch._int_mm(TF.pad(aq, (0, Kp - K, 0, Mp - M)),
                        TF.pad(qw, (0, Np - N, 0, Kp - K)))
    return acc[:M, :N]


def _int8_linear_fn(a, qw, ws, as_, *mb, qmax, static):
    if static:
        # static int8 activations: int8 x int8 -> int32
        aq = torch.round(torch.clamp(a / as_ * qmax, -qmax, qmax)
                         ).to(torch.int8)
        acc = int8_matmul(aq.reshape(-1, aq.shape[-1]), qw)
        out = acc.to(torch.float32) * (as_ / qmax) * ws
        out = out.reshape(*a.shape[:-1], qw.shape[1])
    else:
        # weight-only: dequantise, then the float product
        out = a @ (qw.to(a.dtype) * ws.to(a.dtype))
    if mb:
        out = out + mb[0]
    return out.to(a.dtype).detach()      # paddle_tpu's op is nondiff


class Int8Linear(nn.Layer):
    """Deployed int8 linear: int8 weight buffer + per-output-channel
    scales.  With a calibrated activation scale the product itself runs
    int8 x int8 -> int32; without one it is weight-only int8."""

    def __init__(self, linear: nn.Linear, act_scale: float,
                 weight_bits: int = 8, activation_bits: int = 8):
        super().__init__()
        w = linear.weight.detach()                     # [in, out]
        q, s = _quantize_weight(w, weight_bits, axis=1)
        self.register_buffer("qweight", q)
        self.register_buffer("w_scale", s.reshape(-1))
        self.register_buffer("act_scale", torch.tensor(
            float(act_scale), dtype=torch.float32, device=w.device))
        self._act_qmax = 2.0 ** (activation_bits - 1) - 1
        # static-vs-dynamic is a conversion-time property (a calibrated
        # scale exists or not), a Python bool as in paddle_tpu
        self._static_act = float(act_scale) > 0.0
        self.bias = linear.bias

    def forward(self, x):
        args = [x, self.qweight, self.w_scale, self.act_scale] + (
            [self.bias] if self.bias is not None else [])
        return apply(_int8_linear_fn, *args, op_name="int8_linear",
                     attrs=dict(qmax=self._act_qmax,
                                static=self._static_act))


class Int8Conv2D(nn.Layer):
    """Deployed weight-only int8 conv (per-out-channel scales; the
    weight is dequantised before the conv)."""

    def __init__(self, conv: nn.Conv2D, act_scale: float,
                 weight_bits: int = 8):
        super().__init__()
        w = conv.weight.detach()                       # [out, in, kh, kw]
        q, s = _quantize_weight(w, weight_bits, axis=0)
        self.register_buffer("qweight", q)
        self.register_buffer("w_scale", s)
        self.bias = conv.bias
        # copy conv attrs only: registering the conv itself would keep
        # its f32 weight in the state dict and undo the artifact saving
        self._stride = conv._stride
        self._padding = conv._padding
        self._dilation = conv._dilation
        self._groups = conv._groups
        self._data_format = conv._data_format

    def forward(self, x):
        w = self.qweight.to(x.dtype) * self.w_scale.to(x.dtype)
        return F.conv2d(x, w, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


def convert_to_int8(model: nn.Layer, inplace: bool = True) -> nn.Layer:
    """Replace fake-quant wrappers (QAT/PTQ output) with real int8
    layers whose int8 weights + scales live in the state dict, so
    ``jit.save`` exports an int8 artifact the Predictor serves directly.
    Reference: contrib/slim quant2_int8 conversion."""
    assert inplace, "convert_to_int8 is in-place"
    for name, child in list(model.named_children()):
        if isinstance(child, _QuantWrapper):
            scale = float(child.act_scale)
            inner = child._inner
            cfg = child._cfg
            if isinstance(inner, nn.Linear):
                setattr(model, name, Int8Linear(
                    inner, scale, cfg.weight_bits, cfg.activation_bits))
            elif isinstance(inner, nn.Conv2D):
                setattr(model, name, Int8Conv2D(
                    inner, scale, cfg.weight_bits))
        else:
            convert_to_int8(child)
    return model

