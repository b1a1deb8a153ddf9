"""Recurrent layers and cells (paddle_tpu.nn.layer.rnn): SimpleRNN,
LSTM and GRU over ``num_layers`` and one or two directions, their
cells, and the cell-driven ``RNN`` and ``BiRNN``.

Names, layouts and gates are paddle_tpu's, which are torch's: the
fused layers hold ``weight_ih_l{k}`` ``[G*H, in]``, ``weight_hh_l{k}``
``[G*H, H]``, ``bias_ih_l{k}`` and ``bias_hh_l{k}`` ``[G*H]`` (with a
``_reverse`` suffix for the second direction), every one drawn from
U(-1/sqrt(H), 1/sqrt(H)); LSTM gates are i, f, g, o; GRU gates r, z, c,
with r applied to ``h @ W_hc^T + b_hc``; initial and final states are
``[num_layers * directions, B, H]``, the layer's directions adjacent;
the reverse direction's final state is the one after t = 0 and its
output is in time order.

paddle_tpu runs a fused layer as one ``lax.scan`` a layer and
direction.  The port runs torch's recurrent op (``torch._VF.lstm`` /
``gru`` / ``rnn_tanh`` / ``rnn_relu``: cuDNN on the card), which has
the same gates.  The per-step version is :func:`_scan`, the one loop
over time: ``RNN(cell)`` runs its cell through it, and a fused layer
with ``fused = False`` (a switch for the tests' plain comparison) runs
its cells' arithmetic through it.

As in paddle_tpu (and unlike upstream Paddle), ``dropout`` between
layers is accepted and ignored, and so is ``sequence_length`` (every
sequence runs its full length).
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import apply
from ...core.placement import device as _resolve_device
from ...core.tensor import wrap
from ...ops.manipulation import concat, stack, transpose
from .. import initializer as I
from ..layer_base import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
           "SimpleRNN", "LSTM", "GRU", "RNN", "BiRNN"]

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


# -- one step of each cell (the plain arithmetic, paddle_tpu's order) ---
# torch's functions throughout: on a paddle Tensor a method of the same
# name may be paddle's
def _affine(x, w, b):
    return torch.matmul(x, torch.t(w)) + b


def _simple_step(x, h, wi, wh, bi, bh, relu=False):
    z = _affine(x, wi, bi) + _affine(h, wh, bh)
    return torch.relu(z) if relu else torch.tanh(z)


def _lstm_step(x, h, c, wi, wh, bi, bh):
    gates = _affine(x, wi, bi) + _affine(h, wh, bh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    return o * torch.tanh(c), c


def _gru_step(x, h, wi, wh, bi, bh):
    xr, xz, xc = torch.chunk(_affine(x, wi, bi), 3, dim=-1)
    hr, hz, hc = torch.chunk(_affine(h, wh, bh), 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)
    return (1 - z) * c + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``[B, hidden_size]`` filled with ``init_value``, ``B`` from
        ``batch_ref``'s dim ``batch_dim_idx``, on its device."""
        b = batch_ref.shape[batch_dim_idx]
        return wrap(torch.full((b, self.hidden_size), float(init_value),
                               dtype=batch_ref.dtype,
                               device=batch_ref.device))

    def _make_weights(self, gates, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr, device):
        dev = _resolve_device(device)
        u = I.Uniform(-1.0 / math.sqrt(hidden_size),
                      1.0 / math.sqrt(hidden_size))
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, default_initializer=u,
            device=dev)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, default_initializer=u,
            device=dev)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, is_bias=True, default_initializer=u,
            device=dev)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, is_bias=True, default_initializer=u,
            device=dev)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None):
        super().__init__()
        self.activation = activation
        self._make_weights(1, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = apply(_simple_step, inputs, states, *self._weights(),
                  op_name="simple_rnn_cell",
                  attrs={"relu": self.activation != "tanh"})
        return h, h


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o; returns ``(h', (h', c'))``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None):
        super().__init__()
        self._make_weights(4, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        h, c = apply(_lstm_step, inputs, h, c, *self._weights(),
                     op_name="lstm_cell")
        return h, (h, c)


class GRUCell(RNNCellBase):
    """Gates r, z, c; ``h' = (1 - z) * c + z * h``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None):
        super().__init__()
        self._make_weights(3, input_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           device)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = apply(_gru_step, inputs, states, *self._weights(),
                  op_name="gru_cell")
        return h, h


# -- the fused layers ---------------------------------------------------
def _rnn_fused(x, h0, c0, *flat, mode, num_layers, bidirectional,
               batch_first):
    """torch's recurrent op over every layer and direction."""
    train = torch.is_grad_enabled()
    if mode == "LSTM":
        return torch._VF.lstm(x, (h0, c0), list(flat), True, num_layers,
                              0.0, train, bidirectional, batch_first)
    fn = {"GRU": torch._VF.gru, "RNN_TANH": torch._VF.rnn_tanh,
          "RNN_RELU": torch._VF.rnn_relu}[mode]
    return fn(x, h0, list(flat), True, num_layers, 0.0, train,
              bidirectional, batch_first)


def _scan(step, xs, state, reverse=False):
    """paddle_tpu's ``lax.scan``, unrolled: ``step(x_t, state) -> (y_t,
    state)`` over the time steps ``xs`` (last first when ``reverse``);
    the outputs in time order and the final state.  The one per-step
    recurrence: ``RNN`` runs its cell through it, and a fused layer with
    ``fused = False`` its cells' arithmetic."""
    ys = [None] * len(xs)
    for t in (reversed(range(len(xs))) if reverse else range(len(xs))):
        ys[t], state = step(xs[t], state)
    return ys, state


def _layer_step(mode, wi, wh, bi, bh):
    """One step of a fused layer's direction over the state ``(h, c)``
    (``c`` is carried through unused but by an LSTM)."""
    def step(x, state):
        h, c = state
        if mode == "LSTM":
            h, c = _lstm_step(x, h, c, wi, wh, bi, bh)
        elif mode == "GRU":
            h = _gru_step(x, h, wi, wh, bi, bh)
        else:
            h = _simple_step(x, h, wi, wh, bi, bh, mode == "RNN_RELU")
        return h, (h, c)
    return step


def _rnn_steps(x, h0, c0, *flat, mode, num_layers, bidirectional,
               batch_first):
    """The same function as :func:`_rnn_fused` one time step at a time,
    through :func:`_scan`."""
    dirs = 2 if bidirectional else 1
    out = torch.transpose(x, 0, 1) if batch_first else x    # [T, B, F]
    h0s, c0s = torch.unbind(h0), torch.unbind(c0)
    hs, cs = [], []
    for layer in range(num_layers):
        xs = torch.unbind(out)
        ys_dir = []
        for d in range(dirs):
            k = layer * dirs + d
            ys, (h, c) = _scan(_layer_step(mode, *flat[4 * k:4 * k + 4]),
                               xs, (h0s[k], c0s[k]), reverse=d == 1)
            hs.append(h)
            cs.append(c)
            ys_dir.append(torch.stack(ys))
        out = ys_dir[0] if dirs == 1 else torch.cat(ys_dir, dim=-1)
    if batch_first:
        out = torch.transpose(out, 0, 1)
    if mode == "LSTM":
        return out, torch.stack(hs), torch.stack(cs)
    return out, torch.stack(hs)


class _RNNBase(Layer):
    # a reference switch, not a public option: False runs the per-step
    # recurrence (:func:`_rnn_steps`), the plain comparison that the
    # tests and chip_smoke.py hold the fused op against
    fused = True

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None):
        super().__init__()
        dev = _resolve_device(device)
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout                 # ignored, as in paddle_tpu
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        g = _GATES[mode] * hidden_size
        u = I.Uniform(-1.0 / math.sqrt(hidden_size),
                      1.0 / math.sqrt(hidden_size))
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                suffix = "_reverse" if d == 1 else ""
                w = (self.create_parameter([g, in_sz], weight_ih_attr,
                                           default_initializer=u,
                                           device=dev),
                     self.create_parameter([g, hidden_size], weight_hh_attr,
                                           default_initializer=u,
                                           device=dev),
                     self.create_parameter([g], bias_ih_attr, is_bias=True,
                                           default_initializer=u,
                                           device=dev),
                     self.create_parameter([g], bias_hh_attr, is_bias=True,
                                           default_initializer=u,
                                           device=dev))
                for kind, p in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), w):
                    self.add_parameter(f"{kind}_l{layer}{suffix}", p)
                self._all_weights.append(w)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, final_states)``; ``sequence_length`` is ignored,
        as in paddle_tpu."""
        is_lstm = self.mode == "LSTM"
        n = self.num_layers * self.num_directions
        b = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            zeros = wrap(torch.zeros((n, b, self.hidden_size),
                                     dtype=inputs.dtype,
                                     device=inputs.device))
            h0, c0 = zeros, zeros
        elif is_lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, initial_states
        flat = [p for w in self._all_weights for p in w]
        attrs = {"mode": self.mode, "num_layers": self.num_layers,
                 "bidirectional": self.num_directions == 2,
                 "batch_first": not self.time_major}
        res = apply(_rnn_fused if self.fused else _rnn_steps, inputs, h0,
                    c0, *flat, op_name=self.mode.lower(), attrs=attrs)
        if is_lstm:
            out, h, c = res
            return out, (h, c)
        return res[0], res[1]

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, "
                f"direction={self.direction!r}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


# -- cell-driven wrappers ------------------------------------------------
class RNN(Layer):
    """Runs ``cell`` over time, one paddle op a step (a Python loop);
    ``sequence_length`` is ignored, as in paddle_tpu."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else transpose(inputs, [1, 0, 2])
        outs, state = _scan(self.cell, [x[t] for t in range(x.shape[0])],
                            initial_states, self.is_reverse)
        y = stack(outs, axis=0)
        if not self.time_major:
            y = transpose(y, [1, 0, 2])
        return y, state


class BiRNN(Layer):
    """A forward and a reverse :class:`RNN`; outputs concatenated on the
    last dim, states ``(forward's, reverse's)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        y_fw, s_fw = self.rnn_fw(inputs, states_fw)
        y_bw, s_bw = self.rnn_bw(inputs, states_bw)
        return concat([y_fw, y_bw], axis=-1), (s_fw, s_bw)
