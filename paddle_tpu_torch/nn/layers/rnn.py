"""Recurrent layers (the port's counterpart of
``paddle_tpu/nn/layers/rnn.py``): the cells, the ``RNN`` / ``BiRNN``
drivers and the ``SimpleRNN`` / ``LSTM`` / ``GRU`` stacks.

The weights keep the JAX package's packed layout, ``weight_ih`` ``[in,
G * H]`` and ``weight_hh`` ``[H, G * H]`` (gates i, f, g, o for the
LSTM; r, z, c for the GRU, whose candidate takes ``r * (W_hh h +
b_hh)``), and its formulas. The time loop runs the cell step by step in
Python, where the JAX package scans it: torch's fused ``nn.LSTM`` /
``nn.GRU`` would need the weights transposed and its own sequence
packing, so the port keeps one loop with the JAX package's masking. A
padded step (past ``sequence_length``) carries the state through and
emits zeros; the reverse direction walks from the last step down.
"""

from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from ..layer import Layer, LayerList


def _uniform_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_size: int, dtype=torch.float32,
                           device=None):
        shape = (batch_size, self.hidden_size)
        if self.state_components == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(self.state_components))

    def _params(self, input_size: int, hidden_size: int, gates: int):
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        self.weight_ih = self.create_parameter(
            [input_size, gates * hidden_size], initializer=init)
        self.weight_hh = self.create_parameter(
            [hidden_size, gates * hidden_size], initializer=init)
        self.bias_ih = self.create_parameter([gates * hidden_size],
                                             initializer=init)
        self.bias_hh = self.create_parameter([gates * hidden_size],
                                             initializer=init)

    def _init_states(self, inputs, states):
        if states is not None:
            return states
        return self.get_initial_states(inputs.shape[0], inputs.dtype,
                                       inputs.device)


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih + b_ih + h W_hh + b_hh)."""

    state_components = 1

    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh"):
        super().__init__()
        self._params(input_size, hidden_size, 1)
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self._act = torch.tanh if activation == "tanh" else torch.relu

    def forward(self, inputs, states=None):
        h = self._init_states(inputs, states)
        h = self._act(inputs @ self.weight_ih + self.bias_ih +
                      h @ self.weight_hh + self.bias_hh)
        return h, h


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o from one packed ``[in, 4H]`` matmul."""

    state_components = 2

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self._params(input_size, hidden_size, 4)

    def forward(self, inputs, states=None):
        h, c = self._init_states(inputs, states)
        gates = inputs @ self.weight_ih + self.bias_ih + \
            h @ self.weight_hh + self.bias_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return h, (h, c)


class GRUCell(RNNCellBase):
    """Gates r, z and candidate c; the reset gate applies to the
    projected hidden state (the cuDNN convention)."""

    state_components = 1

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self._params(input_size, hidden_size, 3)

    def forward(self, inputs, states=None):
        h = self._init_states(inputs, states)
        ir, iz, ic = torch.chunk(inputs @ self.weight_ih + self.bias_ih,
                                 3, dim=-1)
        hr, hz, hc = torch.chunk(h @ self.weight_hh + self.bias_hh, 3,
                                 dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h = (1.0 - z) * c + z * h
        return h, h


def _scan_cell(cell, x_tbf, h0, mask_tb=None, reverse=False):
    """Run ``cell`` over time-major ``[T, B, F]`` input: ``(ys [T, B,
    H], final state)``; under ``mask_tb`` a padded step keeps the state
    and emits zeros."""
    h = h0
    steps = range(x_tbf.shape[0])
    ys = [None] * x_tbf.shape[0]
    for t in (reversed(steps) if reverse else steps):
        out, new_h = cell(x_tbf[t], h)
        if mask_tb is not None:
            keep = mask_tb[t][:, None]
            if isinstance(new_h, tuple):
                new_h = tuple(torch.where(keep, n, o)
                              for n, o in zip(new_h, h))
            else:
                new_h = torch.where(keep, new_h, h)
            out = torch.where(keep, out, torch.zeros_like(out))
        ys[t] = out
        h = new_h
    return torch.stack(ys), h


class RNN(Layer):
    """A cell driver over ``[B, T, F]`` (``[T, B, F]`` when
    ``time_major``)."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        h0 = initial_states if initial_states is not None else \
            self.cell.get_initial_states(x.shape[1], x.dtype, x.device)
        mask = None
        if sequence_length is not None:
            lengths = torch.as_tensor(sequence_length, device=x.device)
            mask = torch.arange(x.shape[0], device=x.device)[:, None] < \
                lengths[None, :]
        ys, hT = _scan_cell(self.cell, x, h0, mask, reverse=self.is_reverse)
        return (ys if self.time_major else ys.transpose(0, 1)), hT


class BiRNN(Layer):
    """Two cell drivers, their outputs concatenated on features."""

    def __init__(self, cell_fw, cell_bw, time_major: bool = False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, h_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        o_bw, h_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([o_fw, o_bw], dim=-1), (h_fw, h_bw)


class _RNNBase(Layer):
    """A multi-layer (optionally bidirectional) stack; the final states
    are ``[L * D, B, H]`` (a tuple of two for the LSTM)."""

    CELL = None

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 time_major: bool = False, dropout: float = 0.0,
                 **cell_kwargs):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.bidirectional = direction != "forward"
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.hidden_size = hidden_size
        self.state_components = self.CELL.state_components
        n_dir = 2 if self.bidirectional else 1
        layers = []
        for i in range(num_layers):
            in_sz = input_size if i == 0 else hidden_size * n_dir
            if self.bidirectional:
                layers.append(BiRNN(self.CELL(in_sz, hidden_size,
                                              **cell_kwargs),
                                    self.CELL(in_sz, hidden_size,
                                              **cell_kwargs),
                                    time_major=time_major))
            else:
                layers.append(RNN(self.CELL(in_sz, hidden_size,
                                            **cell_kwargs),
                                  time_major=time_major))
        self.layers = LayerList(layers)

    def _zero_states(self, batch: int, dtype, device):
        n = self.num_layers * (2 if self.bidirectional else 1)
        shape = (n, batch, self.hidden_size)
        if self.state_components == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(self.state_components))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        b = inputs.shape[1] if self.time_major else inputs.shape[0]
        if initial_states is None:
            initial_states = self._zero_states(b, inputs.dtype,
                                               inputs.device)
        n_dir = 2 if self.bidirectional else 1

        def layer_state(i, d):
            idx = i * n_dir + d
            if self.state_components == 1:
                return initial_states[idx]
            return tuple(s[idx] for s in initial_states)

        x = inputs
        final = []
        for i, layer in enumerate(self.layers):
            states = (layer_state(i, 0), layer_state(i, 1)) \
                if self.bidirectional else layer_state(i, 0)
            x, hT = layer(x, states, sequence_length)
            final.extend(hT if self.bidirectional else [hT])
            if self.dropout and i < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if self.state_components == 1:
            return x, torch.stack(final)
        return x, tuple(torch.stack([f[c] for f in final])
                        for c in range(self.state_components))


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell


class LSTM(_RNNBase):
    CELL = LSTMCell


class GRU(_RNNBase):
    CELL = GRUCell
