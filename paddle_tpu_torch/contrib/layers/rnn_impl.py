"""Multi-layer, bidirectional RNN compositions (counterpart of
paddle_tpu/contrib/layers/rnn_impl.py; reference
python/paddle/fluid/contrib/layers/rnn_impl.py).

Each direction of each layer is one ``gru_seq`` or ``lstm_seq`` op over
the whole sequence. With ``sequence_length`` the backward direction of
a padded batch reverses each valid prefix (``sequence_reverse``), scans
forward, masks the padded steps (``sequence_mask``) and reverses back;
the last state is gathered through ``one_hot(length - 1, T)`` and a
``matmul``. A row of length 0 has index -1, whose one-hot row is zeros,
so its last state is zeros.

The last-state chain (a ``one_hot``, a ``matmul`` and a ``squeeze`` per
direction and the final ``stack``) is always built, as in the JAX
package, even where no head reads it; the Executor runs it (XLA drops
it in the JAX package). ``BasicGRUUnit`` and ``BasicLSTMUnit`` are
the dygraph cells (one step, ``apply_eager`` over plain torch ops, as the
JAX package's are jnp).

Returns match the reference: basic_gru -> (rnn_out, last_hidden);
basic_lstm -> (rnn_out, last_hidden, last_cell); last states have shape
(num_layers * num_directions, batch, hidden).
"""
import torch

from ... import layers
from ...dygraph.base import apply_eager
from ...dygraph.layers import Layer

__all__ = ["BasicGRUUnit", "basic_gru", "BasicLSTMUnit", "basic_lstm"]


def _sigmoid(v):
    return 1.0 / (1.0 + torch.exp(-v))


class BasicGRUUnit(Layer):
    """Single-step GRU cell for dygraph (paddle_tpu's :23, ref
    rnn_impl.py:22). forward(input (N, D), pre_hidden (N, H)) ->
    new_hidden."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        super(BasicGRUUnit, self).__init__(dtype=dtype)
        self._hidden_size = hidden_size
        self._gate_act = gate_activation or "sigmoid"
        self._act = activation or "tanh"
        self._dtype = dtype
        self._built = False

    def _build_once(self, input):
        d = input.shape[-1]
        h = self._hidden_size
        self._gate_weight = self.add_parameter(
            "gate_weight", self.create_parameter([d + h, 2 * h]))
        self._candidate_weight = self.add_parameter(
            "candidate_weight", self.create_parameter([d + h, h]))
        self._gate_bias = self.add_parameter(
            "gate_bias", self.create_parameter([2 * h], is_bias=True))
        self._candidate_bias = self.add_parameter(
            "candidate_bias", self.create_parameter([h], is_bias=True))
        self._built = True

    def forward(self, input, pre_hidden):
        if not self._built:
            self._build_once(input)
        h = self._hidden_size

        def step(x, hp, gw, gb, cw, cb):
            gates = torch.matmul(torch.cat([x, hp], dim=-1), gw) + gb
            gates = _sigmoid(gates) if self._gate_act == "sigmoid" \
                else torch.tanh(gates)
            u, r = gates[..., :h], gates[..., h:]
            c = torch.matmul(torch.cat([x, r * hp], dim=-1), cw) + cb
            c = torch.tanh(c) if self._act == "tanh" else _sigmoid(c)
            return u * hp + (1.0 - u) * c

        return apply_eager(step, input, pre_hidden, self._gate_weight,
                           self._gate_bias, self._candidate_weight,
                           self._candidate_bias)


class BasicLSTMUnit(Layer):
    """Single-step LSTM cell for dygraph (paddle_tpu's :76, ref
    rnn_impl.py:632). forward(input, pre_hidden, pre_cell) ->
    (new_hidden, new_cell)."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super(BasicLSTMUnit, self).__init__(dtype=dtype)
        self._hidden_size = hidden_size
        self._forget_bias = forget_bias
        self._built = False

    def _build_once(self, input):
        d = input.shape[-1]
        h = self._hidden_size
        self._weight = self.add_parameter(
            "weight", self.create_parameter([d + h, 4 * h]))
        self._bias = self.add_parameter(
            "bias", self.create_parameter([4 * h], is_bias=True))
        self._built = True

    def forward(self, input, pre_hidden, pre_cell):
        if not self._built:
            self._build_once(input)
        h = self._hidden_size
        fb = self._forget_bias

        def step(x, hp, cp, w, b):
            gates = torch.matmul(torch.cat([x, hp], dim=-1), w) + b
            i, f, c, o = (gates[..., :h], gates[..., h:2 * h],
                          gates[..., 2 * h:3 * h], gates[..., 3 * h:])
            new_c = cp * _sigmoid(f + fb) + _sigmoid(i) * torch.tanh(c)
            new_h = torch.tanh(new_c) * _sigmoid(o)
            return new_h, new_c

        return apply_eager(step, input, pre_hidden, pre_cell,
                           self._weight, self._bias)


def _slice_init(init, idx, batch, hidden):
    """init: (L * dirs, N, H) -> the (N, H) slice of layer/direction
    idx."""
    if init is None:
        return None
    s = layers.slice(init, axes=[0], starts=[idx], ends=[idx + 1])
    return layers.reshape(s, [batch, hidden])


def _gather_steps(seq_out, idx):
    """(N, 1, H): each row's step ``idx`` of seq_out (N, T, H), by a
    one-hot over time and a matmul (a static-shape gather)."""
    t = seq_out.shape[1]
    oh = layers.one_hot(layers.unsqueeze(idx, axes=[1]), t)
    oh = layers.reshape(oh, [seq_out.shape[0], 1, t])
    return layers.matmul(oh, seq_out)


def _len_minus_one(sequence_length):
    lengths = layers.cast(sequence_length, "int64")
    return layers.elementwise_sub(
        lengths, layers.fill_constant([1], "int64", 1))


def _one_direction(x, init_h, init_c, hidden_size, is_reverse, cell_type,
                   param_attr, bias_attr, dtype, sequence_length):
    """x: (N, T, D) -> (out (N, T, H), last_h, last_c or None)."""
    from ...layers.sequence_lod import sequence_reverse
    length_aware_reverse = is_reverse and sequence_length is not None
    if length_aware_reverse:
        x = sequence_reverse(x, lengths=sequence_length)
        is_reverse = False
    if cell_type == "gru":
        proj = layers.fc(x, size=3 * hidden_size, num_flatten_dims=2,
                         param_attr=param_attr, bias_attr=False)
        out = layers.dynamic_gru(proj, hidden_size, param_attr=param_attr,
                                 bias_attr=bias_attr,
                                 is_reverse=is_reverse, h_0=init_h,
                                 dtype=dtype)
        cell_seq = None
    else:
        proj = layers.fc(x, size=4 * hidden_size, num_flatten_dims=2,
                         param_attr=param_attr, bias_attr=False)
        out, cell_seq = layers.dynamic_lstm(
            proj, 4 * hidden_size, h_0=init_h, c_0=init_c,
            param_attr=param_attr, bias_attr=bias_attr,
            is_reverse=is_reverse, dtype=dtype)
    if sequence_length is not None:
        # zero the padded steps so that a later pooling ignores them
        mask = layers.cast(
            layers.sequence_mask(sequence_length, maxlen=x.shape[1]),
            dtype)
        mask3 = layers.unsqueeze(mask, axes=[2])
        out = layers.elementwise_mul(out, mask3)
        if cell_seq is not None:
            cell_seq = layers.elementwise_mul(cell_seq, mask3)
    if is_reverse:
        # the last valid state of a full-length reversed scan is step 0
        last_h = layers.squeeze(
            layers.slice(out, axes=[1], starts=[0], ends=[1]), axes=[1])
        last_c = None if cell_seq is None else layers.squeeze(
            layers.slice(cell_seq, axes=[1], starts=[0], ends=[1]),
            axes=[1])
    elif sequence_length is not None:
        # also the length-aware reverse: the scan ran forward over the
        # prefix-reversed input, so its step len - 1 is the reverse
        # direction's final state
        last_h = layers.squeeze(_gather_steps(
            out, _len_minus_one(sequence_length)), axes=[1])
        last_c = None if cell_seq is None else layers.squeeze(
            _gather_steps(cell_seq, _len_minus_one(sequence_length)),
            axes=[1])
    else:
        t = x.shape[1]
        last_h = layers.squeeze(
            layers.slice(out, axes=[1], starts=[t - 1], ends=[t]),
            axes=[1])
        last_c = None if cell_seq is None else layers.squeeze(
            layers.slice(cell_seq, axes=[1], starts=[t - 1], ends=[t]),
            axes=[1])
    if length_aware_reverse:
        # the per-step outputs back in the original time order
        out = sequence_reverse(out, lengths=sequence_length)
        if cell_seq is not None:
            cell_seq = sequence_reverse(cell_seq, lengths=sequence_length)
    return out, last_h, last_c


def _basic_rnn(cell_type, input, init_hidden, init_cell, hidden_size,
               num_layers, sequence_length, dropout_prob, bidirectional,
               batch_first, param_attr, bias_attr, dtype):
    if not batch_first:
        input = layers.transpose(input, perm=[1, 0, 2])
    batch = input.shape[0]
    dirs = 2 if bidirectional else 1
    x = input
    last_hs, last_cs = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            ih = _slice_init(init_hidden, idx, batch, hidden_size)
            ic = _slice_init(init_cell, idx, batch, hidden_size)
            out, lh, lc = _one_direction(
                x, ih, ic, hidden_size, is_reverse=(d == 1),
                cell_type=cell_type, param_attr=param_attr,
                bias_attr=bias_attr, dtype=dtype,
                sequence_length=sequence_length)
            outs.append(out)
            last_hs.append(lh)
            if lc is not None:
                last_cs.append(lc)
        x = outs[0] if dirs == 1 else layers.concat(outs, axis=2)
        if dropout_prob > 0.0 and layer < num_layers - 1:
            x = layers.dropout(x, dropout_prob=dropout_prob)
    rnn_out = x if batch_first else layers.transpose(x, perm=[1, 0, 2])
    last_hidden = layers.stack(last_hs, axis=0)
    last_cell = layers.stack(last_cs, axis=0) if last_cs else None
    return rnn_out, last_hidden, last_cell


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype='float32',
              name='basic_gru'):
    """Multi-layer, optionally bidirectional GRU (reference
    rnn_impl.py:139) -> (rnn_out, last_hidden)."""
    out, last_h, _ = _basic_rnn(
        "gru", input, init_hidden, None, hidden_size, num_layers,
        sequence_length, dropout_prob, bidirectional, batch_first,
        param_attr, bias_attr, dtype)
    return out, last_h


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype='float32', name='basic_lstm'):
    """Multi-layer, optionally bidirectional LSTM (reference
    rnn_impl.py:358) -> (rnn_out, last_hidden, last_cell)."""
    out, last_h, last_c = _basic_rnn(
        "lstm", input, init_hidden, init_cell, hidden_size, num_layers,
        sequence_length, dropout_prob, bidirectional, batch_first,
        param_attr, bias_attr, dtype)
    return out, last_h, last_c
