"""fluid 1.6 cell-based RNN API (counterpart of
paddle_tpu/layers/rnn_api.py; ref python/paddle/fluid/layers/rnn.py:
RNNCell/GRUCell/LSTMCell, rnn(), lstm(), dynamic_lstmp(), Decoder,
BeamSearchDecoder, dynamic_decode(), beam_search(), beam_search_decode()).

``rnn(cell, ...)`` records ONE step of the cell inside a DynamicRNN
block and lowers to a single differentiable ``recurrent_scan`` op
(ops/control_flow_ops.py), with dense+lengths padding semantics: padded
steps freeze the state carry and zero the outputs, so the returned final
states are the states at each row's last valid step. Its trip count is
the input's time axis, fixed at build time, so it runs inside the
Executor's CUDA graph. Cell parameters are created on first call with
names pinned per cell instance, so one cell can be reused across
unrolled decoders.
"""
import collections

from ..framework import unique_name
from . import nn as _nn
from . import ops as _ops
from . import tensor as _tensor
from .control_flow import DynamicRNN

__all__ = ["RNNCell", "GRUCell", "LSTMCell", "rnn", "lstm",
           "dynamic_lstmp", "Decoder", "BeamSearchDecoder",
           "dynamic_decode", "beam_search", "beam_search_decode"]


def _flatten(structure):
    if isinstance(structure, (list, tuple)):
        out = []
        for s in structure:
            out.extend(_flatten(s))
        return out
    return [structure]


def _pack_as(structure, flat):
    it = iter(flat)

    def walk(s):
        if isinstance(s, (list, tuple)):
            return type(s)(walk(x) for x in s)
        return next(it)

    return walk(structure)


class RNNCell(object):
    """Base cell (ref rnn.py:48): ``call(inputs, states) -> (outputs,
    new_states)``; ``get_initial_states`` builds zero states shaped per
    ``state_shape`` with the batch dim taken from ``batch_ref``."""

    def call(self, inputs, states, **kwargs):
        raise NotImplementedError("RNNCell must implement call().")

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    @property
    def state_shape(self):
        raise NotImplementedError(
            "cell has no state_shape; pass shape= to get_initial_states")

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        batch_ref = _flatten(batch_ref)[0]
        shapes = self.state_shape if shape is None else shape
        dtype = dtype or "float32"
        nested = shapes if isinstance(shapes[0], (list, tuple)) \
            else [shapes]
        outs = []
        for s in nested:
            full = list(s) if s and s[0] == -1 else [-1] + list(s)
            outs.append(_tensor.fill_constant_batch_size_like(
                batch_ref, shape=full, dtype=dtype, value=init_value))
        return outs[0] if len(outs) == 1 else outs


class GRUCell(RNNCell):
    """Single-step GRU (ref rnn.py GRUCell): state = hidden (B, H);
    outputs = new hidden."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="gru_cell"):
        self.hidden_size = hidden_size
        self._uid = unique_name.generate(name)
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_act = gate_activation or "sigmoid"
        self._act = activation or "tanh"
        self._dtype = dtype

    def _attr(self, suffix, base):
        """Pin a per-cell name; honor a user initializer if given."""
        from ..param_attr import ParamAttr
        attr = ParamAttr(name=self._uid + suffix)
        if base is not None and getattr(base, "initializer", None):
            attr.initializer = base.initializer
        return attr

    @property
    def state_shape(self):
        return [self.hidden_size]

    def call(self, inputs, states):
        h = self.hidden_size
        gates = _nn.fc(
            _tensor.concat([inputs, states], axis=-1), size=2 * h,
            act=self._gate_act,
            param_attr=self._attr("_gate_w", self._param_attr),
            bias_attr=self._attr("_gate_b", self._bias_attr))
        u = _nn.slice(gates, axes=[1], starts=[0], ends=[h])
        r = _nn.slice(gates, axes=[1], starts=[h], ends=[2 * h])
        cand = _nn.fc(
            _tensor.concat([inputs, _nn.elementwise_mul(r, states)],
                           axis=-1),
            size=h, act=self._act,
            param_attr=self._attr("_cand_w", self._param_attr),
            bias_attr=self._attr("_cand_b", self._bias_attr))
        ones = _nn.scale(u, scale=-1.0, bias=1.0)
        new_h = _nn.elementwise_add(_nn.elementwise_mul(u, states),
                                    _nn.elementwise_mul(ones, cand))
        return new_h, new_h


class LSTMCell(RNNCell):
    """Single-step LSTM (ref rnn.py LSTMCell): states = [h, c];
    outputs = new h."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32", name="lstm_cell"):
        self.hidden_size = hidden_size
        self._uid = unique_name.generate(name)
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_act = gate_activation or "sigmoid"
        self._act = activation or "tanh"
        self._forget_bias = forget_bias
        self._dtype = dtype

    _attr = GRUCell._attr

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]

    def call(self, inputs, states):
        pre_h, pre_c = states
        h = self.hidden_size
        gact = getattr(_ops, self._gate_act)
        act = getattr(_ops, self._act)
        gates = _nn.fc(
            _tensor.concat([inputs, pre_h], axis=-1), size=4 * h,
            param_attr=self._attr("_w", self._param_attr),
            bias_attr=self._attr("_b", self._bias_attr))
        i = gact(_nn.slice(gates, axes=[1], starts=[0], ends=[h]))
        f = gact(_nn.scale(
            _nn.slice(gates, axes=[1], starts=[h], ends=[2 * h]),
            bias=self._forget_bias))
        c_t = act(_nn.slice(gates, axes=[1], starts=[2 * h],
                            ends=[3 * h]))
        o = gact(_nn.slice(gates, axes=[1], starts=[3 * h],
                           ends=[4 * h]))
        new_c = _nn.elementwise_add(_nn.elementwise_mul(f, pre_c),
                                    _nn.elementwise_mul(i, c_t))
        new_h = _nn.elementwise_mul(o, act(new_c))
        return new_h, [new_h, new_c]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Scan ``cell`` over time (ref rnn.py:363) -> (outputs,
    final_states).  One ``recurrent_scan``; padded steps (per
    sequence_length) freeze the state and zero the outputs."""
    from .sequence_lod import sequence_reverse
    if time_major:
        inputs = _nn.transpose(inputs, perm=[1, 0, 2])
    if initial_states is None:
        initial_states = cell.get_initial_states(inputs)
    flat_init = _flatten(initial_states)
    length_aware_reverse = is_reverse and sequence_length is not None
    if length_aware_reverse:
        inputs = sequence_reverse(inputs, lengths=sequence_length)
    elif is_reverse:
        from .tensor import reverse
        inputs = reverse(inputs, axis=[1])

    drnn = DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(inputs, lengths=sequence_length)
        mems = [drnn.memory(init=s) for s in flat_init]
        out, new_states = cell(x_t, _pack_as(initial_states, mems),
                               **kwargs)
        flat_new = _flatten(new_states)
        for m, ns in zip(mems, flat_new):
            drnn.update_memory(m, ns)
        outs = out if isinstance(out, (list, tuple)) else [out]
        drnn.output(*outs)
    outputs = drnn()
    final_states = _pack_as(initial_states, drnn.final_states())
    seq_outs = outputs if isinstance(outputs, list) else [outputs]
    if length_aware_reverse:
        seq_outs = [sequence_reverse(o, lengths=sequence_length)
                    for o in seq_outs]
    elif is_reverse:
        from .tensor import reverse
        seq_outs = [reverse(o, axis=[1]) for o in seq_outs]
    if time_major:
        seq_outs = [_nn.transpose(o, perm=[1, 0, 2]) for o in seq_outs]
    final_outputs = seq_outs[0] if not isinstance(out, (list, tuple)) \
        else type(out)(seq_outs)
    return final_outputs, final_states


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Multi-layer (bi)LSTM (ref rnn.py:1337, the cuDNN-LSTM wrapper):
    input (B, T, D); init_h/init_c (num_layers*dirs, B, H).  Built on
    contrib basic_lstm (its ``lstm_seq`` op, one per layer and
    direction), not a cuDNN call.  ``seed`` is ignored (dropout masks
    come from the framework's deterministic per-op generator).  Returns
    (rnn_out, last_h, last_c)."""
    if default_initializer is not None:
        raise NotImplementedError(
            "lstm(default_initializer=...) is not supported; set "
            "initializers via ParamAttr on a cell-based rnn() instead")
    from ..contrib.layers import basic_lstm
    out, last_h, last_c = basic_lstm(
        input, init_h, init_c, hidden_size, num_layers=num_layers,
        dropout_prob=0.0 if is_test else dropout_prob,
        bidirectional=is_bidirec, batch_first=True, dtype=input.dtype)
    return out, last_h, last_c


def dynamic_lstmp(input, size, proj_size, param_attr=None,
                  bias_attr=None, use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None):
    """LSTM with recurrent projection (ref rnn.py:1512 / dynamic_lstmp
    op): input (B, T, 4*H) pre-projected like dynamic_lstm; the hidden
    state is projected to ``proj_size`` before recurrence.  Returns
    (projection (B, T, P), cell (B, T, H))."""
    if use_peepholes:
        raise NotImplementedError(
            "dynamic_lstmp use_peepholes is not implemented, as in "
            "the JAX package; pass use_peepholes=False")
    from ..param_attr import ParamAttr
    hidden = size // 4
    uid = unique_name.generate(name or "lstmp")

    class _LSTMPCell(RNNCell):
        @property
        def state_shape(self):
            return [[proj_size], [hidden]]

        def call(self, x_t, states):
            pre_p, pre_c = states
            gates = _nn.elementwise_add(
                x_t, _nn.fc(pre_p, size=4 * hidden, bias_attr=False,
                            param_attr=ParamAttr(name=uid + "_rw")))
            gact = getattr(_ops, gate_activation)
            cact = getattr(_ops, candidate_activation)
            i = gact(_nn.slice(gates, axes=[1], starts=[0],
                               ends=[hidden]))
            f = gact(_nn.slice(gates, axes=[1], starts=[hidden],
                               ends=[2 * hidden]))
            c_t = cact(_nn.slice(gates, axes=[1],
                                 starts=[2 * hidden],
                                 ends=[3 * hidden]))
            o = gact(_nn.slice(gates, axes=[1],
                               starts=[3 * hidden],
                               ends=[4 * hidden]))
            new_c = _nn.elementwise_add(
                _nn.elementwise_mul(f, pre_c),
                _nn.elementwise_mul(i, c_t))
            new_h = _nn.elementwise_mul(o, _ops.tanh(new_c))
            proj = _nn.fc(new_h, size=proj_size, bias_attr=False,
                          act=None if proj_activation == "identity"
                          else proj_activation,
                          param_attr=ParamAttr(name=uid + "_pw"))
            return [proj, new_c], [proj, new_c]

    outs, _finals = rnn(_LSTMPCell(), input, is_reverse=is_reverse)
    return outs[0], outs[1]

# ---------------------------------------------------------------------------
# Decoder protocol + beam search (ref rnn.py:492 Decoder, :588
# BeamSearchDecoder, :1040 dynamic_decode).  dynamic_decode unrolls
# max_step_num steps at build time over a dense (batch*beam) axis — the
# same design as contrib.decoder, with the tf-style cell/step protocol.
# ---------------------------------------------------------------------------


def _gather_rows(x, idx, group, stride=None):
    """Grouped gather: the i-th selection (of ``group`` per batch row)
    picks element idx[i] within that row's block of ``stride`` rows of
    ``x`` (stride defaults to group — the square beam-gather case)."""
    stride = group if stride is None else stride
    flat_sel = _nn.reshape(idx, [-1])
    ones = _tensor.fill_constant_batch_size_like(
        flat_sel, [-1], "int64", 1)
    pos = _nn.cumsum(ones, axis=0, exclusive=True)
    g_const = _tensor.fill_constant([1], "int64", group)
    s_const = _tensor.fill_constant([1], "int64", stride)
    row = _nn.elementwise_mul(
        _nn.elementwise_floordiv(pos, g_const), s_const)
    return _nn.gather(x, _nn.elementwise_add(flat_sel, row))


class Decoder(object):
    """Step-decoder protocol (ref rnn.py:492)."""

    def initialize(self, inits):
        """-> (initial_inputs, initial_states, initial_finished)."""
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        """-> (outputs, next_states, next_inputs, next_finished)."""
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        """-> (final_outputs, final_states); default passthrough."""
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam-search decoder over an RNNCell (ref rnn.py:588).

    Dense contract: states/ids carry a flattened batch*beam leading dim;
    ``embedding_fn`` maps (batch*beam,) int64 ids -> cell inputs and
    ``output_fn`` maps cell outputs -> vocab logits.
    """

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished",
                         "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        if embedding_fn is None:
            raise ValueError(
                "BeamSearchDecoder needs embedding_fn: a callable "
                "mapping (batch*beam, 1) int64 ids to cell inputs")
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self._neg_inf = -1e9

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B*beam, ...) repeating rows (ref :663)."""
        shape = list(x.shape)
        expanded = _nn.expand(_nn.unsqueeze(x, axes=[1]),
                              [1, beam_size] + [1] * (len(shape) - 1))
        return _nn.reshape(expanded, [-1] + shape[1:])

    def initialize(self, initial_cell_states):
        b = self.beam_size
        flat = _flatten(initial_cell_states)
        tiled = [self.tile_beam_merge_with_batch(s, b) for s in flat]
        cell_states = _pack_as(initial_cell_states, tiled)
        ref = flat[0]
        ids = _tensor.fill_constant_batch_size_like(
            ref, shape=[-1, b], dtype="int64", value=self.start_token)
        first = _tensor.fill_constant_batch_size_like(
            ref, shape=[-1, 1], dtype="float32", value=0.0)
        log_probs = first
        if b > 1:
            dead = _tensor.fill_constant_batch_size_like(
                ref, shape=[-1, b - 1], dtype="float32",
                value=self._neg_inf)
            log_probs = _tensor.concat([first, dead], axis=1)
        finished = _tensor.fill_constant_batch_size_like(
            ref, shape=[-1, b], dtype="float32", value=0.0)
        lengths = _tensor.fill_constant_batch_size_like(
            ref, shape=[-1, b], dtype="int64", value=0)
        inputs = self.embedding_fn(_nn.reshape(ids, [-1, 1]))
        state = self.StateWrapper(cell_states, log_probs, finished,
                                  lengths)
        return inputs, state, finished

    def _gather_flat(self, x, beam_idx):
        """Gather along winning beams: x (B*beam, ...), beam_idx (B, beam)
        int64 -> gathered (B*beam, ...)."""
        return _gather_rows(x, beam_idx, self.beam_size)

    def _beam_search_step(self, time, logits, next_cell_states, state):
        b = self.beam_size
        v = logits.shape[-1]
        logp = _nn.log_softmax(logits) if hasattr(_nn, "log_softmax") \
            else _ops.log(_nn.softmax(logits))
        logp = _nn.reshape(logp, [-1, b, v])
        # finished beams may only emit end_token at zero added cost
        end_const = _tensor.fill_constant([1], "int64", self.end_token)
        end_onehot = _nn.reshape(
            _nn.one_hot(_nn.reshape(end_const, [1, 1]), v), [1, 1, v])
        end_row = _nn.scale(_nn.scale(end_onehot, scale=-1.0, bias=1.0),
                            scale=self._neg_inf)
        fin3 = _nn.unsqueeze(state.finished, [2])
        live3 = _nn.scale(fin3, scale=-1.0, bias=1.0)
        logp = _nn.elementwise_add(
            _nn.elementwise_mul(logp, live3),
            _nn.elementwise_mul(end_row, fin3))
        total = _nn.elementwise_add(
            logp, _nn.unsqueeze(state.log_probs, [2]))
        scores, top = _nn.topk(_nn.reshape(total, [-1, b * v]), k=b)
        v_const = _tensor.fill_constant([1], "int64", v)
        parent = _nn.elementwise_floordiv(top, v_const)    # (B, b)
        ids = _nn.elementwise_mod(top, v_const)
        # gather state along winning beams
        flat_new = [self._gather_flat(s, parent)
                    for s in _flatten(next_cell_states)]
        cell_states = _pack_as(next_cell_states, flat_new)
        prev_fin = _nn.reshape(
            self._gather_flat(_nn.reshape(state.finished, [-1, 1]),
                              parent), [-1, b])
        prev_len = _nn.reshape(
            self._gather_flat(_nn.reshape(state.lengths, [-1, 1]),
                              parent), [-1, b])
        now_end = _tensor.cast(
            _compare_eq(ids, end_const), "float32")
        finished = _nn.elementwise_max(prev_fin, now_end)
        live = _nn.scale(prev_fin, scale=-1.0, bias=1.0)
        lengths = _nn.elementwise_add(
            prev_len, _tensor.cast(live, "int64"))
        out = self.OutputWrapper(scores, ids, parent)
        new_state = self.StateWrapper(cell_states, scores, finished,
                                      lengths)
        return out, new_state

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell = self.cell(inputs, states.cell_states,
                                        **kwargs)
        logits = self.output_fn(cell_out) if self.output_fn is not None \
            else cell_out
        out, new_state = self._beam_search_step(time, logits, next_cell,
                                                states)
        next_inputs = self.embedding_fn(
            _nn.reshape(out.predicted_ids, [-1, 1]))
        return out, new_state, next_inputs, new_state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Back-trace parent_ids into coherent sequences: returns
        (predicted_ids (B, beam, T), final_states)."""
        seqs, _ = beam_search_decode(
            outputs.predicted_ids, outputs.parent_ids,
            beam_size=self.beam_size, end_id=self.end_token)
        return seqs, final_states


def _compare_eq(x, y):
    from .control_flow import equal
    return equal(x, y)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kwargs):
    """Run ``decoder`` until max_step_num (ref rnn.py:1040).  The loop
    is UNROLLED at build time (a fixed trip count, as in the JAX package,
    so a decode is one CUDA graph); early finish is handled by the
    decoder's finished-masking, so results match the reference's dynamic
    while loop.  Returns (final_outputs, final_states)."""
    if max_step_num is None:
        max_step_num = 64
    inputs, states, finished = decoder.initialize(inits)
    step_outputs = []
    for t in range(int(max_step_num)):
        out, states, inputs, finished = decoder.step(t, inputs, states,
                                                     **kwargs)
        step_outputs.append(out)
    if step_outputs and hasattr(step_outputs[0], "_fields"):
        cols = type(step_outputs[0])(
            *[[getattr(o, f) for o in step_outputs]
              for f in step_outputs[0]._fields])
    else:
        cols = step_outputs
    final_outputs, final_states = decoder.finalize(
        cols, states, getattr(states, "lengths", None))
    if output_time_major and hasattr(final_outputs, "shape") and \
            final_outputs.shape is not None and \
            len(final_outputs.shape) == 3:
        # (B, beam, T) -> (T, B, beam)
        final_outputs = _nn.transpose(final_outputs, perm=[2, 0, 1])
    return final_outputs, final_states


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam expansion step (ref nn.py beam_search /
    operators/beam_search_op).  Dense contract (no LoD): ``scores``
    (batch*beam, K) candidate scores (accumulated when
    ``is_accumulated``, else per-step log-probs added to ``pre_scores``),
    ``ids`` (batch*beam, K) their token ids, ``pre_ids`` (batch*beam, 1)
    previous tokens (frozen rows, i.e. pre_id == end_id, only re-emit
    end_id at no cost).  Returns (selected_ids (batch*beam, 1),
    selected_scores (batch*beam, 1)[, parent_idx (batch*beam,)]),
    best-first within each batch row.
    """
    b = int(beam_size)
    k = scores.shape[-1]
    if not is_accumulated:
        scores = _nn.elementwise_add(scores, pre_scores)
    end_const = _tensor.fill_constant([1], "int64", end_id)
    fin = _tensor.cast(_compare_eq(_nn.reshape(pre_ids, [-1, 1]),
                                   end_const), "float32")   # (B*b, 1)
    is_end = _tensor.cast(_compare_eq(ids, end_const), "float32")
    # frozen rows: only the end_id candidate stays viable, at pre_score
    keep = _nn.elementwise_mul(is_end, fin)
    alive = _nn.scale(fin, scale=-1.0, bias=1.0)
    neg = _tensor.fill_constant([1], "float32", -1e9)
    scores = _nn.elementwise_add(
        _nn.elementwise_mul(scores, alive),
        _nn.elementwise_add(
            _nn.elementwise_mul(_nn.expand(pre_scores, [1, k]), keep),
            _nn.elementwise_mul(
                _nn.scale(_nn.elementwise_max(keep, alive), scale=-1.0,
                          bias=1.0), _nn.expand(
                    _nn.reshape(neg, [1, 1]), [1, k]))))
    flat_scores = _nn.reshape(scores, [-1, b * k])       # (B, b*K)
    flat_ids = _nn.reshape(ids, [-1, b * k])
    sel_scores, top = _nn.topk(flat_scores, k=b)          # (B, b)
    k_const = _tensor.fill_constant([1], "int64", k)
    parent = _nn.elementwise_floordiv(top, k_const)       # beam index
    # gather the chosen token ids out of the candidate table: top
    # indexes within each batch row's b*K candidates
    sel_ids = _nn.reshape(
        _gather_rows(_nn.reshape(flat_ids, [-1]),
                     _nn.reshape(top, [-1]), group=b, stride=b * k),
        [-1, 1])
    sel_scores = _nn.reshape(sel_scores, [-1, 1])
    if return_parent_idx:
        return sel_ids, sel_scores, _nn.reshape(parent, [-1])
    return sel_ids, sel_scores


def beam_search_decode(ids, parent_ids, beam_size, end_id, scores=None,
                       name=None):
    """Back-trace per-step beam selections into whole sequences
    (ref nn.py beam_search_decode / beam_search_decode_op).  Dense
    contract (no LoD): ``ids`` is a list of T (batch*beam, 1)
    selected-id tensors and ``parent_ids`` a list of T (batch*beam,)
    parent indices, both from ``beam_search(...,
    return_parent_idx=True)`` (parent_ids[0] may be None).  Returns
    (sentence_ids (batch, beam, T), sentence_scores (batch, beam) —
    the last step's selected scores when ``scores`` is given, else
    None).
    """
    b = int(beam_size)
    hist = None
    for t, step_ids in enumerate(ids):
        new_ids = _nn.reshape(step_ids, [-1, 1])
        if hist is None:
            hist = new_ids
        else:
            hist = _tensor.concat(
                [_gather_rows(hist, parent_ids[t], b), new_ids], axis=1)
    T = len(ids)
    sent_scores = None if not scores else _nn.reshape(scores[-1], [-1, b])
    return _nn.reshape(hist, [-1, b, T]), sent_scores
