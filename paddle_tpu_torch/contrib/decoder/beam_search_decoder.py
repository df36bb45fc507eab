"""Contrib seq2seq decoder API (counterpart of
paddle_tpu/contrib/decoder/beam_search_decoder.py; ref
python/paddle/fluid/contrib/decoder/beam_search_decoder.py).

Same user surface as the reference — InitState / StateCell (with the
``@state_cell.state_updater`` decorator) / TrainingDecoder /
BeamSearchDecoder — with the JAX package's execution model:

* the reference drives a While op over LoD tensor-arrays and the LoD
  ``beam_search`` op; here the beam frontier is a dense flattened
  (batch*beam) axis and decode() unrolls ``max_len`` steps at build time,
  so a decode has static shapes and is one CUDA graph on the card;
* finished beams are frozen by masking (forced end_id continuation at
  zero added score) instead of shrinking — ``early_stop`` therefore
  documents itself as a no-op: a fixed-trip loop costs the same and
  the masked tail changes nothing.

The user's state updater is an ordinary layer-building function, so it
is simply re-invoked once per unrolled step.
"""
import contextlib

from ... import layers
from ...layers.control_flow import DynamicRNN

__all__ = ['InitState', 'StateCell', 'TrainingDecoder',
           'BeamSearchDecoder']


class _DecoderType(object):
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial hidden state (ref :43): either an existing var, or a
    constant tensor shaped like ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype='float32'):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                'init_boot must be provided to infer the shape of '
                'InitState.\n')
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell(object):
    """Named states + step inputs + a registered updater (ref :159).
    ``compute_state`` binds the step inputs and runs the updater, which
    reads via get_input/get_state and writes via set_state;
    ``update_states`` commits the staged states (inside a
    TrainingDecoder it forwards to the RNN memory update)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError('state must be an InitState object.')
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if self._out_state not in self._cur_states:
            raise ValueError('out_state must be one state in states')

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError('StateCell has already entered a decoder.')
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError('StateCell not in decoder, invalid leaving '
                             'operation.')
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError('Inconsistent decoder object in StateCell.')
        self._in_decoder = False
        self._cur_decoder_obj = None

    def state_updater(self, updater):
        """Decorator registering the per-step transition fn (ref :300)."""
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError('Updater should only accept a StateCell '
                                'object as argument.')
            updater(state_cell)

        return _decorator

    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s.' % state_name)
        cur = self._cur_states[state_name]
        return cur.value if isinstance(cur, InitState) else cur

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError('Invalid input %s.' % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s.' % state_name)
        self._cur_states[state_name] = state_value

    def compute_state(self, inputs):
        """Bind step inputs and run the updater (ref :106)."""
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError(
                    'Unknown input %s. Please make sure %s in input place'
                    ' holder.' % (input_name, input_name))
            self._inputs[input_name] = input_value
        if self._state_updater is None:
            raise ValueError('No state updater registered; decorate one '
                             'with @state_cell.state_updater.')
        self._state_updater(self)

    def update_states(self):
        """Commit staged states; inside a TrainingDecoder this updates
        the underlying RNN memories (ref :131)."""
        if self._in_decoder and \
                getattr(self._cur_decoder_obj, "type", None) == \
                _DecoderType.TRAINING:
            self._cur_decoder_obj._commit_states(self)

    def out_state(self):
        return self.get_state(self._out_state)


class TrainingDecoder(object):
    """Teacher-forced decoder RNN (ref :384): states become DynamicRNN
    memories; block() is a step scope."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._drnn = DynamicRNN(name=name)
        self._type = _DecoderType.TRAINING
        self._mems = {}
        self._static = {}

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        self._assert_in_decoder_block('state_cell')
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError('decoder.block() can only be invoked once')
        self._status = TrainingDecoder.IN_DECODER
        with self._drnn.block():
            # materialize every state as an RNN memory seeded by its
            # InitState value
            for name in self._state_cell._state_names:
                init = self._state_cell._cur_states[name]
                mem = self._drnn.memory(init=init.value)
                self._mems[name] = mem
                self._state_cell._cur_states[name] = mem
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        self._assert_in_decoder_block('step_input')
        return self._drnn.step_input(x)

    def static_input(self, x):
        """Whole-sequence side input visible unchanged at every step
        (ref :470).  Dense design: the step block reads the var as a
        capture, so it passes through."""
        self._assert_in_decoder_block('static_input')
        self._static[x.name] = x
        return x

    def output(self, *outputs):
        self._assert_in_decoder_block('output')
        self._drnn.output(*outputs)

    def _commit_states(self, cell):
        for name, mem in self._mems.items():
            new = cell._cur_states[name]
            if new is not mem:
                self._drnn.update_memory(mem, new)
                cell._cur_states[name] = mem

    def __call__(self):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError('Output of training decoder can only be '
                             'visited outside the block.')
        return self._drnn()

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError('%s should be invoked inside block of '
                             'TrainingDecoder object.' % method)


class BeamSearchDecoder(object):
    """Beam-search inference decoder (ref :523).  decode() builds the
    default embedding -> state cell -> softmax fc -> topk flow; the
    result is dense: translation_ids (N, beam, max_len) int64 (end_id
    padded) and translation_scores (N, beam) accumulated log-probs,
    sorted best-first."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict={}, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._type = _DecoderType.BEAM_SEARCH
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict)
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._name = name
        self._outputs = None

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def early_stop(self):
        """No-op by design: the unrolled loop has a fixed trip count and
        finished beams are already frozen by the end_id mask, so stopping
        early would change cost, not results."""

    def _tile_beams(self, var):
        """(N, ...) -> (N*beam, ...) repeating each row beam times."""
        b = self._beam_size
        shape = list(var.shape)
        expanded = layers.expand(layers.unsqueeze(var, axes=[1]),
                                 [1, b] + [1] * (len(shape) - 1))
        return layers.reshape(expanded, [-1] + shape[1:])

    def decode(self):
        """Default decode flow (ref :653), dense-beam edition."""
        cell = self._state_cell
        b, v = self._beam_size, self._target_dict_dim
        neg_inf = -1e9
        # (N, 1) inits -> (N, b); only beam 0 live at t=0 so the first
        # expansion draws b distinct words
        ids = layers.cast(
            layers.expand(layers.reshape(self._init_ids, [-1, 1]),
                          [1, b]), "int64")                 # (N, b)
        scores = layers.expand(
            layers.reshape(self._init_scores, [-1, 1]), [1, b])
        first = layers.fill_constant_batch_size_like(
            ids, shape=[-1, 1], dtype='float32', value=0.0)
        if b > 1:
            dead0 = layers.fill_constant_batch_size_like(
                ids, shape=[-1, b - 1], dtype='float32', value=neg_inf)
            scores = layers.elementwise_add(
                scores, layers.concat([first, dead0], axis=1))
        # expand every state and side input across beams once
        for name in cell._state_names:
            cell.set_state(name, self._tile_beams(cell.get_state(name)))
        tiled_inputs = {k: self._tile_beams(var)
                        for k, var in self._input_var_dict.items()}
        for k in tiled_inputs:
            if k not in cell._inputs:
                raise ValueError('Variable ' + k +
                                 ' not found in StateCell!\n')
        end_const = layers.fill_constant([1], "int64", self._end_id)
        v_const = layers.fill_constant([1], "int64", v)
        # (1, V) one-hot of end_id -> additive mask that is 0 at end_id
        # and -inf elsewhere: the only free continuation of a dead beam
        end_row = layers.scale(layers.scale(
            layers.one_hot(layers.reshape(end_const, [1, 1]), v),
            scale=-1.0, bias=1.0), scale=neg_inf)
        end_row = layers.reshape(end_row, [1, 1, v])

        # the loop is UNROLLED, so every parameter created inside it must
        # carry a pinned name to be shared across steps (the reference's
        # While body creates each param once; here re-creation with the
        # same name resolves to the same Parameter)
        from ...param_attr import ParamAttr
        from ...framework import unique_name
        if self._name is None:
            # unique per decoder: two anonymous decoders in one program
            # must not silently share embedding/fc weights
            self._name = unique_name.generate("beam_decoder")
        uid = self._name
        emb_attr = ParamAttr(name=uid + "_emb_w")
        fc_w_attr = ParamAttr(name=uid + "_fc_w")
        fc_b_attr = ParamAttr(name=uid + "_fc_b")
        from ...framework.program import default_main_program
        blk = default_main_program().global_block()

        hist = None                       # (N*b, t) selected prefixes
        n_params_after_first_step = None
        for t in range(self._max_len):
            flat_ids = layers.reshape(ids, [-1, 1])        # (N*b, 1)
            emb = layers.embedding(flat_ids,
                                   size=[v, self._word_dim],
                                   dtype='float32',
                                   is_sparse=self._sparse_emb,
                                   param_attr=emb_attr)
            emb = layers.reshape(emb, [-1, self._word_dim])
            feed = dict(tiled_inputs)
            for input_name in cell._inputs:
                if input_name not in feed:
                    feed[input_name] = emb
            cell.compute_state(inputs=feed)
            prob = layers.fc(cell.out_state(), size=v, act='softmax',
                             param_attr=fc_w_attr, bias_attr=fc_b_attr)
            if t == 0:
                n_params_after_first_step = len(
                    blk.all_parameters())
            elif t == 1 and len(blk.all_parameters()) != \
                    n_params_after_first_step:
                raise ValueError(
                    "the state updater created new parameters on the "
                    "second decode step: in this unrolled decoder every "
                    "layer inside the updater must pin its weights with "
                    "a named ParamAttr so all steps share them")
            logp = layers.reshape(layers.log(prob), [-1, b, v])
            if t > 0:
                ended = layers.cast(layers.equal(ids, end_const),
                                    "float32")             # (N, b)
                live3 = layers.unsqueeze(
                    layers.scale(ended, scale=-1.0, bias=1.0), [2])
                logp = layers.elementwise_add(
                    layers.elementwise_mul(logp, live3),
                    layers.elementwise_mul(
                        end_row, layers.unsqueeze(ended, [2])))
            total = layers.elementwise_add(
                logp, layers.unsqueeze(scores, [2]))       # (N, b, V)
            scores, top = layers.topk(
                layers.reshape(total, [-1, b * v]), k=b)   # (N, b)
            beam_idx = layers.elementwise_floordiv(top, v_const)
            ids = layers.elementwise_mod(top, v_const)     # (N, b) int64
            # flat gather indices = row_offset + chosen beam
            flat_sel = layers.reshape(beam_idx, [-1])      # (N*b,)
            ones = layers.fill_constant_batch_size_like(
                flat_sel, [-1], "int64", 1)
            pos = layers.cumsum(ones, axis=0, exclusive=True)  # 0..N*b-1
            b_const = layers.fill_constant([1], "int64", b)
            row = layers.elementwise_mul(
                layers.elementwise_floordiv(pos, b_const), b_const)
            gather_idx = layers.elementwise_add(flat_sel, row)
            for name in cell._state_names:
                cell.set_state(name, layers.gather(cell.get_state(name),
                                                   gather_idx))
            # back-trace: beam j at step t+1 may descend from a different
            # beam at step t, so the recorded history must be re-gathered
            # along the winning beams too
            new_ids = layers.reshape(ids, [-1, 1])         # (N*b, 1)
            if hist is None:
                hist = new_ids
            else:
                hist = layers.concat(
                    [layers.gather(hist, gather_idx), new_ids], axis=1)
        trans_ids = layers.reshape(hist, [-1, b, self._max_len])
        self._outputs = (trans_ids, scores)
        self._state_cell._leave_decoder(self)

    def __call__(self):
        if self._outputs is None:
            raise ValueError('decode() must be called before the decoder '
                             'output is read.')
        return self._outputs
