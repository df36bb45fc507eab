"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py).

The compare and logical layers, ``increment``, the functional control
flow (``cond``, ``while_loop``, ``case``, ``switch_case``), the fluid
classes (``While``, ``Switch``, ``StaticRNN``, ``DynamicRNN``,
``IfElse``), ``is_empty``, ``Print``, the build-time tensor arrays,
``lod_rank_table``/``reorder_lod_tensor_by_rank``, ``piecewise_select``
and ``recompute_segment``.

A sub-block is built when the layer is called: its ops are recorded into
a child Block, and one op of the parent block runs it
(ops/control_flow_ops.py). Every outer var a sub-block reads is lifted to
an explicit input of that op (``_collect_captures``), so gradients reach
it. ``cond`` and ``while_loop`` (and ``Switch``, ``case``,
``switch_case``, ``While``, which lower to them) choose on the host;
``while_loop(maximum_trip_count=N)``, ``StaticRNN`` and ``DynamicRNN``
have a trip count fixed at build time and stay on the device, inside the
Executor's CUDA graph.
"""
import contextlib

from ..framework import unique_name
from ..framework.program import Variable, default_main_program
from ..layer_helper import LayerHelper


def _compare(x, y, op_type, cond=None):
    from . import tensor as tensor_layers
    helper = LayerHelper(op_type)
    if not isinstance(y, Variable):
        y = tensor_layers.fill_constant([1], x.dtype, float(y))
    out = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    out.stop_gradient = True
    if cond is not None:
        # fluid's out-parameter form: the result is written onto `cond`
        current = default_main_program().current_block()
        current.append_op("assign", inputs={"X": [out.name]},
                          outputs={"Out": [cond.name]})
        return cond
    return out


def less_than(x, y, force_cpu=None, cond=None):
    return _compare(x, y, "less_than", cond=cond)


def less_equal(x, y, cond=None):
    return _compare(x, y, "less_equal", cond=cond)


def greater_than(x, y, cond=None):
    return _compare(x, y, "greater_than", cond=cond)


def greater_equal(x, y, cond=None):
    return _compare(x, y, "greater_equal", cond=cond)


def equal(x, y, cond=None):
    return _compare(x, y, "equal", cond=cond)


def not_equal(x, y, cond=None):
    return _compare(x, y, "not_equal", cond=cond)


def logical_and(x, y, out=None, name=None):
    return _compare(x, y, "logical_and")


def logical_or(x, y, out=None, name=None):
    return _compare(x, y, "logical_or")


def logical_xor(x, y, out=None, name=None):
    return _compare(x, y, "logical_xor")


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    out = helper.create_variable_for_type_inference("bool", x.shape)
    helper.append_op("logical_not", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": float(value)})
    return out


def _build_subblock(fn, program):
    """Run fn() with a fresh child block current; return (block, outputs)."""
    block = program._create_block()
    try:
        outs = fn() if fn is not None else None
    finally:
        program._rollback()
    if outs is None:
        outs = []
    if isinstance(outs, Variable):
        outs = [outs]
    return block, list(outs)


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``layers.cond(pred, true_fn, false_fn)`` -> vars with matching
    structure. Each branch is a sub-block; the ``cond`` op reads ``pred``
    on the host and runs the branch it picks. Differentiable: the outer
    vars the branches read are lifted to explicit ``Captures`` inputs, so
    ``append_backward`` pairs this op with a ``grad_of`` like any other
    (reference: conditional_block_grad_op)."""
    helper = LayerHelper("cond", name=name)
    program = default_main_program()
    true_block, true_outs = _build_subblock(true_fn, program)
    false_block, false_outs = _build_subblock(false_fn, program)
    if len(true_outs) != len(false_outs):
        raise ValueError(
            "cond branches returned different numbers of outputs: %d vs %d"
            % (len(true_outs), len(false_outs)))
    captures = _collect_captures(
        [(true_block, [v.name for v in true_outs]),
         (false_block, [v.name for v in false_outs])], bound_names=())
    outs = [helper.create_variable_for_type_inference(v.dtype, v.shape)
            for v in true_outs]
    helper.append_op(
        "cond", inputs={"Cond": [pred.name], "Captures": captures},
        outputs={"Out": [o.name for o in outs]},
        attrs={"true_block": true_block.idx, "false_block": false_block.idx,
               "true_out_names": [v.name for v in true_outs],
               "false_out_names": [v.name for v in false_outs],
               "capture_names": captures})
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None,
               maximum_trip_count=None):
    """``layers.while_loop``.

    Without ``maximum_trip_count``: the ``while_loop`` op, which reads the
    predicate on the host before each trip (a dynamic trip count;
    forward only, as in the JAX package). With ``maximum_trip_count=N``:
    the differentiable ``bounded_while`` op, N iterations on the device,
    an iteration past the predicate's turn keeping the old carry.
    Gradients then reach both the initial loop values and the captured
    outer vars (reference: while_grad_op)."""
    helper = LayerHelper("while_loop", name=name)
    program = default_main_program()

    cond_block = program._create_block()
    try:
        pred = cond_fn(*loop_vars)
    finally:
        program._rollback()

    body_block = program._create_block()
    try:
        new_vars = body_fn(*loop_vars)
    finally:
        program._rollback()
    if isinstance(new_vars, Variable):
        new_vars = [new_vars]
    new_vars = list(new_vars)
    if len(new_vars) != len(loop_vars):
        raise ValueError("while_loop body must return as many vars as "
                         "loop_vars")
    # the body must write back into the loop var names; emit assigns
    for lv, nv in zip(loop_vars, new_vars):
        if nv.name != lv.name:
            body_block.append_op("assign", inputs={"X": [nv.name]},
                                 outputs={"Out": [lv.name]})

    loop_names = [v.name for v in loop_vars]
    captures = _collect_captures(
        [(cond_block, [pred.name]), (body_block, [])],
        bound_names=loop_names)
    outs = [helper.create_variable_for_type_inference(v.dtype, v.shape)
            for v in loop_vars]
    attrs = {"cond_block": cond_block.idx, "body_block": body_block.idx,
             "loop_var_names": loop_names, "cond_out_name": pred.name,
             "capture_names": captures}
    op_type = "while_loop"
    if maximum_trip_count is not None:
        op_type = "bounded_while"
        attrs["max_trip_count"] = int(maximum_trip_count)
    helper.append_op(
        op_type,
        inputs={"LoopVars": loop_names, "Captures": captures},
        outputs={"Out": [o.name for o in outs]},
        attrs=attrs)
    return outs


def case(pred_fn_pairs, default=None, name=None):
    """Reference layers.case: a nested chain of ``cond``."""
    def build(pairs):
        pred, fn = pairs[0]
        rest = pairs[1:]
        if not rest:
            if default is None:
                return cond(pred, fn, fn)
            return cond(pred, fn, default)
        return cond(pred, fn, lambda: build(rest))
    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    pairs = [(equal(branch_index, float(i)), fn)
             for i, fn in (branch_fns.items()
                           if isinstance(branch_fns, dict)
                           else enumerate(branch_fns))]
    return case(pairs, default=default, name=name)


def piecewise_select(step, boundaries, values, dtype="float32"):
    """values[i] where boundaries[i-1] <= step < boundaries[i]: a chain of
    ``where`` selects, all on the device."""
    from . import tensor as tensor_layers
    from .nn import where
    out = tensor_layers.fill_constant([1], dtype, values[-1])
    for b, v in reversed(list(zip(boundaries, values[:-1]))):
        v_var = tensor_layers.fill_constant([1], dtype, v)
        out = where(less_than(step, float(b)), v_var, out)
    return out


def _collect_captures(blocks_and_outs, bound_names):
    """Outer-scope names the sub-blocks read (read before written, plus
    returned but never defined), beyond ``bound_names``. Listing them as
    the op's explicit inputs is what lets gradients reach them: the
    Executor differentiates an op with respect to its declared inputs."""
    captured, seen = [], set(bound_names)
    for block, out_names in blocks_and_outs:
        defined = set(bound_names)
        for op in block.ops:
            for n in op.input_names():
                if n not in defined and n not in seen and \
                        not n.startswith("@"):
                    captured.append(n)
                    seen.add(n)
            defined.update(op.output_names())
        for n in out_names:
            if n not in defined and n not in seen and not n.startswith("@"):
                captured.append(n)
                seen.add(n)
    return captured


def recompute_segment(fn, inputs, name=None):
    """``fn(*inputs)`` inside a rematerialized segment: the segment's
    activations are not kept for the backward, which runs the segment
    again (``remat_block``, ops/control_flow_ops.py). The parameters and
    outer vars the segment reads are found as captures, so gradients
    still reach them."""
    helper = LayerHelper("recompute", name=name)
    program = default_main_program()
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    inputs = list(inputs)

    block = program._create_block()
    try:
        outs = fn(*inputs)
    finally:
        program._rollback()
    if isinstance(outs, Variable):
        outs = [outs]
    outs = list(outs)

    input_names = {v.name for v in inputs}
    captured = _collect_captures([(block, [v.name for v in outs])],
                                 bound_names=input_names)
    parent = program.current_block()
    cap_vars = []
    for n in captured:
        v = parent._find_var_recursive(n)
        if v is None:
            v = block._find_var_recursive(n)
        cap_vars.append(v)

    in_all = inputs + [v for v in cap_vars if v is not None]
    out_vars = [helper.create_variable_for_type_inference(v.dtype, v.shape)
                for v in outs]
    helper.append_op(
        "remat_block",
        inputs={"In": [v.name for v in in_all]},
        outputs={"Out": [v.name for v in out_vars]},
        attrs={"sub_block": block.idx,
               "in_names": [v.name for v in in_all],
               "out_names": [v.name for v in outs]})
    if len(out_vars) == 1:
        return out_vars[0]
    return out_vars


# ---------------------------------------------------------------------------
# fluid-style control-flow classes (reference layers/control_flow.py:
# While, Switch, StaticRNN, DynamicRNN, IfElse + LoDTensorArray ops),
# lowered onto the same ops as the functional API.
# ---------------------------------------------------------------------------

class While(object):
    """fluid.layers.While: the body block runs until the carried cond var
    turns false (ref control_flow.py class While / while_op.cc). The body
    must update `cond` (e.g. layers.less_than(i, n, cond=cond)); every
    outer var the body assigns becomes a loop-carried value.

    Forward only (the ``while_loop`` op: a dynamic trip count, the
    predicate read on the host; the same gradient restriction as
    layers.while_loop without maximum_trip_count)."""

    def __init__(self, cond, is_test=False, name=None):
        if str(cond.dtype) not in ("bool",):
            raise TypeError("While cond must be a bool Variable")
        self._cond = cond
        self._helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        parent = program.current_block()
        body = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        # loop vars: outer vars the body writes (reads of stale values are
        # loop-carried too), cond first
        written = []
        for op in body.ops:
            for n in op.output_names():
                if n in body.vars:       # temp created inside the body
                    continue
                if n not in written and \
                        parent._find_var_recursive(n) is not None:
                    written.append(n)
        loop_names = [self._cond.name] + \
            [n for n in written if n != self._cond.name]
        cond_block = program._create_block()
        program._rollback()              # empty: pred is the carried var
        captures = _collect_captures(
            [(cond_block, [self._cond.name]), (body, [])],
            bound_names=loop_names)
        outs = []
        for n in loop_names:
            v = parent._find_var_recursive(n)
            outs.append(self._helper.create_variable_for_type_inference(
                v.dtype, v.shape))
        self._helper.append_op(
            "while_loop",
            inputs={"LoopVars": loop_names, "Captures": captures},
            outputs={"Out": [o.name for o in outs]},
            attrs={"cond_block": cond_block.idx, "body_block": body.idx,
                   "loop_var_names": loop_names,
                   "cond_out_name": self._cond.name,
                   "capture_names": captures})
        # write final values back onto the outer names
        blk = program.current_block()
        for n, o in zip(loop_names, outs):
            blk.append_op("assign", inputs={"X": [o.name]},
                          outputs={"Out": [n]})


class Switch(object):
    """fluid.layers.Switch: the first case whose condition holds executes;
    the optional default runs when none do (ref control_flow.py Switch,
    the lr-scheduler idiom). Cases communicate via assigns to outer vars;
    lowering is a reversed chain of `cond` ops selecting those vars."""

    def __init__(self, name=None):
        self._helper = LayerHelper("switch", name=name)
        self._cases = []          # (cond var or None, block)
        self._got_default = False

    def __enter__(self):
        return self

    @contextlib.contextmanager
    def case(self, condition):
        if self._got_default:
            raise ValueError("case() after default()")
        program = default_main_program()
        blk = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self._cases.append((condition, blk))

    @contextlib.contextmanager
    def default(self):
        if self._got_default:
            raise ValueError("there can be at most one default() case "
                             "in a Switch")
        program = default_main_program()
        blk = program._create_block()
        try:
            yield
        finally:
            program._rollback()
        self._cases.append((None, blk))
        self._got_default = True

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        program = default_main_program()
        parent = program.current_block()
        # all outer vars any case assigns
        written = []
        for _, blk in self._cases:
            for op in blk.ops:
                for n in op.output_names():
                    if n not in blk.vars and n not in written and \
                            parent._find_var_recursive(n) is not None:
                        written.append(n)
        if not written:
            return False
        # build the else-chain back to front; start from current values
        else_block = program._create_block()
        program._rollback()              # empty block: passthrough
        else_names = list(written)
        else_idx = else_block.idx
        chain = [c for c in self._cases]
        default = None
        if chain and chain[-1][0] is None:
            default = chain.pop()[1]
            else_idx = default.idx
        final_outs = None
        if not chain:
            if default is None:
                return False
            # default-only Switch: select the default block unconditionally
            from . import tensor as T
            always = T.fill_constant([1], "bool", True)
            chain = [(always, default)]
            else_block2 = program._create_block()
            program._rollback()
            else_idx = else_block2.idx
        for cond_var, blk in reversed(chain):
            captures = _collect_captures(
                [(blk, written), (program.block(else_idx), else_names)],
                bound_names=())
            outs = [self._helper.create_variable_for_type_inference(
                parent._find_var_recursive(n).dtype,
                parent._find_var_recursive(n).shape) for n in written]
            self._helper.append_op(
                "cond",
                inputs={"Cond": [cond_var.name], "Captures": captures},
                outputs={"Out": [o.name for o in outs]},
                attrs={"true_block": blk.idx,
                       "false_block": else_idx,
                       "true_out_names": written,
                       "false_out_names": else_names,
                       "capture_names": captures})
            # this cond's outputs become the next (earlier) case's "else"
            passthrough = program._create_block()
            program._rollback()
            for n, o in zip(written, outs):
                passthrough.append_op("assign", inputs={"X": [o.name]},
                                      outputs={"Out": [n]})
            else_idx = passthrough.idx
            else_names = list(written)
            final_outs = outs
        blk = program.current_block()
        for n, o in zip(written, final_outs):
            blk.append_op("assign", inputs={"X": [o.name]},
                          outputs={"Out": [n]})
        return False


class StaticRNN(object):
    """fluid.layers.StaticRNN (ref control_flow.py StaticRNN /
    recurrent_op.cc): record one step's ops in a sub-block, run it as a
    differentiable scan (the ``recurrent_scan`` op) over time-major
    inputs (T, B, ...)."""

    def __init__(self, name=None):
        self._helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._seq = []      # (placeholder, outer seq var)
        self._mems = []     # dicts: ph, init(Variable|None), shape, value,
                            #        batch_ref, new (Variable)
        self._outs = []     # step-local output vars

    @contextlib.contextmanager
    def step(self):
        program = default_main_program()
        self._program = program
        self._block = program._create_block()
        try:
            yield
        finally:
            program._rollback()

    def _require_block(self):
        if self._block is None:
            raise RuntimeError("call inside `with rnn.step():`")

    def step_input(self, x):
        self._require_block()
        ph = self._block.create_var(
            name=unique_name.generate("rnn_step_in"),
            shape=tuple(x.shape[1:]) if x.shape else None, dtype=x.dtype)
        self._seq.append((ph, x))
        return ph

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1,
               dtype=None):
        self._require_block()
        if init is not None:
            mshape, dtype = tuple(init.shape), init.dtype
        else:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or shape=+batch_ref=")
            mshape = tuple(batch_ref.shape[0] if s in (None, -1) else s
                           for s in shape)
            dtype = dtype or batch_ref.dtype
        ph = self._block.create_var(
            name=unique_name.generate("rnn_mem"), shape=mshape, dtype=dtype)
        self._mems.append({"ph": ph, "init": init, "shape": mshape,
                           "value": float(init_value), "new": None})
        return ph

    def update_memory(self, mem, new):
        for m in self._mems:
            if m["ph"].name == mem.name:
                m["new"] = new
                return
        raise ValueError("update_memory: %r is not a memory" % mem.name)

    def step_output(self, o):
        self._require_block()
        self._outs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        from . import tensor as T
        if any(m["new"] is None for m in self._mems):
            raise ValueError("every memory needs update_memory()")
        inits = []
        for m in self._mems:
            if m["init"] is not None:
                inits.append(m["init"])
            else:
                inits.append(T.fill_constant(list(m["shape"]),
                                             str(m["ph"].dtype), m["value"]))
        seq_names = [ph.name for ph, _ in self._seq]
        carry_names = [m["ph"].name for m in self._mems]
        carry_out = [m["new"].name for m in self._mems]
        out_names = [o.name for o in self._outs]
        captures = _collect_captures(
            [(self._block, carry_out + out_names)],
            bound_names=seq_names + carry_names)
        t = self._seq[0][1].shape[0] if self._seq else None
        seq_outs = [self._helper.create_variable_for_type_inference(
            o.dtype, None if (o.shape is None or t in (None, -1))
            else (t,) + tuple(o.shape)) for o in self._outs]
        finals = [self._helper.create_variable_for_type_inference(
            m["ph"].dtype, m["shape"]) for m in self._mems]
        self._helper.append_op(
            "recurrent_scan",
            inputs={"Seq": [v.name for _, v in self._seq],
                    "Init": [v.name for v in inits],
                    "Extra": captures},
            outputs={"FinalCarry": [f.name for f in finals],
                     "SeqOut": [s.name for s in seq_outs]},
            attrs={"sub_block": self._block.idx,
                   "seq_var_names": seq_names,
                   "carry_var_names": carry_names,
                   "extra_var_names": captures,
                   "carry_out_names": carry_out,
                   "step_out_names": out_names})
        self._finals = finals
        if not seq_outs:
            return None
        return seq_outs[0] if len(seq_outs) == 1 else seq_outs


class DynamicRNN(object):
    """fluid.layers.DynamicRNN on the dense design: batch-major (B, T, ...)
    input + explicit lengths replace the LoD (ref control_flow.py
    DynamicRNN). Steps past a row's length keep the previous memory and
    emit zeros — the masked-scan equivalent of the reference's
    shrink-at-each-step execution."""

    def __init__(self, name=None):
        self._rnn = StaticRNN(name=name)
        self._lengths = None
        self._mask_ph = None
        self._first_ph = None
        self._step_idx = 0

    def block(self):
        return self._rnn.step()

    def step_input(self, input, lengths=None):
        from .nn import transpose
        if lengths is not None:
            self._lengths = lengths
        # batch-major -> time-major for the scan
        perm = list(range(len(input.shape)))
        perm[0], perm[1] = 1, 0
        # transpose must happen OUTSIDE the step block: stash and emit in
        # the parent via the recorded outer var
        program = default_main_program()
        program._rollback()
        try:
            tm = transpose(input, perm)
            if self._lengths is not None and self._mask_ph is None:
                from .nn import sequence_mask, cast, unsqueeze
                m = sequence_mask(self._lengths, maxlen=input.shape[1],
                                  dtype="float32")       # (B, T)
                m = transpose(m, [1, 0])                  # (T, B)
                m = unsqueeze(m, [2])                     # (T, B, 1)
                self._mask = m
        finally:
            program.current_block_idx = self._rnn._block.idx
        ph = self._rnn.step_input(tm)
        if self._first_ph is None:
            self._first_ph = ph
        if self._lengths is not None and self._mask_ph is None:
            self._mask_ph = self._rnn.step_input(self._mask)
        return ph

    def _mask_for(self, value):
        """Per-step keep-mask shaped/cast to broadcast against *value*:
        mask_ph is (B, 1); values may be rank 1..N."""
        from .nn import cast, unsqueeze, reshape
        m = self._mask_ph
        rank = len(value.shape or ())
        if rank <= 1:
            m = reshape(m, [-1])
        elif rank > 2:
            m = unsqueeze(m, list(range(2, rank)))
        if value.dtype != m.dtype:
            m = cast(m, value.dtype)
        return m

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32", batch_ref=None):
        if init is None:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            if batch_ref is None:
                if self._first_ph is None:
                    raise ValueError(
                        "DynamicRNN.memory(shape=...): call step_input() "
                        "first so the batch size is known")
                batch_ref = self._first_ph
                # fluid semantics: shape is per-sample; batch prepended
                shape = [-1] + list(shape)
            return self._rnn.memory(shape=shape, batch_ref=batch_ref,
                                    init_value=value, dtype=dtype)
        return self._rnn.memory(init=init, init_value=value)

    def update_memory(self, ex_mem, new_mem):
        if self._mask_ph is not None:
            from .nn import elementwise_mul, elementwise_add, scale
            m = self._mask_for(new_mem)
            keep = scale(m, scale=-1.0, bias=1.0)
            new_mem = elementwise_add(elementwise_mul(new_mem, m),
                                      elementwise_mul(ex_mem, keep))
        self._rnn.update_memory(ex_mem, new_mem)

    def output(self, *outputs):
        if self._mask_ph is not None:
            from .nn import elementwise_mul
            outputs = [elementwise_mul(o, self._mask_for(o))
                       for o in outputs]
        self._rnn.output(*outputs)

    def __call__(self):
        from .nn import transpose
        outs = self._rnn()
        if outs is None:
            return None
        single = not isinstance(outs, list)
        outs = [outs] if single else outs
        res = []
        for o in outs:
            perm = list(range(len(o.shape) if o.shape else 3))
            perm[0], perm[1] = 1, 0
            res.append(transpose(o, perm))   # back to batch-major
        return res[0] if single else res

    def final_states(self):
        """Final memory values after the scan, in memory() order.  With
        lengths, update_memory freezes each row's carry past its valid
        prefix, so these ARE the states at t = len-1 (used by
        layers.rnn for its final_states return)."""
        finals = getattr(self._rnn, "_finals", None)
        if finals is None:
            raise ValueError("final_states() is available after the "
                             "DynamicRNN has been called")
        return list(finals)


def is_empty(x, cond=None):
    """Static element-count test (ref control_flow.py is_empty). Dynamic
    (-1) dims are unknown at build time and rejected rather than guessed."""
    from . import tensor as T
    n = 1
    for s in (x.shape or ()):
        if s in (None, -1):
            raise ValueError(
                "is_empty needs fully static shapes; %r has a "
                "dynamic dim" % getattr(x, "name", x))
        n *= s
    out = T.fill_constant([1], "bool", bool(n == 0))
    if cond is not None:
        current = default_main_program().current_block()
        current.append_op("assign", inputs={"X": [out.name]},
                          outputs={"Out": [cond.name]})
        return cond
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Debug print (ref control_flow.py Print / print_op): the ``print``
    op prints its message and first ``summarize`` values on the host, so
    a program holding one runs op by op; gradients pass through
    untouched."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    input.shape)
    helper.append_op("print", inputs={"In": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": message or input.name,
                            "summarize": int(summarize)})
    return out


# ---- bounded TensorArray (build-time list design) ------------------------

class _TensorArray(list):
    """LoDTensorArray stand-in: a BUILD-TIME list of Variables. The
    dominant static-graph uses (collecting per-step outputs, beam-search
    assembly in python loops) index with python ints; dynamic Variable
    indices inside While have no static-shape equivalent and raise."""
    pass


def create_array(dtype):
    return _TensorArray()


def _static_index(i):
    if hasattr(i, "name"):
        raise NotImplementedError(
            "TensorArray with a Variable index inside device loops has no "
            "static-shape form; use layers.while_loop loop_vars or "
            "StaticRNN memories instead")
    return int(i)


def array_write(x, i, array=None):
    """ref control_flow.py array_write (python-int index)."""
    i = _static_index(i)
    if array is None:
        array = _TensorArray()
    while len(array) <= i:
        array.append(None)
    array[i] = x
    return array


def array_read(array, i):
    v = array[_static_index(i)]
    if v is None:
        raise IndexError("array_read at unwritten index")
    return v


def array_length(array):
    from . import tensor as T
    return T.fill_constant([1], "int64", len(array))


class IfElse(object):
    """fluid.layers.IfElse: rows where cond holds flow through the true
    block, the rest through the false block, outputs merged by row (ref
    control_flow.py IfElse / split_lod_tensor+merge_lod_tensor ops).

    Dense form: BOTH branches compute over the full batch and the
    merge is a per-row where-select on cond — identical results, no
    dynamic row splitting (static shapes; the branch FLOPs are the price,
    as with every masked-batch idiom here)."""

    def __init__(self, cond, name=None):
        self._cond = cond                 # (N, 1) bool
        self._helper = LayerHelper("ifelse", name=name)
        self._in_true = None
        self._outs = {True: [], False: []}

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        try:
            yield
        finally:
            self._in_true = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        try:
            yield
        finally:
            self._in_true = None

    def input(self, x):
        if self._in_true is None:
            raise RuntimeError("IfElse.input outside a block")
        return x                          # full batch; select happens at ()

    def output(self, *outs):
        if self._in_true is None:
            raise RuntimeError("IfElse.output outside a block")
        self._outs[self._in_true].extend(outs)

    def __call__(self):
        from .nn import where, cast, expand
        t, f = self._outs[True], self._outs[False]
        if len(t) != len(f):
            raise ValueError("IfElse branches produced %d vs %d outputs"
                             % (len(t), len(f)))
        merged = []
        for tv, fv in zip(t, f):
            c = self._cond
            merged.append(where(c, tv, fv))
        return merged


def lod_rank_table(x, level=0, lengths=None):
    """Rank table = row order by descending length (ref
    control_flow.py lod_rank_table). Dense design: the table IS the
    lengths vector; pass it to reorder_lod_tensor_by_rank."""
    if lengths is None:
        raise ValueError("dense design: pass lengths= explicitly")
    return lengths


def reorder_lod_tensor_by_rank(x, rank_table):
    """Reorder rows by descending length (ref
    control_flow.py reorder_lod_tensor_by_rank + reorder_lod_tensor_by_rank
    op — the DynamicRNN sorting step). rank_table: the (N,) lengths."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("reorder_by_rank",
                     inputs={"X": [x.name],
                             "RankTable": [rank_table.name]},
                     outputs={"Out": [out.name]})
    return out


__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "increment", "cond", "while_loop", "case",
           "switch_case", "piecewise_select", "recompute_segment", "While",
           "Switch", "StaticRNN", "DynamicRNN", "is_empty", "Print",
           "create_array", "array_write", "array_read", "array_length",
           "IfElse", "lod_rank_table", "reorder_lod_tensor_by_rank"]
