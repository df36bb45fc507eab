"""The control-flow ops and layers, the port against the JAX package.

Each case is built through the public ``layers`` API of both packages
(same calls, same unique names) and run with each package's
``Executor(CPUPlace())`` on the same numpy feeds, from the JAX startup's
parameters copied into the port (``run_pair``); values and gradients
(``gradients`` of sum_i <out_i, cot_i>, the cotangents fed as data) are
compared. The JAX package runs its sub-blocks through ``lax.cond``,
``lax.while_loop`` and ``lax.scan``; the port runs them op by op
(ops/control_flow_ops.py).

Tolerances: f32 on both sides. Ops that only choose or move data (cond's
branch pick, select_input, reorder_by_rank, flip, the logical ops, the
tensor arrays) agree exactly. A loop of a few f32 steps (the scans, the
bounded whiles) differs only in the order of a sum inside a step: rtol
1e-5, atol 1e-6. Integer outputs are int64 in the port and int32 in the
JAX package (without x64): values exactly.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import executor as texecutor
from test_torch_ops import _build, _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

TOL = dict(rtol=1e-5, atol=1e-6)


def _param(p, name, shape, value=None, seed=0):
    """A parameter initialised from a seed (or to ``value``)."""
    init = p.initializer.Constant(value) if value is not None else \
        p.initializer.Normal(0.0, 1.0, seed=seed)
    return p.layers.create_parameter(list(shape), "float32", name=name,
                                     default_initializer=init)


def _flag(p, name="flag"):
    return _data(p, name, (1,))


# ---- cond / case / switch_case ---------------------------------------------

@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_cond_forward_and_grad_to_captures(flag):
    """The taken branch's value, and its gradient into the captures: a fed
    var, a parameter and an outer var computed before the cond."""
    def build(p):
        x = _grad_data(p, "x", (2, 3))
        w = _param(p, "wc", (3,), seed=1)
        h = p.layers.tanh(x)                     # an outer computed var
        pred = p.layers.greater_than(p.layers.reduce_sum(_flag(p)), 0.5)
        y = p.layers.cond(
            pred, lambda: p.layers.elementwise_mul(h, w),
            lambda: p.layers.elementwise_add(p.layers.scale(x, 3.0), w))
        return _with_grads(p, [y], [x, w])
    run_pair(build, [dict({"x": _x((2, 3)), "flag": np.array([flag],
                                                             np.float32)},
                          **_cots(6))], tol=TOL)


def test_cond_branch_returning_a_constant_gives_zero_gradient():
    """A branch that returns a constant: zero gradient into the captures
    the other branch reads (``lax.cond``'s vjp gives zeros)."""
    def build(p):
        x = _grad_data(p, "x", (2, 2))
        pred = p.layers.greater_than(p.layers.reduce_sum(_flag(p)), 0.5)
        y = p.layers.cond(pred, lambda: p.layers.scale(x, 2.0),
                          lambda: p.layers.fill_constant([2, 2], "float32",
                                                         7.0))
        return _with_grads(p, [y], [x])
    tout, _, _ = run_pair(build, [dict({"x": _x((2, 2)),
                                        "flag": np.zeros(1, np.float32)},
                                       **_cots(4))], exact=True)
    np.testing.assert_array_equal(tout[1], np.zeros((2, 2), np.float32))


def test_cond_with_several_outputs():
    def build(p):
        x = _data(p, "x", (3,))
        pred = p.layers.less_than(p.layers.reduce_sum(x), 0.0)
        a, b = p.layers.cond(
            pred, lambda: [p.layers.scale(x, 2.0), p.layers.exp(x)],
            lambda: [p.layers.scale(x, -1.0), p.layers.tanh(x)])
        return [a, b]
    for seed in (0, 3):
        run_pair(build, [{"x": _x((3,), seed)}], tol=TOL)


@pytest.mark.parametrize("idx", [0, 1, 2, 5])
def test_switch_case_and_case_forward_and_grad(idx):
    """switch_case (and the case chain under it): the branch of the index,
    the default past the last; gradients into the captured parameter."""
    def build(p):
        x = _grad_data(p, "x", (2,))
        w = _param(p, "ws", (2,), seed=2)
        i = _data(p, "i", (1,), "int64")
        y = p.layers.switch_case(
            i, {0: lambda: p.layers.elementwise_add(x, w),
                1: lambda: p.layers.elementwise_mul(x, p.layers.square(w)),
                2: lambda: p.layers.scale(p.layers.elementwise_add(x, w),
                                          5.0)},
            default=lambda: p.layers.elementwise_sub(x, w))
        return _with_grads(p, [y], [x, w])
    run_pair(build, [dict({"x": _x((2,)), "i": np.array([idx])},
                          **_cots(2))], tol=TOL)


# ---- while_loop / bounded_while --------------------------------------------

def _counting_loop(p, bound, body_v):
    """(i, v) -> (i + 1, body_v(v)) while i < 4.5, from i = 0."""
    x = _grad_data(p, "x", (3,))
    i0 = p.layers.fill_constant([1], "float32", 0.0)
    _, v = p.layers.while_loop(
        lambda i, v: p.layers.less_than(p.layers.reduce_sum(i), 4.5),
        lambda i, v: (p.layers.scale(i, bias=1.0), body_v(v)),
        [i0, x], maximum_trip_count=bound)
    return x, v


def test_while_loop_forward():
    """The unbounded loop (predicate read on the host) and its count of
    trips; an int64 counter with ``increment``."""
    def build(p):
        _, v = _counting_loop(p, None, p.layers.tanh)
        n = p.layers.fill_constant([1], "int64", 7)
        c0 = p.layers.fill_constant([1], "int64", 0)
        c, = p.layers.while_loop(
            lambda c: p.layers.less_than(c, n),
            lambda c: [p.layers.increment(c, 2, in_place=False)], [c0])
        return [v, c]
    tout, _, _ = run_pair(build, [{"x": _x((3,))}], tol=TOL)
    assert int(tout[1][0]) == 8


def test_bounded_while_matches_dynamic_forward():
    """maximum_trip_count=16 against the dynamic loop, in each package."""
    outs = []
    for bound in (None, 16):
        tout, _, _ = run_pair(
            lambda p: [_counting_loop(p, bound, p.layers.tanh)[1]],
            [{"x": _x((3,))}], tol=TOL)
        outs.append(tout[0])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)


def test_bounded_while_forward_and_grad():
    """v = v * w while i < 3 (bound 8): d sum(v) / dw = 3 x w^2; the
    gradient reaches the loop's initial value and the captured w."""
    def build(p):
        x = _grad_data(p, "x", (2,))
        w = _param(p, "ww", (2,), value=2.0)
        i0 = p.layers.fill_constant([1], "float32", 0.0)
        _, v = p.layers.while_loop(
            lambda i, v: p.layers.less_than(p.layers.reduce_sum(i), 2.5),
            lambda i, v: (p.layers.scale(i, bias=1.0),
                          p.layers.elementwise_mul(v, w)),
            [i0, x], maximum_trip_count=8)
        return _with_grads(p, [v], [x, w])
    xv = np.array([1.0, 2.0], np.float32)
    tout, _, _ = run_pair(build, [{"x": xv, "cot0": np.ones((2, 1),
                                                            np.float32)}],
                          tol=TOL)
    np.testing.assert_allclose(tout[0], xv * 8.0, rtol=1e-6)
    np.testing.assert_allclose(tout[2], 12.0 * xv, rtol=1e-6)


def test_bounded_while_sqrt_at_fixpoint_gradient_is_finite():
    """One real trip takes v = x - 2 sqrt(x) w to 0; the five masked
    trips evaluate sqrt at 0 (an infinite derivative). Only the taken
    branch is differentiated, in both packages: d/dw = -2 sqrt(x) = -4,
    finite."""
    def build(p):
        x = _data(p, "x", (1,))
        w = _param(p, "wn", (1,), value=1.0)
        i0 = p.layers.fill_constant([1], "float32", 0.0)
        _, v = p.layers.while_loop(
            lambda i, v: p.layers.less_than(p.layers.reduce_sum(i), 0.5),
            lambda i, v: (p.layers.scale(i, bias=1.0),
                          p.layers.elementwise_sub(v, p.layers.elementwise_mul(
                              p.layers.sqrt(v), p.layers.scale(w, 2.0)))),
            [i0, x], maximum_trip_count=6)
        loss = p.layers.reduce_sum(v)
        return [loss] + p.framework.backward.gradients([loss], [w])
    tout, _, _ = run_pair(build, [{"x": np.array([4.0], np.float32)}],
                          exact=True)
    assert np.isfinite(tout[1]).all()
    np.testing.assert_allclose(tout[1], [-4.0], rtol=1e-6)
    np.testing.assert_allclose(tout[0], 0.0, atol=1e-6)


def _gather_loop(p, clamp):
    """s += x[i] while i < 3 (bound 6), from i = 0; ``clamp`` reads
    x[min(i, 2)], which is total at the fixpoint i = 3."""
    x = _data(p, "x", (3,))
    n = p.layers.fill_constant([1], "int64", 3)
    last = p.layers.fill_constant([1], "int64", 2)

    def body(i, s):
        j = p.layers.elementwise_min(i, last) if clamp else i
        return (p.layers.increment(i, 1, in_place=False),
                p.layers.elementwise_add(s, p.layers.gather(x, j)))
    _, s = p.layers.while_loop(
        lambda i, s: p.layers.less_than(i, n), body,
        [p.layers.fill_constant([1], "int64", 0),
         p.layers.fill_constant([1], "float32", 0.0)],
        maximum_trip_count=6)
    return [s]


def test_bounded_while_body_must_be_total_at_its_fixpoint():
    """The port runs a bounded body on every trip and keeps the old carry
    where the predicate is false, while the JAX package's ``lax.cond``
    skips it. A gather at the fixpoint i = 3, past the end, reads
    ``jnp.take``'s fill in the port (no IndexError, no device assert) and
    the carry keeps 7, so both packages answer 7.0; the clamped gather
    agrees exactly too."""
    xv = np.array([1.0, 2.0, 4.0], np.float32)
    for clamp in (True, False):
        tout, _, _ = run_pair(lambda p: _gather_loop(p, clamp),
                              [{"x": xv}], exact=True)
        np.testing.assert_array_equal(tout[0], [7.0])


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_gather_out_of_range_reads_jnp_takes_fill(dtype):
    """An index in [-n, 0) wraps, one past either end reads NaN (an
    integer: int32's minimum, the JAX package's int without x64), as
    ``jnp.take``'s default mode; a float gather's gradient into a filled
    row is zero."""
    idx = np.array([3, -1, -4, 0, 2, 7], np.int64)
    xv = np.array([1.0, 2.0, 4.0], np.float32)

    def build(p):
        i = p.layers.data("i", [6], dtype="int64", append_batch_size=False)
        if dtype == "int64":
            return [p.layers.gather(_data(p, "x", (3,), "int64"), i)]
        x = _grad_data(p, "x", (3,))
        return _with_grads(p, [p.layers.gather(x, i)], [x])
    feed = {"x": xv.astype(dtype), "i": idx}
    tout, _, _ = run_pair(build, [dict(feed, **_cots(6))], exact=True)
    want = [np.nan, 4, np.nan, 1, 4, np.nan] if dtype == "float32" else \
        [-2 ** 31, 4, -2 ** 31, 1, 4, -2 ** 31]
    np.testing.assert_array_equal(tout[0], want)


@pytest.mark.parametrize("padding_idx", [None, 1])
def test_lookup_table_out_of_range_reads_jnp_takes_fill(padding_idx):
    """Ids past either end give rows of NaN and wrap in [-V, 0); the
    padding row stays zeros; the table's gradient skips the filled
    rows."""
    ids = np.array([[0], [5], [-1], [-6], [1], [4]], np.int64)

    def build(p):
        out = p.layers.embedding(
            p.layers.data("ids", [6, 1], dtype="int64",
                          append_batch_size=False), [5, 3],
            padding_idx=padding_idx, param_attr=p.ParamAttr(name="emb_w"))
        w = p.default_main_program().global_block().var("emb_w")
        return _with_grads(p, [out], [w])
    tout, _, _ = run_pair(build, [dict({"ids": ids}, **_cots(18))],
                          tol=TOL)
    assert np.isnan(tout[0][[1, 3]]).all()
    assert np.isfinite(tout[0][[0, 2, 4, 5]]).all()
    assert np.isfinite(tout[1]).all()


def test_gradient_reaches_captures_through_nested_control_flow():
    """A cond inside a bounded while's body, reading a parameter and an
    outer computed var: both get their gradient, as in the JAX package."""
    def build(p):
        x = _grad_data(p, "x", (2, 2))
        w = _param(p, "wq", (2,), seed=3)
        h = p.layers.sigmoid(x)
        i0 = p.layers.fill_constant([1], "float32", 0.0)

        def body(i, v):
            odd = p.layers.greater_than(p.layers.reduce_sum(i), 0.5)
            nv = p.layers.cond(
                odd, lambda: p.layers.elementwise_mul(v, w),
                lambda: p.layers.elementwise_add(v, h))
            return p.layers.scale(i, bias=1.0), nv
        _, v = p.layers.while_loop(
            lambda i, v: p.layers.less_than(p.layers.reduce_sum(i), 2.5),
            body, [i0, p.layers.tanh(x)], maximum_trip_count=4)
        return _with_grads(p, [v], [x, w])
    run_pair(build, [dict({"x": _x((2, 2))}, **_cots(4))], tol=TOL)


# ---- the fluid classes -----------------------------------------------------

def test_while_class_accumulates():
    def build(p):
        L = p.layers
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        acc = L.fill_constant([1], "float32", 0.0)
        c = L.less_than(i, n)
        w = L.While(c)
        with w.block():
            L.assign(L.elementwise_add(acc, L.cast(i, "float32")), acc)
            L.increment(i, value=1)
            L.less_than(i, n, cond=c)
        return [L.scale(acc, scale=1.0), i]
    tout, _, _ = run_pair(build, [{}], exact=True)
    assert float(tout[0][0]) == 10.0 and int(tout[1][0]) == 5


@pytest.mark.parametrize("step", [5.0, 15.0, 50.0])
def test_switch_class_first_match_wins(step):
    def build(p):
        L = p.layers
        s = _data(p, "step", (1,))
        lr = L.fill_constant([1], "float32", -1.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(s, L.fill_constant([1], "float32",
                                                            10.0))):
                L.assign(L.fill_constant([1], "float32", 0.1), lr)
            with switch.case(L.less_than(s, L.fill_constant([1], "float32",
                                                            20.0))):
                L.assign(L.fill_constant([1], "float32", 0.01), lr)
            with switch.default():
                L.assign(L.fill_constant([1], "float32", 0.001), lr)
        return [L.scale(lr, scale=1.0)]
    tout, _, _ = run_pair(build, [{"step": np.array([step], np.float32)}],
                          exact=True)
    assert tout[0][0] == np.float32({5.0: 0.1, 15.0: 0.01, 50.0: 0.001}[step])


def test_switch_default_only():
    def build(p):
        L = p.layers
        lr = L.fill_constant([1], "float32", -1.0)
        with L.Switch() as switch:
            with switch.default():
                L.assign(L.fill_constant([1], "float32", 0.5), lr)
        return [L.scale(lr, scale=1.0)]
    tout, _, _ = run_pair(build, [{}], exact=True)
    assert tout[0][0] == 0.5


@pytest.mark.parametrize("is_reverse", [False, True])
def test_static_rnn_and_recurrent_scan_forward_and_grad(is_reverse):
    """StaticRNN's recurrent_scan, forward and backward through time into
    the input, the initial memory and the captured weight; with the op's
    ``is_reverse`` attr set in both programs, the scan from the end."""
    t, b, d = 5, 2, 3

    def build(p):
        L = p.layers
        x = _grad_data(p, "x", (t, b, d))
        h0 = _grad_data(p, "h0", (b, d))
        w = _param(p, "srnn_w", (d, d), seed=4)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = L.tanh(L.elementwise_add(L.matmul(x_t, w), h_prev))
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
        blk = p.default_main_program().global_block()
        blk.ops[-1].attrs["is_reverse"] = is_reverse
        return _with_grads(p, [out, rnn._finals[0]], [x, h0, w])
    run_pair(build, [dict({"x": _x((t, b, d)), "h0": _x((b, d), 1)},
                          **_cots(t * b * d, b * d))], tol=TOL)


def test_static_rnn_memory_from_shape():
    t, b, d = 4, 2, 3

    def build(p):
        L = p.layers
        x = _data(p, "x", (t, b, d))
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(shape=[-1, d], batch_ref=x_t, init_value=0.5)
            h = L.tanh(L.elementwise_add(x_t, h_prev))
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        return [rnn()]
    run_pair(build, [{"x": _x((t, b, d))}], tol=TOL)


def test_dynamic_rnn_respects_lengths_forward_and_grad():
    """Steps past a row's length emit zeros and freeze the memory; the
    gradient reaches the input's valid steps only."""
    b, t, d = 3, 4, 3

    def build(p):
        L = p.layers
        x = _grad_data(p, "x", (b, t, d))
        lens = _data(p, "lens", (b,), "int64")
        w = _param(p, "drnn_w", (d, d), seed=5)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths=lens)
            h_prev = drnn.memory(shape=[d], value=0.0)
            h = L.tanh(L.elementwise_add(L.matmul(x_t, w), h_prev))
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()
        return _with_grads(p, [out, drnn.final_states()[0]], [x, w])
    tout, _, _ = run_pair(build, [dict({"x": _x((b, t, d)),
                                        "lens": np.array([2, 4, 1])},
                                       **_cots(b * t * d, b * d))], tol=TOL)
    assert not tout[0][0, 2:].any() and not tout[0][2, 1:].any()
    assert not tout[2][0, 2:].any()


def test_ifelse_rowwise_merge_and_grad():
    def build(p):
        L = p.layers
        x = _grad_data(p, "x", (4, 2))
        c = L.greater_than(L.slice(x, axes=[1], starts=[0], ends=[1]),
                           L.fill_constant([4, 1], "float32", 0.0))
        ie = L.IfElse(c)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(L.exp(ie.input(x)))
        merged, = ie()
        return _with_grads(p, [merged], [x])
    run_pair(build, [dict({"x": _x((4, 2))}, **_cots(8))], tol=TOL)


def test_arrays_and_tensor_array_to_tensor():
    def build(p):
        L = p.layers
        arr = L.create_array("float32")
        for k in range(3):
            L.array_write(L.fill_constant([2, 2], "float32", float(k)), k,
                          arr)
        stacked, sizes = L.tensor_array_to_tensor(arr, axis=0,
                                                  use_stack=True)
        joined, jsizes = L.tensor_array_to_tensor(arr, axis=1)
        return [L.array_length(arr), L.array_read(arr, 1), stacked, sizes,
                joined, jsizes]
    tout, _, _ = run_pair(build, [{}], exact=True)
    assert int(tout[0][0]) == 3 and tout[2].shape == (3, 2, 2)
    assert tout[4].shape == (2, 6) and list(tout[5]) == [2, 2, 2]
    for p in (pt, ptt):
        with p.program_guard(p.Program(), p.Program()):
            arr = p.layers.create_array("float32")
            i = p.layers.fill_constant([1], "int64", 0)
            with pytest.raises(NotImplementedError):
                p.layers.array_write(p.layers.fill_constant(
                    [1], "float32", 1.0), i, arr)


def test_print_passes_values_and_gradients_through(capfd):
    def build(p):
        x = _grad_data(p, "x", (2, 2))
        y = p.layers.Print(x, message="dbg-msg")
        return _with_grads(p, [p.layers.scale(y, scale=3.0)], [x])
    run_pair(build, [dict({"x": _x((2, 2))}, **_cots(4))], exact=True)
    assert "dbg-msg" in capfd.readouterr().out


def test_is_empty_and_its_static_shape_rule():
    def build(p):
        x = _data(p, "x", (2, 2))
        z = p.layers.fill_constant([0, 3], "float32", 0.0)
        c = p.layers.fill_constant([1], "bool", True)
        p.layers.is_empty(z, cond=c)
        return [p.layers.is_empty(x), c]
    tout, _, _ = run_pair(build, [{"x": _x((2, 2))}], exact=True)
    assert not tout[0][0] and tout[1][0]
    for p in (pt, ptt):
        with p.program_guard(p.Program(), p.Program()):
            with pytest.raises(ValueError, match="static"):
                p.layers.is_empty(p.layers.data("d", [3]))


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor"])
def test_logical_ops(op):
    def build(p):
        a = p.layers.greater_than(_data(p, "a", (2, 3)), 0.0)
        b = p.layers.less_than(_data(p, "b", (2, 3)), 0.0)
        return [getattr(p.layers, op)(a, b), p.layers.logical_not(a)]
    tout, _, _ = run_pair(build, [{"a": _x((2, 3)), "b": _x((2, 3), 1)}],
                          exact=True)
    assert tout[0].dtype == np.bool_


def test_increment_in_place_and_not():
    def build(p):
        x = _data(p, "x", (2,))
        c = p.layers.fill_constant([1], "int64", 3)
        y = p.layers.increment(x, value=2.5, in_place=False)
        p.layers.increment(c, value=2.0)
        return [y, c]
    tout, _, _ = run_pair(build, [{"x": _x((2,))}], exact=True)
    assert int(tout[1][0]) == 5


def test_reorder_lod_tensor_by_rank_forward_and_grad():
    """Rows stably sorted by descending length (ties keep their order)."""
    def build(p):
        x = _grad_data(p, "x", (4, 2))
        lens = _data(p, "lens", (4,), "int64")
        table = p.layers.lod_rank_table(x, lengths=lens)
        return _with_grads(p, [p.layers.reorder_lod_tensor_by_rank(x, table)],
                           [x])
    xv = _x((4, 2))
    tout, _, _ = run_pair(build, [dict({"x": xv, "lens": np.array([1, 3, 2,
                                                                   3])},
                                       **_cots(8))], exact=True)
    np.testing.assert_array_equal(tout[0], xv[[1, 3, 2, 0]])


@pytest.mark.parametrize("axis", [[1], [0, 2], -1])
def test_reverse_forward_and_grad(axis):
    def build(p):
        x = _grad_data(p, "x", (2, 3, 2))
        return _with_grads(p, [p.layers.reverse(x, axis)], [x])
    run_pair(build, [dict({"x": _x((2, 3, 2))}, **_cots(12))], exact=True)


def _select_input(p, xs, mask):
    """The ``select_input`` op (no layer of either package emits it)."""
    helper = p.layer_helper.LayerHelper("select_input")
    out = helper.create_variable_for_type_inference("float32", xs[0].shape)
    helper.append_op("select_input",
                     inputs={"X": [x.name for x in xs], "Mask": [mask.name]},
                     outputs={"Out": [out.name]})
    return out


@pytest.mark.parametrize("mask", [0, 1, 2])
def test_select_input_forward_and_grad(mask):
    def build(p):
        xs = [_grad_data(p, "x%d" % i, (2, 2)) for i in range(3)]
        m = _data(p, "m", (1,), "int32")
        return _with_grads(p, [_select_input(p, xs, m)], xs)
    feed = {"x%d" % i: _x((2, 2), i) for i in range(3)}
    run_pair(build, [dict(feed, m=np.array([mask], np.int32), **_cots(4))],
             exact=True)


# ---- how a program meets the CUDA graph ------------------------------------

def _host_sync_of(build):
    main, _, _ = _build(ptt, build)
    return texecutor._host_sync(main)


def test_programs_that_choose_on_the_host_are_never_captured():
    """A cond, a while_loop (also inside a sub-block) or a Print makes the
    Executor refuse capture, naming the op; the loops whose trip count the
    program fixes (bounded_while, StaticRNN/DynamicRNN/rnn's
    recurrent_scan) and select_input do not."""
    def cond(p):
        pred = p.layers.greater_than(p.layers.reduce_sum(_flag(p)), 0.5)
        return [p.layers.cond(pred, lambda: _flag(p), lambda: _flag(p))]

    def nested_while(p):
        pred = p.layers.greater_than(p.layers.reduce_sum(_flag(p)), 0.5)
        return [p.layers.cond(pred, lambda: _counting_loop(
            p, None, p.layers.tanh)[1], lambda: _data(p, "x", (3,)))]

    def printed(p):
        return [p.layers.Print(_flag(p))]
    assert "{cond}" in _host_sync_of(cond)
    assert "{while_loop}" in _host_sync_of(
        lambda p: [_counting_loop(p, None, p.layers.tanh)[1]])
    assert "{cond}" in _host_sync_of(nested_while)
    assert "{print}" in _host_sync_of(printed)
    assert _host_sync_of(
        lambda p: [_counting_loop(p, 4, p.layers.tanh)[1]]) is None
    assert _host_sync_of(lambda p: [_select_input(
        p, [_flag(p, "a"), _flag(p, "b")], _data(p, "m", (1,), "int32"))]) \
        is None


def test_cpu_runs_record_no_refusal():
    """A CPU place never captures, so nothing is refused there."""
    main, startup, fetch = _build(ptt, lambda p: [p.layers.cond(
        p.layers.greater_than(p.layers.reduce_sum(_flag(p)), 0.5),
        lambda: p.layers.scale(_flag(p), 2.0), lambda: _flag(p))])
    exe = ptt.Executor(ptt.CPUPlace())
    out, = exe.run(main, feed={"flag": np.ones(1, np.float32)},
                   fetch_list=fetch, scope=ptt.Scope())
    assert out[0] == 2.0
    assert exe.refusals == {} and exe.graph_runs["refused"] == 0
