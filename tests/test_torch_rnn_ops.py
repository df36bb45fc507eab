"""The recurrent sequence stack's ops, the port against the JAX package.

Each op is built through the public ``layers`` API of both packages (same
calls, same unique names) and run with each package's
``Executor(CPUPlace())`` on the same numpy feeds, from the JAX startup's
parameters copied into the port (``run_pair``); values and gradients
(``gradients`` of sum_i <out_i, cot_i>, the cotangents fed as data) are
compared.

Tolerances: f32 on both sides. Ops that move data (squeeze2, stack,
sequence_mask, sequence_reverse) and the Viterbi paths agree exactly.
One reduction or one recursion of a few steps differs only in the order
of its sums: rtol 1e-5, atol 1e-5. An integer output is int64 in the
port and int32 in the JAX package (which runs without x64): its dtype
is held to that rule and its values exactly.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

N, T, H, C = 3, 6, 4, 5


def _param(p, name):
    return p.default_main_program().global_block().var(name)


def _last_op(p, op_type):
    return [o for o in p.default_main_program().global_block().ops
            if o.type == op_type][-1]


@pytest.mark.parametrize("axes", [[1], [0, 2], [-1], [1, 2], []])
def test_squeeze2_forward_and_grad(axes):
    """An axis of size 1 goes; a listed axis of another size stays."""
    shape = (2, 1, 1) if axes != [0, 2] else (1, 3, 1)

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.squeeze(x, axes)], [x])
    run_pair(build, [dict({"x": _x(shape)}, **_cots(2 if axes != [0, 2]
                                                    else 3))], exact=True)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack_forward_and_grad(axis):
    def build(p):
        xs = [_grad_data(p, "x%d" % i, (2, 3)) for i in range(3)]
        return _with_grads(p, [p.layers.stack(xs, axis=axis)], xs)
    feed = {"x%d" % i: _x((2, 3), i) for i in range(3)}
    run_pair(build, [dict(feed, **_cots(18))], exact=True)


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_sequence_mask(dtype):
    def build(p):
        lens = _data(p, "lens", (4,), "int64")
        return [p.layers.sequence_mask(lens, maxlen=5, dtype=dtype)]
    tout, _, _ = run_pair(build, [{"lens": np.array([0, 2, 5, 7])}],
                          exact=True)
    assert tout[0].shape == (4, 5) and tout[0].dtype == np.dtype(dtype)


def test_sequence_mask_needs_a_static_maxlen():
    for p in (pt, ptt):
        main, startup = p.Program(), p.Program()
        with p.program_guard(main, startup):
            lens = _data(p, "lens", (2,), "int64")
            mask = p.layers.sequence_mask(lens)
        with pytest.raises(ValueError, match="static maxlen"):
            p.Executor(p.CPUPlace()).run(
                main, feed={"lens": np.array([1, 2])}, fetch_list=[mask])


@pytest.mark.parametrize("dim,keep_dim", [(None, False), (None, True),
                                          (1, False), ([0, 2], True),
                                          (-1, False)])
def test_reduce_mean_forward_and_grad(dim, keep_dim):
    shape = (2, 3, 4)

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.reduce_mean(x, dim=dim,
                                                    keep_dim=keep_dim)],
                           [x])
    size = int(np.prod(np.mean(np.zeros(shape), axis=None if dim is None
                               else tuple(np.atleast_1d(dim)),
                               keepdims=keep_dim).shape or (1,)))
    run_pair(build, [dict({"x": _x(shape)}, **_cots(size))])


def test_sequence_reverse_forward_and_grad():
    """Each valid prefix reversed, the padding in place; a row of length
    0 and a full row."""
    shape = (4, 5, 3)

    def build(p):
        x = _grad_data(p, "x", shape)
        lens = _data(p, "lens", (4,), "int64")
        return _with_grads(p, [p.layers.sequence_reverse(x, lens)], [x])
    x = _x(shape)
    lens = np.array([5, 3, 0, 1])
    tout, _, _ = run_pair(build, [dict({"x": x, "lens": lens},
                                       **_cots(60))], exact=True)
    np.testing.assert_array_equal(tout[0][1, :3], x[1, 2::-1])
    np.testing.assert_array_equal(tout[0][1, 3:], x[1, 3:])
    np.testing.assert_array_equal(tout[0][2], x[2])


def test_sequence_reverse_without_lengths_waits_for_its_slice():
    """Its slice (the op library) has come: without lengths the layer
    flips the whole time axis, as the JAX package's does, values and
    gradient."""
    def build(p):
        x = _grad_data(p, "x", (2, 3, 4))
        return _with_grads(p, [p.layers.sequence_reverse(x)], [x])
    tout, _, _ = run_pair(build, [dict({"x": _x((2, 3, 4))}, **_cots(24))])
    np.testing.assert_array_equal(tout[0], _x((2, 3, 4))[:, ::-1])


@pytest.mark.parametrize("is_reverse,with_h0", [(False, False),
                                                (True, False),
                                                (False, True),
                                                (True, True)])
def test_gru_seq_forward_and_grad(is_reverse, with_h0):
    """Hidden and the gradients to the projected input, the weight, the
    bias and H0."""
    def build(p):
        x = _grad_data(p, "x", (N, T, 3 * H))
        h0 = _grad_data(p, "h0", (N, H)) if with_h0 else None
        out = p.layers.dynamic_gru(x, H, is_reverse=is_reverse, h_0=h0)
        op = _last_op(p, "gru_seq")
        wrt = [x, _param(p, op.input("Weight")[0]),
               _param(p, op.input("Bias")[0])] + ([h0] if with_h0 else [])
        return _with_grads(p, [out], wrt)
    feed = dict({"x": _x((N, T, 3 * H)), "h0": _x((N, H), 1)},
                **_cots(N * T * H))
    # a bias away from 0, so its gradient path is exercised
    run_pair(build, [feed],
             state={"dynamic_gru_0.b_0_0": _x((3 * H,), 2)})


@pytest.mark.parametrize("is_reverse,with_h0", [(False, False),
                                                (True, True)])
def test_lstm_seq_forward_and_grad(is_reverse, with_h0):
    """Hidden and Cell, and the gradients to the projected input, the
    weight, the bias, H0 and C0."""
    def build(p):
        x = _grad_data(p, "x", (N, T, 4 * H))
        h0 = _grad_data(p, "h0", (N, H)) if with_h0 else None
        c0 = _grad_data(p, "c0", (N, H)) if with_h0 else None
        hid, cell = p.layers.dynamic_lstm(x, 4 * H, h_0=h0, c_0=c0,
                                          is_reverse=is_reverse)
        op = _last_op(p, "lstm_seq")
        wrt = [x, _param(p, op.input("Weight")[0]),
               _param(p, op.input("Bias")[0])] + \
            ([h0, c0] if with_h0 else [])
        return _with_grads(p, [hid, cell], wrt)
    feed = dict({"x": _x((N, T, 4 * H)), "h0": _x((N, H), 1),
                 "c0": _x((N, H), 2)}, **_cots(N * T * H, N * T * H))
    run_pair(build, [feed],
             state={"dynamic_lstm_0.b_0_0": _x((4 * H,), 3)})


def test_gru_unit_forward_and_grad():
    """Hidden, ResetHiddenPrev and Gate, and the gradients to the input,
    the previous state, the weight and the bias."""
    def build(p):
        x = _grad_data(p, "x", (N, 3 * H))
        hp = _grad_data(p, "hp", (N, H))
        outs = p.layers.gru_unit(x, hp, 3 * H)
        op = _last_op(p, "gru_unit")
        return _with_grads(p, list(outs), [
            x, hp, _param(p, op.input("Weight")[0]),
            _param(p, op.input("Bias")[0])])
    feed = dict({"x": _x((N, 3 * H)), "hp": _x((N, H), 1)},
                **_cots(N * H, N * H, N * 3 * H))
    run_pair(build, [feed], state={"gru_unit_0.b_0_0": _x((3 * H,), 2)})


def _crf_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"em": rng.randn(N, T, C).astype(np.float32),
            "label": rng.randint(0, C, (N, T)).astype(np.int64),
            "len": np.array([T, 3, 1], np.int64)}


@pytest.mark.parametrize("with_length", [True, False])
def test_linear_chain_crf_forward_and_grad(with_length):
    """The log-likelihood and its gradients to the emissions and the
    transition parameter, with and without Length (a row of length 1
    among them)."""
    def build(p):
        em = _grad_data(p, "em", (N, T, C))
        label = _data(p, "label", (N, T), "int64")
        length = _data(p, "len", (N,), "int64") if with_length else None
        ll = p.layers.linear_chain_crf(
            em, label, param_attr=p.ParamAttr(name="crfw"), length=length)
        return _with_grads(p, [ll], [em, _param(p, "crfw")])
    run_pair(build, [dict(_crf_feed(), **_cots(N))])


def test_crf_decoding_paths_and_ties():
    """Viterbi paths equal, 0 past each length, int64 here and int32 in
    the JAX package; emissions and transitions of small integers make
    ties, where both take the first label."""
    rng = np.random.RandomState(3)
    trans = rng.randint(-2, 3, (C + 2, C)).astype(np.float32)

    def build(p):
        em = _data(p, "em", (N, T, C), "float32")
        length = _data(p, "len", (N,), "int64")
        path = p.layers.crf_decoding(em, p.ParamAttr(name="crfw"),
                                     length=length)
        full = p.layers.crf_decoding(em, p.ParamAttr(name="crfw"))
        return [path, full]
    ties = {"em": rng.randint(-2, 3, (N, T, C)).astype(np.float32),
            "len": np.array([T, 3, 0], np.int64)}
    for feed in (ties, {k: _crf_feed(1)[k] for k in ("em", "len")}):
        tout, (jmain, _), (jscope, _) = run_pair(
            build, [feed], state={"crfw": trans}, exact=True)
        with pt.scope_guard(jscope):
            jout = pt.Executor(pt.CPUPlace()).run(
                jmain, feed=feed, fetch_list=[
                    o.output("ViterbiPath")[0]
                    for o in jmain.global_block().ops
                    if o.type == "crf_decoding"])
        assert [np.asarray(j).dtype for j in jout] == [np.int32] * 2
        assert [t.dtype for t in tout] == [np.int64] * 2
        assert tout[0].shape == (N, T, 1)
        for row, n in enumerate(feed["len"]):
            assert (tout[0][row, n:] == 0).all()


def _ctc_build(norm_by_times):
    def build(p):
        logits = _grad_data(p, "logits", (8, 4, C))
        label = _data(p, "label", (4, 3), "int32")
        in_len = _data(p, "in_len", (4,), "int64")
        lbl_len = _data(p, "lbl_len", (4,), "int64")
        loss = p.layers.warpctc(logits, label, blank=C - 1,
                                norm_by_times=norm_by_times,
                                input_length=in_len, label_length=lbl_len)
        return _with_grads(p, [loss], [logits])
    return build


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc_forward_and_grad(norm_by_times):
    """Rows: a full alignment; a repeated label, which needs a blank
    between its copies; a zero-length label; and an infeasible row (three
    equal labels need 5 steps, it has 3): loss inf and a zero gradient
    for that row only. ``norm_by_times`` scales the gradient by 1 /
    length and leaves the loss as it is."""
    feed = {"logits": _x((8, 4, C)),
            "label": np.array([[0, 1, 2], [1, 1, 0], [3, 3, 3],
                               [2, 2, 2]], np.int32),
            "in_len": np.array([8, 6, 5, 3], np.int64),
            "lbl_len": np.array([3, 2, 0, 3], np.int64)}
    cot = _cots(4)
    cot["cot0"][3] = 1.0                   # the infeasible row's weight
    tout, _, _ = run_pair(_ctc_build(norm_by_times), [dict(feed, **cot)])
    loss, grad = tout
    assert np.isinf(loss[3, 0]) and np.isfinite(loss[:3]).all()
    assert (grad[:, 3] == 0).all() and np.abs(grad[:, :3]).max() > 0
    if norm_by_times:
        plain, _, _ = run_pair(_ctc_build(False), [dict(feed, **cot)])
        np.testing.assert_array_equal(loss, plain[0])
        scale = 1.0 / feed["in_len"][:3]
        np.testing.assert_allclose(grad[:, :3], plain[1][:, :3] * scale
                                   [None, :, None], rtol=1e-5, atol=1e-7)


def test_basic_gru_bidirectional_with_lengths():
    """Two bidirectional layers over a padded batch with a row of length
    0 (the Predictor's padding rows): the outputs, the last states (zeros
    for the empty row; its one-hot index is -1) and the gradient to the
    input agree, and are finite."""
    def build(p):
        x = _grad_data(p, "x", (4, T, 3))
        lens = _data(p, "lens", (4,), "int64")
        out, last = p.contrib.layers.basic_gru(
            x, None, hidden_size=H, num_layers=2, bidirectional=True,
            sequence_length=lens)
        return _with_grads(p, [out, last], [x])
    feed = dict({"x": _x((4, T, 3)), "lens": np.array([T, 2, 0, 5])},
                **_cots(4 * T * 2 * H, 4 * 4 * H))
    tout, (jmain, tmain), _ = run_pair(
        build, [feed], state={"dynamic_gru_%d.b_0_0" % i: _x((3 * H,), i)
                              for i in range(4)})
    out, last = tout[0], tout[1]
    assert out.shape == (4, T, 2 * H) and last.shape == (4, 4, H)
    assert all(np.isfinite(t).all() for t in tout)
    assert (out[2] == 0).all() and (out[1, 2:] == 0).all()
    assert (last[:, 2] == 0).all()
    assert [p.name for p in jmain.all_parameters()] == \
        [p.name for p in tmain.all_parameters()]


def test_basic_lstm_unidirectional():
    """basic_lstm without lengths: the last states are the final step's."""
    def build(p):
        x = _grad_data(p, "x", (N, T, 3))
        out, last_h, last_c = p.contrib.layers.basic_lstm(
            x, None, None, hidden_size=H)
        return _with_grads(p, [out, last_h, last_c], [x])
    tout, _, _ = run_pair(build, [dict({"x": _x((N, T, 3))},
                                       **_cots(N * T * H, N * H, N * H))])
    np.testing.assert_array_equal(tout[1][0], tout[0][:, -1])
