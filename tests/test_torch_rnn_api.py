"""The cell-based RNN API (``layers.rnn``, ``GRUCell``, ``LSTMCell``,
``lstm``, ``dynamic_lstmp``, ``BeamSearchDecoder`` + ``dynamic_decode``,
``beam_search``, ``beam_search_decode``) and the contrib decoders
(``InitState``, ``StateCell``, ``TrainingDecoder``, contrib
``BeamSearchDecoder``), the port against the JAX package.

Each case is built through the public API of both packages (same calls,
same unique names) and run with each package's ``Executor(CPUPlace())``
on the same numpy feeds, from the JAX startup's parameters copied into
the port (``run_pair``); values and gradients (``gradients`` of
sum_i <out_i, cot_i> into the input and every parameter) are compared.

Tolerances: f32 on both sides; an RNN of a few steps differs only in the
order of the sums inside each step's matmuls: rtol 1e-5, atol 1e-5
(TOL). A few Adam steps through the contrib decoder: rtol 1e-4, atol
1e-5 (ADAM_TOL). Beam search picks: the selected ids and parents agree
exactly; the scores within TOL. Integer outputs are int64 in the port
and int32 in the JAX package (without x64): values exactly.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)
B, T, D, H = 3, 5, 4, 6


def _params(p):
    return list(p.default_main_program().all_parameters())


def _uniform(p):
    """The seq2seq recipe's initialiser: U(-0.1, 0.1) from a fixed seed."""
    return p.ParamAttr(initializer=p.initializer.Uniform(-0.1, 0.1, seed=7))


def _cell(p, kind, hidden=H, name=None):
    cls = {"gru": p.layers.GRUCell, "lstm": p.layers.LSTMCell}[kind]
    return cls(hidden_size=hidden, param_attr=_uniform(p),
               name=name or kind + "_cell")


def _n_out(kind, b=B, t=T, h=H):
    """Sizes of (outputs, final states) for _cots."""
    return (b * t * h,) + ((b * h,) if kind == "gru" else (b * h, b * h))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_rnn_forward_and_grad(kind, lengths, is_reverse):
    """rnn(cell) with and without sequence_length and is_reverse: the
    outputs (zero past each length), the final states (at each row's
    last valid step) and the gradients into the input and the cell's
    parameters."""
    def build(p):
        x = _grad_data(p, "x", (B, T, D))
        lens = _data(p, "lens", (B,), "int64") if lengths else None
        out, final = p.layers.rnn(_cell(p, kind), x, sequence_length=lens,
                                  is_reverse=is_reverse)
        finals = final if isinstance(final, list) else [final]
        return _with_grads(p, [out] + finals, [x] + _params(p))
    feed = dict({"x": _x((B, T, D))}, **_cots(*_n_out(kind)))
    if lengths:
        feed["lens"] = np.array([5, 2, 3])
    tout, _, _ = run_pair(build, [feed], tol=TOL)
    if lengths:
        assert not tout[0][1, 2:].any()


def test_rnn_time_major_and_initial_states():
    def build(p):
        x = _grad_data(p, "x", (T, B, D))
        h0 = _grad_data(p, "h0", (B, H))
        out, final = p.layers.rnn(_cell(p, "gru"), x, initial_states=h0,
                                  time_major=True)
        return _with_grads(p, [out, final], [x, h0] + _params(p))
    run_pair(build, [dict({"x": _x((T, B, D)), "h0": _x((B, H), 1)},
                          **_cots(T * B * H, B * H))], tol=TOL)


def test_lstm_wrapper_and_dynamic_lstmp():
    """layers.lstm (two bidirectional layers over contrib basic_lstm) and
    dynamic_lstmp (a projected LSTM over rnn), with their gradients."""
    def build(p):
        x = _grad_data(p, "x", (2, 6, 3))
        rout, lh, lc = p.layers.lstm(x, None, None, max_len=6, hidden_size=4,
                                     num_layers=2, is_bidirec=True)
        proj = p.layers.fc(x, size=16, num_flatten_dims=2, bias_attr=False)
        p_out, c_out = p.layers.dynamic_lstmp(proj, size=16, proj_size=3)
        return _with_grads(p, [rout, lh, lc, p_out, c_out], [x])
    tout, _, _ = run_pair(build, [dict({"x": _x((2, 6, 3))},
                                       **_cots(96, 32, 32, 36, 48))], tol=TOL)
    assert tout[0].shape == (2, 6, 8) and tout[1].shape == (4, 2, 4)
    assert tout[3].shape == (2, 6, 3) and tout[4].shape == (2, 6, 4)


V, BEAM, STEPS = 11, 3, 4


def _beam_decoder(p, cell, beam=BEAM, prefix="dd"):
    def emb(ids):
        return p.layers.reshape(p.layers.embedding(
            ids, size=[V, D], param_attr=p.ParamAttr(name=prefix + "_emb")),
            [-1, D])

    def out_fn(h):
        return p.layers.fc(h, size=V,
                           param_attr=p.ParamAttr(name=prefix + "_fc_w"),
                           bias_attr=p.ParamAttr(name=prefix + "_fc_b"))
    return p.layers.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                      beam_size=beam, embedding_fn=emb,
                                      output_fn=out_fn)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_dynamic_decode_beam_search(kind):
    """dynamic_decode(BeamSearchDecoder): the back-traced ids exactly,
    the final states and log-probs within TOL, an ended beam emitting
    only the end token."""
    def build(p):
        enc = _data(p, "enc", (B, H))
        init = enc if kind == "gru" else [enc, p.layers.scale(enc, 0.5)]
        ids, final = p.layers.dynamic_decode(
            _beam_decoder(p, _cell(p, kind)), inits=init,
            max_step_num=STEPS)
        cell_states = final.cell_states if kind == "lstm" \
            else [final.cell_states]
        return [ids, final.log_probs, final.lengths] + cell_states
    for seed in (0, 5):
        tout, _, _ = run_pair(build, [{"enc": _x((B, H), seed) * 3.0}],
                              tol=TOL)
        ids = tout[0]
        assert ids.shape == (B, BEAM, STEPS)
        ended = np.cumsum(ids == 1, axis=2) > 0
        assert (ids[:, :, 1:][ended[:, :, :-1]] == 1).all()


def test_dynamic_decode_output_time_major():
    def build(p):
        enc = _data(p, "enc", (B, H))
        ids, _ = p.layers.dynamic_decode(
            _beam_decoder(p, _cell(p, "gru"), beam=2), inits=enc,
            max_step_num=3, output_time_major=True)
        return [ids]
    tout, _, _ = run_pair(build, [{"enc": _x((B, H), 2)}], exact=True)
    assert tout[0].shape == (3, B, 2)


def test_beam_search_step():
    """One beam_search step: the best candidates win, a frozen row (its
    previous id is the end id) re-emits only the end id at its score."""
    nb, b, k, end = 2, 2, 3, 9
    feed = {"pi": np.array([[3], [end], [4], [5]], np.int64),
            "ps": np.array([[0.0], [-1.0], [-0.5], [-2.0]], np.float32),
            "ci": np.tile(np.array([[5, 6, end]], np.int64), (nb * b, 1)),
            "cs": np.array([[-0.1, -2.0, -3.0], [-9.0, -9.0, -9.0],
                            [-0.3, -0.9, -4.0], [-0.4, -0.5, -5.0]],
                           np.float32)}

    def build(p):
        pi = _data(p, "pi", (nb * b, 1), "int64")
        ps = _data(p, "ps", (nb * b, 1))
        ci = _data(p, "ci", (nb * b, k), "int64")
        cs = _data(p, "cs", (nb * b, k))
        acc = p.layers.beam_search(pi, ps, ci, cs, beam_size=b, end_id=end,
                                   return_parent_idx=True)
        step = p.layers.beam_search(pi, ps, ci, cs, beam_size=b, end_id=end,
                                    is_accumulated=False)
        return list(acc) + list(step)
    tout, _, _ = run_pair(build, [feed], exact=True)
    np.testing.assert_array_equal(tout[0].reshape(nb, b), [[5, end], [5, 5]])
    np.testing.assert_array_equal(tout[2].reshape(nb, b), [[0, 1], [0, 1]])


def test_beam_search_decode_backtrace():
    """Step-2 winners descending from step-1 beam 1 carry its prefix."""
    feed = {"i1": np.array([[7], [8], [5], [6]], np.int64),
            "i2": np.array([[3], [4], [2], [1]], np.int64),
            "p2": np.array([1, 1, 0, 0], np.int64),
            "s1": np.full((4, 1), -0.5, np.float32)}

    def build(p):
        i1 = _data(p, "i1", (4, 1), "int64")
        i2 = _data(p, "i2", (4, 1), "int64")
        p2 = _data(p, "p2", (4,), "int64")
        s1 = _data(p, "s1", (4, 1))
        seqs, scores = p.layers.beam_search_decode(
            [i1, i2], [None, p2], beam_size=2, end_id=1, scores=[s1, s1])
        return [seqs, scores]
    tout, _, _ = run_pair(build, [feed], exact=True)
    np.testing.assert_array_equal(tout[0], [[[8, 3], [8, 4]],
                                            [[5, 2], [5, 1]]])


# ---- the contrib decoders --------------------------------------------------

def _state_cell(p, boot):
    from_pkg = __import__(p.__name__ + ".contrib.decoder",
                          fromlist=["InitState", "StateCell"])
    cell = from_pkg.StateCell(inputs={"x": None},
                              states={"h": from_pkg.InitState(init=boot)},
                              out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", p.layers.fc(
            p.layers.concat([c.get_input("x"), c.get_state("h")], axis=-1),
            size=H, act="tanh", param_attr=p.ParamAttr(name="cellw"),
            bias_attr=p.ParamAttr(name="cellb")))
    return cell, from_pkg


def _training_decoder(p, lr=None):
    src = _grad_data(p, "src", (B, H))
    trg = _data(p, "trg", (B, T), "int64")
    emb = p.layers.embedding(trg, size=[V, D],
                             param_attr=p.ParamAttr(name="trg_emb"))
    cell, dec_mod = _state_cell(p, src)
    dec = dec_mod.TrainingDecoder(cell)
    with dec.block():
        w = dec.step_input(emb)
        cell.compute_state(inputs={"x": w})
        dec.output(cell.out_state())
        cell.update_states()
    out = dec()
    if lr is None:
        return _with_grads(p, [out], [src] + _params(p))
    loss = p.layers.reduce_mean(p.layers.square(out))
    p.optimizer.Adam(lr).minimize(loss)
    return [loss, out]


def _trg_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"src": rng.randn(B, H).astype(np.float32),
            "trg": rng.randint(0, V, (B, T)).astype(np.int64)}


def test_contrib_training_decoder_forward_and_grad():
    run_pair(_training_decoder, [dict(_trg_feed(), **_cots(B * T * H))],
             tol=TOL)


def test_contrib_training_decoder_trains():
    """Three Adam steps: losses, outputs and every parameter and moment."""
    tout, _, (jscope, tscope) = run_pair(
        lambda p: _training_decoder(p, lr=1e-2), [_trg_feed()] * 3,
        tol=ADAM_TOL)
    assert tout[1].shape == (B, T, H)
    for name in ("cellw", "cellb", "trg_emb"):
        np.testing.assert_allclose(
            ptt.framework.scope.to_numpy(tscope.find_var(name)),
            np.asarray(jscope.find_var(name)), **ADAM_TOL)


@pytest.mark.parametrize("beam", [1, 3])
def test_contrib_beam_search_decoder(beam):
    """decode(): translation ids exactly, scores within TOL, best first."""
    def build(p):
        src = _data(p, "src", (B, H))
        init_ids = _data(p, "init_ids", (B, 1), "int64")
        init_sc = _data(p, "init_sc", (B, 1))
        cell, dec_mod = _state_cell(p, src)
        bsd = dec_mod.BeamSearchDecoder(cell, init_ids, init_sc,
                                        target_dict_dim=V, word_dim=D,
                                        max_len=STEPS, beam_size=beam,
                                        end_id=1, name="bsd")
        bsd.decode()
        return list(bsd())
    feed = {"src": _x((B, H), 4) * 2.0,
            "init_ids": np.zeros((B, 1), np.int64),
            "init_sc": np.zeros((B, 1), np.float32)}
    tout, _, _ = run_pair(build, [feed], tol=TOL)
    assert tout[0].shape == (B, beam, STEPS)
    assert (np.diff(tout[1], axis=1) <= 0).all()
