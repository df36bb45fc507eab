"""An LSTM seq2seq built from the ported user API, trained a few Adam
steps and beam-decoded, the port against the JAX package.

The model is PaddlePaddle/models PaddleNLP/seq2seq/seq2seq's base model
(IWSLT'15 en->vi) at small widths: a stacked ``LSTMCell`` encoder run
through ``layers.rnn`` with the source lengths, a stacked ``LSTMCell``
decoder started from the encoder's final states and teacher-forced
through ``layers.rnn``, a vocabulary projection, a masked
``softmax_with_cross_entropy``, Adam with a global-norm clip of 5, and
for inference ``dynamic_decode(BeamSearchDecoder)`` over the same
parameters. No model module holds it: ``seq2seq_programs`` below builds
it in either package (chip_smoke.py builds the same at full width).

Tolerances: three Adam steps through two 2-layer LSTMs of 6 and 5 steps
in f32: losses rtol 1e-5, every parameter, moment and fetched output
rtol 1e-4, atol 1e-5 (Adam divides by sqrt(v), which magnifies a 1e-7
difference in a small gradient). The beam decode from the trained
weights: ids exactly, scores rtol 1e-5, atol 1e-5; the Predictor's
answers (a batch of 3 padded to the bucket of 4) against its Executor's
at the request's own batch: ids exactly, scores within the same
tolerance (a padded batch may sum a product in another order).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.scope import to_numpy

SMALL = dict(src_vocab=31, trg_vocab=29, hidden=16, n_layers=2, batch=4,
             src_len=6, trg_len=5, beam=3, max_decode=5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
BOS, EOS = 1, 2
STEPS = 3


def stacked_cell(p, n_layers, hidden, name):
    """An RNNCell of ``n_layers`` LSTMCells, each layer's output the next
    one's input; states [[h, c], ...] (the recipe's encoder and decoder
    cells, dropout 0)."""
    class Stacked(p.layers.RNNCell):
        def __init__(self):
            attr = p.ParamAttr(initializer=p.initializer.Uniform(
                -0.1, 0.1, seed=11))
            self.cells = [p.layers.LSTMCell(hidden, param_attr=attr,
                                            name="%s_l%d" % (name, i))
                          for i in range(n_layers)]

        @property
        def state_shape(self):
            return [c.state_shape for c in self.cells]

        def call(self, inputs, states):
            new = []
            for cell, state in zip(self.cells, states):
                inputs, s = cell(inputs, state)
                new.append(s)
            return inputs, new
    return Stacked()


def _embedding(p, ids, vocab, hidden, name):
    return p.layers.embedding(
        ids, size=[vocab, hidden], param_attr=p.ParamAttr(
            name=name, initializer=p.initializer.Uniform(-0.1, 0.1, seed=12)))


def _encoder(p, w, batch):
    src = p.layers.data("src", [batch, w["src_len"]], "int64",
                        append_batch_size=False)
    src_len = p.layers.data("src_len", [batch], "int64",
                            append_batch_size=False)
    emb = _embedding(p, src, w["src_vocab"], w["hidden"], "src_emb")
    zero = lambda: p.layers.fill_constant_batch_size_like(  # noqa: E731
        emb, [-1, w["hidden"]], "float32", 0.0)
    init = [[zero(), zero()] for _ in range(w["n_layers"])]
    _, final = p.layers.rnn(stacked_cell(p, w["n_layers"], w["hidden"],
                                         "enc"),
                            emb, initial_states=init, sequence_length=src_len)
    return final


def _projection(p, x, w, flatten):
    return p.layers.fc(x, w["trg_vocab"], num_flatten_dims=flatten,
                       bias_attr=False, param_attr=p.ParamAttr(
                           name="out_w", initializer=p.initializer.Uniform(
                               -0.1, 0.1, seed=13)))


def seq2seq_programs(p, w, lr=1e-3):
    """(train main, train startup, [loss, logits], decode main (any
    batch), decode startup, [ids, scores]): the two programs share every
    parameter name."""
    train, startup = p.Program(), p.Program()
    with p.unique_name.guard(), p.program_guard(train, startup):
        final = _encoder(p, w, w["batch"])
        trg = p.layers.data("trg", [w["batch"], w["trg_len"]], "int64",
                            append_batch_size=False)
        trg_len = p.layers.data("trg_len", [w["batch"]], "int64",
                                append_batch_size=False)
        label = p.layers.data("label", [w["batch"], w["trg_len"], 1],
                              "int64", append_batch_size=False)
        emb = _embedding(p, trg, w["trg_vocab"], w["hidden"], "trg_emb")
        out, _ = p.layers.rnn(stacked_cell(p, w["n_layers"], w["hidden"],
                                           "dec"), emb, initial_states=final)
        logits = _projection(p, out, w, 2)
        ce = p.layers.softmax_with_cross_entropy(logits, label)
        mask = p.layers.unsqueeze(p.layers.sequence_mask(
            trg_len, maxlen=w["trg_len"], dtype="float32"), [2])
        loss = p.layers.reduce_sum(p.layers.reduce_mean(
            p.layers.elementwise_mul(ce, mask), dim=[0]))
        p.optimizer.Adam(lr, grad_clip=p.clip.GradientClipByGlobalNorm(
            5.0)).minimize(loss)
    decode, dstart = p.Program(), p.Program()
    with p.unique_name.guard(), p.program_guard(decode, dstart):
        final = _encoder(p, w, -1)
        emb = lambda ids: p.layers.reshape(_embedding(  # noqa: E731
            p, ids, w["trg_vocab"], w["hidden"], "trg_emb"),
            [-1, w["hidden"]])
        decoder = p.layers.BeamSearchDecoder(
            stacked_cell(p, w["n_layers"], w["hidden"], "dec"),
            start_token=BOS, end_token=EOS, beam_size=w["beam"],
            embedding_fn=emb, output_fn=lambda h: _projection(p, h, w, 1))
        ids, states = p.layers.dynamic_decode(decoder, inits=final,
                                              max_step_num=w["max_decode"])
    return train, startup, [loss, logits], decode, dstart, \
        [ids, states.log_probs]


def seq2seq_batch(w, seed=0):
    """Token ids in [3, vocab) (0 pad, 1 bos, 2 eos), random lengths."""
    rng = np.random.RandomState(seed)
    n, s, t = w["batch"], w["src_len"], w["trg_len"]
    src_len = rng.randint(1, s + 1, n)
    trg_len = rng.randint(1, t + 1, n)
    src = rng.randint(3, w["src_vocab"], (n, s))
    src[np.arange(s)[None, :] >= src_len[:, None]] = 0
    trg = rng.randint(3, w["trg_vocab"], (n, t))
    trg[:, 0] = BOS
    label = np.concatenate([trg[:, 1:], np.full((n, 1), EOS)], 1)
    return {"src": src.astype(np.int64), "src_len": src_len.astype(np.int64),
            "trg": trg.astype(np.int64), "trg_len": trg_len.astype(np.int64),
            "label": label[..., None].astype(np.int64)}


def _train_and_decode(w):
    """Both packages: STEPS Adam steps from the JAX startup's weights,
    then the beam decode from each package's trained scope."""
    jt, js, jf, jd, _, jdf = seq2seq_programs(pt, w)
    tt, _, tf, td, _, tdf = seq2seq_programs(ptt, w)
    assert [o.type for o in jt.global_block().ops] == \
        [o.type for o in tt.global_block().ops]
    assert [o.type for o in jd.global_block().ops] == \
        [o.type for o in td.global_block().ops]
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(js)
    persist = sorted(v.name for v in jt.list_vars() if v.persistable)
    arrays = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tscope, texe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    ptt.set_params_from_numpy(arrays, tt, tscope, ptt.CPUPlace())
    feed = seq2seq_batch(w)
    runs = []
    for _ in range(STEPS):
        with pt.scope_guard(jscope):
            j = jexe.run(jt, feed=feed, fetch_list=jf)
        t = texe.run(tt, feed=feed, fetch_list=tf, scope=tscope)
        runs.append((j, t))
    src = {k: feed[k] for k in ("src", "src_len")}
    with pt.scope_guard(jscope):
        jdec = jexe.run(jd, feed=src, fetch_list=jdf)
    tdec = texe.run(td, feed=src, fetch_list=tdf, scope=tscope)
    return runs, (jscope, tscope, persist), (jdec, tdec), (td, tdf, tscope)


@pytest.fixture(scope="module")
def trained():
    return _train_and_decode(SMALL)


def test_seq2seq_trains_like_the_jax_package(trained):
    runs, (jscope, tscope, persist), _, _ = trained
    losses = [(float(np.asarray(j[0]).reshape(())), float(t[0].reshape(())))
              for j, t in runs]
    np.testing.assert_allclose([t for _, t in losses], [j for j, _ in losses],
                               rtol=1e-5)
    assert losses[-1][1] < losses[0][1]
    for j, t in runs:
        np.testing.assert_allclose(t[1], np.asarray(j[1]), **TRAIN_TOL)
    for n in persist:
        want = np.asarray(jscope.find_var(n))
        got = to_numpy(tscope.find_var(n))
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, err_msg=n, **TRAIN_TOL)


def test_seq2seq_beam_decode_like_the_jax_package(trained):
    _, _, (jdec, tdec), _ = trained
    w = SMALL
    assert tdec[0].shape == (w["batch"], w["beam"], w["max_decode"])
    np.testing.assert_array_equal(tdec[0], np.asarray(jdec[0]))
    np.testing.assert_allclose(tdec[1], np.asarray(jdec[1]), **DECODE_TOL)
    assert (np.diff(tdec[1], axis=1) <= 0).all()       # best beam first


def test_seq2seq_served_through_the_predictor(trained, tmp_path):
    """The decode program saved with save_inference_model and served by
    create_predictor (batch 3 and 4 through the buckets) answers what its
    Executor answers."""
    from paddle_tpu_torch.inference import Config, create_predictor
    _, _, _, (td, tdf, tscope) = trained
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(str(tmp_path), ["src", "src_len"], tdf,
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=td)
    config = Config(str(tmp_path))
    config.place = ptt.CPUPlace()
    pred = create_predictor(config)
    feed = seq2seq_batch(SMALL, seed=3)
    for n in (3, 4):
        src = {k: feed[k][:n] for k in ("src", "src_len")}
        want = ptt.Executor(ptt.CPUPlace()).run(
            td, feed=src, fetch_list=tdf, scope=tscope)
        got = pred.run(src)
        assert got[0].shape == (n, SMALL["beam"], SMALL["max_decode"])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], **DECODE_TOL)
