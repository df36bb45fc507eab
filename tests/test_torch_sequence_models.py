"""BiGRU-CRF sequence labeling (LAC) and CRNN-CTC text recognition: the
port against the JAX package, built and trained on the CPU at narrow
widths from the JAX startup's persistables.

Tolerances (f32 on both sides, the same programs op for op):
- LAC, three Adam(1e-3) steps: losses rtol 1e-5; Viterbi paths equal at
  every step; every persistable (parameters, Adam moments) rtol 1e-5,
  atol 1e-5.
- CRNN-CTC, three Adam(1e-4) steps through three convolutions with batch
  norm and a 24-step CTC recursion: losses rtol 1e-5, logits rtol 1e-5,
  atol 1e-5; every float persistable (parameters, moments, batch-norm
  statistics) rtol 1e-4, atol 3e-5. The first step's gradients agree to
  ~4e-6 of their largest; at 1e-3 a few elements part further by the
  third step (Adam steps an element whose gradient is at the noise level
  by ~lr either way, and the batch norm of 3 images carries a changed
  filter into every gradient), at 1e-4 none does.
- Served decode: the Predictor's paths equal Executor.run's exactly.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import ocr as jocr
from paddle_tpu.models import sequence_labeling as jsl
from paddle_tpu_torch.models import ocr as tocr
from paddle_tpu_torch.models import sequence_labeling as tsl

LAC = dict(vocab_size=50, num_labels=5, emb_dim=16, hidden=16,
           num_layers=2, seq_len=12)
OCR = dict(num_classes=10, image_shape=(1, 16, 24), hidden=16, max_label=6)
STEPS, LR, OCR_LR = 3, 1e-3, 1e-4


def _lac(p, mod, crf_lr=1.0, train=True):
    with p.unique_name.guard():
        return mod.bigru_crf_program(
            crf_lr=crf_lr, optimizer_fn=(lambda loss: p.optimizer.Adam(
                LR).minimize(loss)) if train else None, **LAC)


def _ocr(p, mod):
    with p.unique_name.guard():
        return mod.crnn_ctc_program(
            optimizer_fn=lambda loss: p.optimizer.Adam(OCR_LR).minimize(
                loss), **OCR)


def _args(slots):
    """The var names of an op's input or output slots."""
    return [n for names in slots.values() for n in names]


def _lac_batch(n, seed=0):
    feed = jsl.synthetic_tagging_batch(n, LAC["seq_len"], LAC["vocab_size"],
                                       LAC["num_labels"], seed=seed)
    feed["lens"][-1] = 1                  # a row of length 1
    return feed


def _started(j, t):
    """Run the JAX startup; copy its persistables into a port scope."""
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(j[1])
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(params, t[0], tscope, ptt.CPUPlace())
    return (jscope, jexe), (tscope, ptt.Executor(ptt.CPUPlace()))


def _train_both(j, t, feed, fetch):
    """STEPS runs of each package's program on one feed: (the JAX
    package's fetches, the port's, the two scopes)."""
    (jscope, jexe), (tscope, texe) = _started(j, t)
    jout, tout = [], []
    for _ in range(STEPS):
        with pt.scope_guard(jscope):
            jout.append([np.asarray(a) for a in jexe.run(
                j[0], feed=feed, fetch_list=[j[3][k] for k in fetch])])
        tout.append(texe.run(t[0], feed=feed,
                             fetch_list=[t[3][k] for k in fetch],
                             scope=tscope))
    return jout, tout, jscope, tscope


def test_synthetic_batches_match_jax():
    for seed in (0, 3):
        for j, t in ((jsl.synthetic_tagging_batch(4, 10, 30, 7, seed=seed),
                      tsl.synthetic_tagging_batch(4, 10, 30, 7, seed=seed)),
                     (jocr.synthetic_ocr_batch(3, (1, 8, 20), 9, 8,
                                               seed=seed),
                      tocr.synthetic_ocr_batch(3, (1, 8, 20), 9, 8,
                                               seed=seed))):
            assert sorted(j) == sorted(t)
            for k in j:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("model", ["lac", "ocr"])
def test_programs_match_jax(model):
    """Op types of both programs, parameter names, shapes and learning
    rates equal the JAX package's."""
    if model == "lac":
        j, t = _lac(pt, jsl), _lac(ptt, tsl)
    else:
        j, t = _ocr(pt, jocr), _ocr(ptt, tocr)
    for i in (0, 1):
        assert [o.type for o in j[i].global_block().ops] == \
            [o.type for o in t[i].global_block().ops]
    assert [(p.name, tuple(p.shape), p.optimize_attr)
            for p in j[0].all_parameters()] == \
        [(p.name, tuple(p.shape), p.optimize_attr)
         for p in t[0].all_parameters()]
    types = [o.type for o in t[0].global_block().ops]
    if model == "lac":
        assert (len(types), types.count("gru_seq"), types.count("adam"),
                types.count("grad_of")) == (114, 4, 16, 24)
    else:
        assert (len(types), types.count("gru_seq"), types.count("adam"),
                types.count("grad_of")) == (74, 2, 17, 24)


def test_crfw_learning_rate_is_carried_from_the_reference():
    """crf_decoding creates ``crfw`` again with a plain ParamAttr, so
    ``crf_lr`` never reaches the optimizer: its learning rate is 1.0 in
    both packages, the startup initialises it twice, and the program
    built with crf_lr=0.2 equals the one built with 1.0 op for op."""
    for p, mod in ((pt, jsl), (ptt, tsl)):
        main, startup, _, _ = _lac(p, mod, crf_lr=0.2)
        assert main.global_block().var("crfw").optimize_attr == \
            {"learning_rate": 1.0}
        assert sum(1 for o in startup.global_block().ops
                   if "crfw" in _args(o.outputs)) == 2
        plain = _lac(p, mod, crf_lr=1.0)[0]
        assert [(o.type, _args(o.inputs)) for o in
                main.global_block().ops] == \
            [(o.type, _args(o.inputs)) for o in plain.global_block().ops]


def test_bigru_crf_training_matches_jax():
    """Three Adam steps on one batch (a row of length 1 in it): losses,
    paths and every persistable."""
    j, t = _lac(pt, jsl), _lac(ptt, tsl)
    feed = _lac_batch(4)
    jout, tout, jscope, tscope = _train_both(j, t, feed, ("loss", "decode"))
    for (jl, jd), (tl, td) in zip(jout, tout):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert jd.dtype == np.int32 and td.dtype == np.int64
        np.testing.assert_array_equal(td, jd)
    assert tout[-1][0] < tout[0][0]
    for v in t[0].list_vars():
        if v.persistable:
            np.testing.assert_allclose(
                tscope.find_var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)), rtol=1e-5, atol=1e-5,
                err_msg=v.name)


def test_crnn_ctc_training_matches_jax():
    """Three Adam steps on one batch: losses, logits and every float
    persistable (parameters, moments, batch-norm statistics), and the
    greedy decode of the logits."""
    j, t = _ocr(pt, jocr), _ocr(ptt, tocr)
    feed = jocr.synthetic_ocr_batch(3, OCR["image_shape"],
                                    OCR["num_classes"], OCR["max_label"])
    jout, tout, jscope, tscope = _train_both(j, t, feed, ("loss", "logits"))
    for (jl, jg), (tl, tg) in zip(jout, tout):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    assert tout[-1][0] < tout[0][0]
    for v in t[0].list_vars():
        if v.persistable and v.dtype == "float32":
            np.testing.assert_allclose(
                tscope.find_var(v.name).numpy(),
                np.asarray(jscope.find_var(v.name)), rtol=1e-4, atol=3e-5,
                err_msg=v.name)
    blank = OCR["num_classes"]
    assert tocr.ctc_greedy_decode(tout[-1][1], blank) == \
        jocr.ctc_greedy_decode(tout[-1][1], blank)
    assert tocr.ctc_greedy_decode(tout[0][1], blank) == \
        jocr.ctc_greedy_decode(jout[0][1], blank)


def test_lac_served_through_the_predictor(tmp_path):
    """The decode saved with save_inference_model(["words", "lens"],
    [decode]) reads neither ``targets`` nor the CRF loss, and runs no
    last-state chain; served at batch 3 (padded to bucket 4 with a row of
    length 0) its paths equal Executor.run's on the training program, and
    the padded batch's paths, the empty row's included, equal the JAX
    package's."""
    from paddle_tpu_torch.inference import Config, create_predictor
    j, t = _lac(pt, jsl, train=False), _lac(ptt, tsl, train=False)
    (jscope, jexe), (tscope, texe) = _started(j, t)
    feed = _lac_batch(3, seed=1)
    want, = texe.run(t[0], feed=feed, fetch_list=[t[3]["decode"]],
                     scope=tscope)
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(str(tmp_path), ["words", "lens"],
                                 [t[3]["decode"]], texe, main_program=t[0])
    config = Config(str(tmp_path))
    config.place = ptt.CPUPlace()
    pred = create_predictor(config)
    types = {o.type for o in pred._program.global_block().ops}
    reads = {n for o in pred._program.global_block().ops
             for n in _args(o.inputs)}
    assert "targets" not in reads and "linear_chain_crf" not in types
    assert not types & {"stack", "one_hot", "matmul"}
    got, = pred.run({"words": feed["words"], "lens": feed["lens"]})
    assert got.shape == (3, LAC["seq_len"], 1) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)

    padded = {k: np.concatenate([v, np.zeros_like(v[:1])])
              for k, v in feed.items()}
    with pt.scope_guard(jscope):
        jpath, = jexe.run(j[0], feed=padded, fetch_list=[j[3]["decode"]])
    tpath, = texe.run(t[0], feed=padded, fetch_list=[t[3]["decode"]],
                      scope=tscope)
    np.testing.assert_array_equal(tpath, np.asarray(jpath))
    np.testing.assert_array_equal(tpath[:3], got)
    assert (tpath[3] == 0).all()
