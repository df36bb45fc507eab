"""The Paddle Book's eight chapters, the port against the JAX package:
each chapter built by chip_smoke.py's ``_book_chapter`` (the builder the
card trains at the Book's widths; the JAX package has no model module
for the Book, so the chapters come from the file, given either package)
at tests/test_book.py's small widths (image_classification, which that
file lacks, at resnet_cifar10 depth 8 on 8 x 3 x 32 x 32), fed the
port's corpora (equal to the JAX package's sample for sample,
test_torch_dataset_corpora.py), started from the JAX startup's
persistables copied into the port, three runs through each Executor on
the CPU: losses within rtol 1e-4, every final parameter and persistable
within atol 1e-5 (rtol 1e-5; resnet_cifar10's optimizer moments and
moving statistics within KINKED_STATE_TOL, its parameters within atol
1e-5, integers exactly). The Adam chapters run at 1e-4 here. A
bias added straight before a batch norm (resnet_cifar10's second
convolution of a block) has a zero gradient up to rounding, which Adam
normalises to a step of up to lr either way on either side: such a
bias is held within 2 lr a step of the JAX package's, and the test
asserts the image chapter has them. A saved fit_a_line model loads and
serves in the port, and a model the JAX package saved serves in the
port with the JAX package's answers.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.scope import to_numpy


def _load_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_smoke = _load_smoke()
STEPS = 3
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
# resnet_cifar10's optimizer state and moving statistics: its gradients
# sum over relus whose kink decisions differ on last-bit differences of
# a normalised pre-activation, and Adam's moments keep each step's
# gradient (0.1 of it in the first): their elements agree to ~1e-3 of
# the tensor's scale, its parameters within PARAM_TOL
KINKED_STATE_TOL = dict(rtol=1e-2, atol=1e-4)

SMALL = {
    "fit_a_line": dict(batch=16, lr=0.001, cycle=True),
    "recognize_digits": dict(batch=8, filters=(4, 8), lr=1e-4, cycle=True),
    "image_classification": dict(batch=8, depth=8, lr=1e-4, cycle=True),
    "word2vec": dict(batch=16, n=5, emb=16, hidden=64, min_freq=2,
                     lr=0.001, cycle=True),
    "understand_sentiment": dict(batch=16, seq=60, emb=16, filters=16,
                                 lr=0.002, cycle=True),
    "recommender_system": dict(batch=16, emb=16, small=8, hidden=32,
                               cats=3, title=4, lr=0.2, cycle=False),
    "label_semantic_roles": dict(batch=4, seq=12, word=16, mark=8,
                                 hidden=32, depth=2, crf_lr=1e-3, lr=0.01,
                                 decay_steps=100000, decay_rate=0.5,
                                 cycle=False),
    "machine_translation": dict(batch=4, seq=16, dict=80, word=16,
                                hidden=24, lr=1e-4, l2=0.1, cycle=False),
}


def test_chapters_match_the_book_table():
    """The small widths name the same chapters as the card's BOOK."""
    assert list(SMALL) == list(_smoke.BOOK)


def _widths(name):
    return _smoke._book_widths(ptt.dataset, name, SMALL[name])


def _feeds(name, w):
    batches = _smoke._book_batches(np, ptt.dataset, name, w,
                                   2 if w["cycle"] else 1)
    return [batches[i % len(batches)] for i in range(STEPS)]


@pytest.mark.parametrize("name", list(SMALL))
def test_chapter_trains_like_the_jax_package(name):
    w = _widths(name)
    jmain, jstart, jfetch, _ = _smoke._book_chapter(pt, name, w)
    tmain, tstart, tfetch, _ = _smoke._book_chapter(ptt, name, w)
    assert [(o.type, sorted(o.inputs), sorted(o.outputs))
            for o in jmain.global_block().ops] == \
        [(o.type, sorted(o.inputs), sorted(o.outputs))
         for o in tmain.global_block().ops]
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    persist = [v.name for v in jmain.list_vars() if v.persistable]
    tscope, texe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    ptt.set_params_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in persist}, tmain, tscope,
                              ptt.CPUPlace())
    jl, tl = [], []
    for feed in _feeds(name, w):
        with pt.scope_guard(jscope):
            jl.append(np.asarray(jexe.run(jmain, feed=feed,
                                          fetch_list=jfetch)[0]))
        with ptt.scope_guard(tscope):
            tl.append(texe.run(tmain, feed=feed, fetch_list=tfetch)[0])
    np.testing.assert_allclose(np.array(tl, np.float64).reshape(-1),
                               np.array(jl, np.float64).reshape(-1),
                               rtol=LOSS_RTOL)
    flat = _smoke._bn_fed_biases(tmain)
    params = {p.name for p in tmain.all_parameters()}
    for n in persist:
        want = np.asarray(jscope.find_var(n))
        got = to_numpy(tscope.find_var(n))
        if n in flat:
            # zero gradient up to rounding: Adam moves each element by at
            # most lr a step, in either direction on either side
            bound = 2 * w["lr"] * STEPS * (1 + 1e-3)
            assert np.abs(got - want).max() <= bound, n
            flat.remove(n)
        elif want.dtype.kind in "iu":
            np.testing.assert_array_equal(got.reshape(want.shape), want,
                                          err_msg=n)
        elif n in params or name != "image_classification":
            np.testing.assert_allclose(got, want, err_msg=n, **PARAM_TOL)
        else:
            np.testing.assert_allclose(got, want, err_msg=n,
                                       **KINKED_STATE_TOL)
    assert not flat and (name != "image_classification" or
                         _smoke._bn_fed_biases(tmain))


def test_fit_a_line_saved_and_served(tmp_path):
    """Train fit_a_line in the port, save it, load it back with
    io.load_inference_model and serve it through the Predictor: both
    answers equal the trained program's prediction."""
    from paddle_tpu_torch.inference import Config, create_predictor
    w = _widths("fit_a_line")
    main, start, fetch, (feeds, targets) = _smoke._book_chapter(
        ptt, "fit_a_line", w)
    batch = _feeds("fit_a_line", w)[0]
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(start)
        for _ in range(5):
            exe.run(main, feed=batch, fetch_list=fetch)
        want = exe.run(main.clone(for_test=True), feed=batch,
                       fetch_list=targets)[0]
        ptt.io.save_inference_model(str(tmp_path), feeds, targets, exe,
                                    main_program=main)
    with ptt.scope_guard(ptt.Scope()):
        prog, fnames, fetches = ptt.io.load_inference_model(
            str(tmp_path), ptt.Executor(ptt.CPUPlace()))
        loaded = ptt.Executor(ptt.CPUPlace()).run(
            prog, feed={"x": batch["x"]}, fetch_list=fetches)[0]
    cfg = Config(str(tmp_path))
    cfg.place = ptt.CPUPlace()
    served = create_predictor(cfg).run({"x": batch["x"][:5]})[0]
    assert fnames == ["x"] and loaded.shape == (w["batch"], 1)
    np.testing.assert_allclose(loaded, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(served, want[:5], rtol=1e-6, atol=1e-6)


def test_jax_saved_fit_a_line_serves_in_the_port(tmp_path):
    """A fit_a_line model the JAX package trained and saved loads in the
    port, whose answers equal the JAX package's."""
    w = _widths("fit_a_line")
    main, start, fetch, (feeds, targets) = _smoke._book_chapter(
        pt, "fit_a_line", w)
    batch = _feeds("fit_a_line", w)[0]
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(start)
        exe.run(main, feed=batch, fetch_list=fetch)
        pt.io.save_inference_model(str(tmp_path), feeds, targets, exe,
                                   main_program=main)
        jprog, jf, jt = pt.io.load_inference_model(str(tmp_path), exe)
        want = np.asarray(exe.run(jprog, feed={"x": batch["x"]},
                                  fetch_list=jt)[0])
    texe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        prog, fnames, fetches = ptt.io.load_inference_model(str(tmp_path),
                                                            texe)
        got = texe.run(prog, feed={"x": batch["x"]}, fetch_list=fetches)[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
