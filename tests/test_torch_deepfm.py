"""DeepFM's ops and model: the port against the JAX package.

``sigmoid_cross_entropy_with_logits``, ``concat``, ``ones_like`` and
``auc`` through the public ``layers`` API of both packages, on the same
numpy feeds (``run_pair`` of tests/test_torch_resnet.py); then three Adam
steps of ``deepfm_train_program(feature_dim=5000, embedding_size=8)``
from the JAX startup's weights.

Tolerances: the loss and concat are one f32 expression: rtol 1e-5,
atol 1e-6 (concat and ones_like move data: exact). AUC: the histograms
are integers and must be equal (the JAX package holds them as int32
without 64-bit mode, the port as int64); the JAX package integrates in
f32 and the port in float64, and at these sizes every partial sum is an
integer below 2^24 and the products exact in f32, so the two AUCs differ
only by the final division's rounding in f32: rtol 1e-6. The three Adam
steps: losses rtol 1e-5, parameters and moments rtol 1e-4, atol 1e-6
(Adam divides by sqrt(m2) + eps, which magnifies a last-bit difference
of a small second moment), histograms equal.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import deepfm as tdeepfm
from test_torch_bert_training import _normalized
from test_torch_ops import _cots, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair


@pytest.mark.parametrize("ignore_index,normalize", [(-100, False),
                                                    (0, False), (0, True),
                                                    (-100, True)])
def test_sigmoid_cross_entropy_with_logits(ignore_index, normalize):
    """Loss and its gradient to the logits; the labels mix 0, 1 and
    fractions, and ``ignore_index = 0`` drops the zeros."""
    shape = (6, 3)
    label = np.random.RandomState(1).choice(
        [0.0, 1.0, 0.25], size=shape).astype(np.float32)

    def build(p):
        x = _grad_data(p, "x", shape)
        lbl = p.layers.data("label", list(shape), append_batch_size=False)
        return _with_grads(p, [p.layers.sigmoid_cross_entropy_with_logits(
            x, lbl, ignore_index=ignore_index, normalize=normalize)], [x])
    run_pair(build, [dict({"x": _x(shape) * 4, "label": label},
                          **_cots(18))], tol=dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_concat(axis):
    """The joined tensor and each input's gradient, split back by size."""
    shapes = {0: [(2, 3), (4, 3), (1, 3)], 1: [(2, 3), (2, 1), (2, 5)],
              -1: [(2, 3), (2, 2), (2, 1)]}[axis]

    def build(p):
        xs = [_grad_data(p, "x%d" % i, s) for i, s in enumerate(shapes)]
        return _with_grads(p, [p.layers.concat(xs, axis=axis)], xs)
    total = sum(int(np.prod(s)) for s in shapes)
    feed = dict({"x%d" % i: _x(s, i) for i, s in enumerate(shapes)},
                **_cots(total))
    run_pair(build, [feed], exact=True)


def test_ones_like():
    def build(p):
        return [p.layers.ones_like(p.layers.data("x", [2, 3],
                                                 append_batch_size=False))]
    out, _, _ = run_pair(build, [{"x": _x((2, 3))}], exact=True)
    np.testing.assert_array_equal(out[0], np.ones((2, 3), np.float32))


@pytest.mark.parametrize("columns,num_thresholds", [(2, 4095), (1, 200)])
def test_auc_over_two_calls(columns, num_thresholds):
    """Two runs on one scope: the second accumulates into the histograms
    the first wrote back. AUC, StatPosOut and StatNegOut each run, and
    the histograms' dtypes (int64 in the port)."""
    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(2):
        p = rng.rand(64, 1).astype(np.float32)
        p[:4, 0] = [0.0, 1.0, 0.5, 0.99999]          # the end bins
        pred = np.concatenate([1 - p, p], 1) if columns == 2 else p
        label = (rng.rand(64, 1) < p).astype(np.int64)
        feeds.append({"pred": pred, "label": label})
    stats = []

    def build(p):
        pred = p.layers.data("pred", [64, columns], append_batch_size=False)
        label = p.layers.data("label", [64, 1], dtype="int64",
                              append_batch_size=False)
        auc, st = p.layers.auc(pred, label, num_thresholds=num_thresholds)
        stats[:] = st
        return [auc] + st
    out, _, (jscope, tscope) = run_pair(build, feeds,
                                        tol=dict(rtol=1e-6, atol=0))
    assert [s.dtype for s in stats] == ["int64", "int64"]
    assert tscope.find_var(stats[0].name).dtype == ptt.framework.dtypes \
        .to_torch_dtype("int64")
    assert out[1].sum() + out[2].sum() == 128
    # the integral against a float64 numpy oracle of the histograms
    tp = np.cumsum(out[1][::-1])[::-1].astype(np.float64)
    fp = np.cumsum(out[2][::-1])[::-1].astype(np.float64)
    tpn, fpn = np.append(tp[1:], 0.0), np.append(fp[1:], 0.0)
    want = ((fp - fpn) * (tp + tpn) / 2).sum() / (tp[0] * fp[0])
    np.testing.assert_allclose(out[0], [want], rtol=1e-7)


SMALL = dict(feature_dim=5000, embedding_size=8)
BATCH, STEPS = 64, 3


def _train_program(pkg, mod, **kw):
    with pkg.unique_name.guard():
        return mod.deepfm_train_program(
            optimizer_fn=lambda loss: pkg.optimizer.Adam(1e-3).minimize(
                loss), **dict(SMALL, **kw))


def test_synthetic_batch_matches_jax():
    want = jdeepfm.synthetic_batch(BATCH, feature_dim=5000, seed=3)
    got = tdeepfm.synthetic_batch(BATCH, feature_dim=5000, seed=3)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("size", ["small", "bench"])
def test_deepfm_programs_are_the_jax_packages(size):
    """deepfm_train_program builds the same main and startup programs in
    both packages (op types and order, attrs, vars, persistables and
    their shapes), at the small size and at bench.py's (feature_dim
    1,000,000, embedding 10, Adam(1e-3)). Nothing runs."""
    kw = {} if size == "small" else dict(feature_dim=1000000,
                                         embedding_size=10)
    (jmain, jstart, jfeeds, _), (tmain, tstart, tfeeds, _) = [
        _train_program(pkg, mod, **kw)
        for pkg, mod in ((pt, jdeepfm), (ptt, tdeepfm))]
    assert jfeeds == tfeeds
    assert _normalized(jmain) == _normalized(tmain)
    assert _normalized(jstart) == _normalized(tstart)
    tables = {v.name: tuple(v.shape) for v in tmain.all_parameters()
              if v.name.startswith("feat_")}
    dim = kw.get("feature_dim", 5000)
    assert tables == {"feat_weights_1st": (dim, 1),
                      "feat_embeddings": (dim, kw.get("embedding_size", 8))}
    assert [op.type for op in tmain.global_block().ops].count("adam") == 11


def test_sharded_embeddings_wait_for_the_distributed_slice():
    with pytest.raises(ptt.NotPortedError, match="torch.distributed"):
        tdeepfm.deepfm_train_program(shard_embeddings=True, **SMALL)


def test_small_deepfm_trains_like_jax():
    """Three Adam(1e-3) steps of feature_dim 5000, embedding 8, batch 64
    from the JAX startup's weights, a new synthetic batch each step:
    losses and AUCs every step, then every persistable (parameters, Adam
    moments and beta powers, AUC histograms) against the JAX scope."""
    jmain, jstart, _, jfetch = _train_program(pt, jdeepfm)
    tmain, tstart, _, tfetch = _train_program(ptt, tdeepfm)
    names = ["loss", "auc", "predict"]
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    ptt.set_params_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persist}, tmain, tscope,
        ptt.CPUPlace())
    losses = []
    for step in range(STEPS):
        feed = tdeepfm.synthetic_batch(BATCH, feature_dim=5000, seed=step)
        with pt.scope_guard(jscope):
            jout = jexe.run(jmain, feed=feed,
                            fetch_list=[jfetch[n] for n in names])
        with ptt.scope_guard(tscope):
            tout = texe.run(tmain, feed=feed,
                            fetch_list=[tfetch[n] for n in names])
        np.testing.assert_allclose(tout[0], jout[0], rtol=1e-5)
        np.testing.assert_allclose(tout[1], jout[1], rtol=1e-6)
        np.testing.assert_allclose(tout[2], jout[2], rtol=1e-5, atol=1e-6)
        losses.append(float(tout[0].reshape(())))
    assert np.isfinite(losses).all()
    counted = 0
    for n in persist:
        got, want = to_numpy(tscope.find_var(n)), np.asarray(
            jscope.find_var(n))
        if "_stat_" in n:
            assert got.dtype == np.int64
            counted += int(got.sum())
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=n)
    assert counted == STEPS * BATCH


def test_small_deepfm_loss_falls_on_one_batch():
    """Ten Adam steps on one batch on the port alone: the loss falls."""
    main, startup, _, fetch = _train_program(ptt, tdeepfm)
    feed = tdeepfm.synthetic_batch(BATCH, feature_dim=5000, seed=0)
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[fetch["loss"]],
                            scope=scope)[0].reshape(())) for _ in range(10)]
    assert losses[-1] < 0.9 * losses[0]
