"""The host-side metrics (paddle_tpu_torch/metrics.py, evaluator.py,
average.py) and ``contrib.layers.ctr_metric_bundle`` against the JAX
package's.

The metrics, evaluators and ``WeightedAverage`` keep their state in numpy
(float64, int64) in both packages and are fed the same numpy values, so
every result must be equal exactly, errors included.
``ctr_metric_bundle`` builds the same ops in both packages; its six f32
aggregates over the same predictions agree within rtol 1e-6 (sums of 64
f32 terms in another order) and with numpy's float64 sums.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import average as javerage
from paddle_tpu import evaluator as jevaluator
from paddle_tpu import metrics as jmetrics
from paddle_tpu.contrib.layers import metric_op as jmetric_op
from paddle_tpu_torch import average as taverage
from paddle_tpu_torch import evaluator as tevaluator
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch.contrib.layers import metric_op as tmetric_op


def _batches(seed=0, n=5, rows=32):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield rng.rand(rows, 1), rng.randint(0, 2, (rows, 1))


def _eval_both(make, feed):
    out = []
    for mod in (jmetrics, tmetrics):
        m = make(mod)
        for args in feed():
            m.update(*args)
        out.append(m.eval())
        m.reset()
    return out


@pytest.mark.parametrize("name", ["Precision", "Recall", "F1"])
def test_binary_metrics_equal_jax(name):
    a, b = _eval_both(lambda mod: getattr(mod, name)(), _batches)
    assert b == a
    assert 0.0 < b < 1.0


def test_accuracy_equals_jax_and_raises_before_updates():
    def feed():
        for v, w in ((0.5, 10), (0.75, 30), (0.25, 5)):
            yield np.array([v], np.float32), w
    a, b = _eval_both(lambda mod: mod.Accuracy(), feed)
    assert b == a == pytest.approx((5 + 22.5 + 1.25) / 45)
    for mod in (jmetrics, tmetrics):
        with pytest.raises(ValueError):
            mod.Accuracy().eval()


def test_composite_metric_equals_jax():
    def make(mod):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        return c
    a, b = _eval_both(make, _batches)
    assert b == a and len(b) == 2


@pytest.mark.parametrize("two_col", [False, True])
def test_auc_equals_jax(two_col):
    def feed():
        for p, l in _batches(seed=3, rows=200):
            yield (np.concatenate([1 - p, p], 1) if two_col else p), l
    a, b = _eval_both(lambda mod: mod.Auc(num_thresholds=255), feed)
    assert b == a and 0.3 < b < 0.7


def test_auc_of_a_separable_batch_is_one():
    m = tmetrics.Auc()
    m.update(np.array([0.1, 0.2, 0.8, 0.9]), np.array([0, 0, 1, 1]))
    assert m.eval() == 1.0
    assert tmetrics.Auc().eval() == 0.0


def test_metric_aliases_name_the_evaluators():
    assert tmetrics.ChunkEvaluator is tevaluator.ChunkEvaluator
    assert tmetrics.EditDistance is tevaluator.EditDistance
    assert tmetrics.DetectionMAP is tevaluator.DetectionMAP


def test_chunk_evaluator_equals_jax():
    counts = [(10, 12, 8), (5, 4, 3), (0, 2, 0)]
    out = []
    for mod in (jevaluator, tevaluator):
        e = mod.ChunkEvaluator()
        for c in counts:
            e.update(*(np.array([v], np.int64) for v in c))
        out.append(e.eval())
        e.reset()
        out.append(e.eval())
    assert out[2:] == out[:2]
    assert out[0] == pytest.approx((11 / 15, 11 / 18, 2 * (11 / 15) *
                                    (11 / 18) / (11 / 15 + 11 / 18)))
    assert out[1] == (0.0, 0.0, 0.0)


def test_edit_distance_equals_jax():
    out = []
    for mod in (jevaluator, tevaluator):
        e = mod.EditDistance()
        e.update(np.array([0.0, 2.0, 1.0]), np.array([3]))
        e.update(np.array([4.0, 0.0]))
        out.append(e.eval())
    assert out[1] == out[0] == (7.0 / 5, 3.0 / 5)


def _detections(seed):
    rng = np.random.RandomState(seed)
    for _ in range(6):
        n_gt = rng.randint(1, 4)
        xy = rng.rand(n_gt, 2) * 50
        gt = np.concatenate([xy, xy + 10 + rng.rand(n_gt, 2) * 20], 1)
        labels = rng.randint(1, 4, n_gt)
        preds = []
        for box, lab in zip(gt, labels):
            preds.append([lab, rng.rand(), *(box + rng.randn(4))])
        preds.append([rng.randint(1, 4), rng.rand(),
                      *np.concatenate([xy[0] + 30, xy[0] + 45])])
        difficult = rng.rand(n_gt) < 0.2
        yield np.array(preds), gt, labels, difficult


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [True, False])
def test_detection_map_equals_jax(ap_version, difficult):
    out = []
    for mod in (jevaluator, tevaluator):
        e = mod.DetectionMAP(class_num=4, ap_version=ap_version,
                             evaluate_difficult=difficult)
        for preds, gt, labels, diff in _detections(7):
            e.update(preds, gt, labels, diff)
        out.append(e.eval())
    assert out[1] == out[0]
    assert 0.0 < out[1] <= 1.0


def test_detection_map_refuses_an_unknown_ap_version():
    for mod in (jevaluator, tevaluator):
        with pytest.raises(ValueError):
            mod.DetectionMAP(ap_version="voc")


def test_weighted_average_equals_jax():
    out = []
    for mod in (javerage, taverage):
        w = mod.WeightedAverage()
        with pytest.raises(ValueError):
            w.eval()
        w.add(3.0, 2)
        w.add(np.array([1.0, 2.0]), 4)
        out.append(w.eval())
        with pytest.raises(ValueError):
            w.add("x", 1)
    assert out[1] == out[0] == pytest.approx((6 + 6) / 6)


def _ctr_program(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        p = pkg.layers.data("p", [1], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        outs = mod.ctr_metric_bundle(p, y)
    return main, list(outs)


def test_ctr_metric_bundle_equals_jax_and_numpy():
    rng = np.random.RandomState(0)
    feed = {"p": rng.rand(64, 1).astype(np.float32),
            "y": rng.randint(0, 2, (64, 1)).astype(np.float32)}
    jmain, jouts = _ctr_program(pt, jmetric_op)
    tmain, touts = _ctr_program(ptt, tmetric_op)
    assert [(op.type, op.inputs, op.outputs) for op in
            tmain.global_block().ops] == \
        [(op.type, op.inputs, op.outputs) for op in jmain.global_block().ops]
    with pt.scope_guard(pt.Scope()):
        want = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                              fetch_list=jouts)
    with ptt.scope_guard(ptt.Scope()):
        got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                               fetch_list=touts)
    p = feed["p"].astype(np.float64).reshape(-1)
    y = feed["y"].astype(np.float64).reshape(-1)
    exact = [((p - y) ** 2).sum(), np.abs(p - y).sum(), p.sum(),
             (p * p).sum(), y.sum(), 64.0]
    for g, w, e in zip(got, want, exact):
        g = float(np.asarray(g).reshape(-1)[0])
        assert g == pytest.approx(float(np.asarray(w).reshape(-1)[0]),
                                  rel=1e-6)
        assert g == pytest.approx(e, rel=1e-6)
