"""UCI Housing regression dataset (ref python/paddle/dataset/uci_housing.py).

Contract: ``train()``/``test()`` yield ``(features, price)`` with
features float32[13] (normalized) and price float32[1].  The synthetic
payload is drawn from a fixed linear ground-truth with noise, so linear
regression converges exactly as the book chapter expects.
``fluid_model()`` (ref :125, which downloads a pre-trained fluid model)
here *trains* a tiny regressor with this framework and saves it via
``save_inference_model`` — same artifact contract, produced locally.
"""
import os

import numpy as np

from . import synthetic
from .common import DATA_HOME, must_mkdirs

__all__ = ['train', 'test']

feature_names = [
    'CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS', 'RAD', 'TAX',
    'PTRATIO', 'B', 'LSTAT'
]

FEATURE_NUM = 13
TRAIN_SIZE = 404
TEST_SIZE = 102

_W = None
_B = 22.5


def _truth():
    global _W
    if _W is None:
        _W = synthetic.rng_for("uci", "w").uniform(
            -3, 3, FEATURE_NUM).astype(np.float32)
    return _W


def _sample(split, i):
    rng = synthetic.rng_for("uci", split, i)
    x = rng.normal(0, 1, FEATURE_NUM).astype(np.float32)
    y = np.array([x.dot(_truth()) + _B + rng.normal(0, 1.0)], np.float32)
    return x, y


def feature_range(maximums, minimums):  # parity no-op (ref :47 plots)
    pass


def train():
    """404 normalized (x[13], y[1]) samples (ref uci_housing.py:85)."""

    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample("train", i)

    return reader


def test():
    """102 held-out samples (ref uci_housing.py:105)."""

    def reader():
        for i in range(TEST_SIZE):
            yield _sample("test", i)

    return reader


def fluid_model(place=None):
    """Path to a saved inference model for this dataset (ref :125).  The
    reference downloads one; this fits a linear regressor on the synthetic
    corpus with paddle_tpu_torch itself (on ``place``: ``CUDAPlace(0)``
    unless the caller passes another) and caches the saved model."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import io, layers, optimizer
    from paddle_tpu_torch.framework.scope import Scope, scope_guard

    dirname = os.path.join(DATA_HOME, "fit_a_line.inference.model")
    if os.path.exists(os.path.join(dirname, "__model__.json")):
        return dirname
    must_mkdirs(dirname)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = layers.data("x", shape=[FEATURE_NUM], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        pred = layers.fc(x, size=1, name="fc_pred")
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
        optimizer.SGD(0.01).minimize(loss)
    scope = Scope()
    with scope_guard(scope):
        exe = ptt.Executor(place)
        exe.run(startup)
        xs, ys = zip(*list(train()()))
        feed = {"x": np.stack(xs), "y": np.stack(ys)}
        for _ in range(200):
            exe.run(main, feed=feed, fetch_list=[loss])
        io.save_inference_model(dirname, ["x"], [pred], exe,
                                main_program=main)
    return dirname


def predict_reader():
    """First 10 test samples, features only (ref uci_housing.py:136)."""

    def reader():
        for i in range(10):
            yield (_sample("test", i)[0],)

    return reader


def fetch():
    next(train()())
