"""MNIST dataset (ref python/paddle/dataset/mnist.py).

Same reader contract as the reference: ``train()``/``test()`` yield
``(image, label)`` with image a float32[784] in [-1, 1] and label an
int in [0, 10).  Payload is synthetic (see common.py): each class has a
fixed blurred prototype digit-blob; samples are the prototype plus
per-sample noise, so linear/MLP classifiers separate the classes and
book-style convergence tests behave like on the real corpus.
"""
import numpy as np

from . import synthetic

__all__ = ['train', 'test']

TRAIN_SIZE = 60000
TEST_SIZE = 10000


def _prototypes():
    rng = synthetic.rng_for("mnist", "protos")
    protos = []
    for c in range(10):
        img = np.zeros((28, 28), np.float32)
        # a handful of class-specific gaussian strokes
        for _ in range(6):
            cy, cx = rng.randint(4, 24, size=2)
            yy, xx = np.mgrid[0:28, 0:28]
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) /
                          (2.0 * rng.uniform(2.0, 9.0)))
        protos.append(img / img.max())
    return np.stack(protos)


_PROTOS = None


def reader_creator(split, size):
    def reader():
        global _PROTOS
        if _PROTOS is None:
            _PROTOS = _prototypes()
        for i in range(size):
            rng = synthetic.rng_for("mnist", split, i)
            label = int(rng.randint(10))
            img = _PROTOS[label] + rng.normal(0, 0.25, (28, 28))
            img = np.clip(img, 0.0, 1.0).astype(np.float32)
            yield img.reshape(784) * 2.0 - 1.0, label

    return reader


def train():
    """MNIST training-set creator: 60k (float32[784] in [-1,1], int label)
    samples (ref mnist.py:91)."""
    return reader_creator("train", TRAIN_SIZE)


def test():
    """MNIST test-set creator: 10k samples (ref mnist.py:108)."""
    return reader_creator("test", TEST_SIZE)


def fetch():
    next(train()())
