"""CIFAR-10/100 dataset (ref python/paddle/dataset/cifar.py).

Reference contract: creators yield ``(image, label)`` with image a
float32[3072] (CHW flattened, values in [0, 1]) and label int.  CIFAR-10
has 10 coarse classes, CIFAR-100 has 100.  Synthetic payload: per-class
color/texture prototypes plus noise (see common.py for the offline
rationale).
"""
import numpy as np

from . import synthetic

__all__ = ['train100', 'test100', 'train10', 'test10']

TRAIN_SIZE = 50000
TEST_SIZE = 10000


def _proto(tag, n_class, label):
    rng = synthetic.rng_for("cifar", tag, "proto", label)
    base = rng.uniform(0.2, 0.8, size=(3, 1, 1)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    tex = np.sin(2 * np.pi * (rng.uniform(1, 4) * yy +
                              rng.uniform(1, 4) * xx))[None] * 0.15
    return np.clip(base + tex, 0, 1)


def reader_creator(tag, n_class, split, size, cycle=False):
    protos = {}

    def reader():
        while True:
            for i in range(size):
                rng = synthetic.rng_for("cifar", tag, split, i)
                label = int(rng.randint(n_class))
                if label not in protos:
                    protos[label] = _proto(tag, n_class, label)
                img = protos[label] + rng.normal(0, 0.12, (3, 32, 32))
                img = np.clip(img, 0, 1).astype(np.float32)
                yield img.reshape(3072), label
            if not cycle:
                break

    return reader


def train100():
    """CIFAR-100 train creator (ref cifar.py:78)."""
    return reader_creator("cifar100", 100, "train", TRAIN_SIZE)


def test100():
    """CIFAR-100 test creator (ref cifar.py:93)."""
    return reader_creator("cifar100", 100, "test", TEST_SIZE)


def train10(cycle=False):
    """CIFAR-10 train creator (ref cifar.py:108)."""
    return reader_creator("cifar10", 10, "train", TRAIN_SIZE, cycle=cycle)


def test10(cycle=False):
    """CIFAR-10 test creator (ref cifar.py:126)."""
    return reader_creator("cifar10", 10, "test", TEST_SIZE, cycle=cycle)


def fetch():
    next(train10()())
