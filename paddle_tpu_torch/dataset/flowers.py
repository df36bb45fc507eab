"""102-category flowers dataset (counterpart of
paddle_tpu/dataset/flowers.py; ref python/paddle/dataset/flowers.py).

Contract: creators yield ``(image, label)`` with image float32[3*H*W]
(CHW flattened, [0,1]) after the default mapper, label int in [0, 102).
``mapper`` / ``use_xmap`` / ``cycle`` arguments are honored the same
way.  Synthetic payload: class-colored radial "petal" patterns + noise.
"""
import functools

import numpy as np

from . import synthetic
from ..reader.decorator import map_readers, xmap_readers

__all__ = ['train', 'test', 'valid']

TRAIN_SIZE = 400
TEST_SIZE = 100
VAL_SIZE = 100
N_CLASSES = 102
_H = _W = 64


def default_mapper(is_train, sample):
    """img, label -> transformed img (flattened CHW), label
    (ref flowers.py:63).  Train mode adds a random crop-style jitter."""
    img, label = sample
    if is_train:
        rng = np.random.RandomState(int(img.sum() * 1e3) & 0x7fffffff)
        img = np.roll(img, int(rng.randint(-4, 5)), axis=-1)
    return img.reshape(-1).astype(np.float32), label


train_mapper = functools.partial(default_mapper, True)
test_mapper = functools.partial(default_mapper, False)


def _sample(split, i):
    rng = synthetic.rng_for("flowers", split, i)
    label = int(rng.randint(N_CLASSES))
    crng = synthetic.rng_for("flowers", "proto", label)
    color = crng.uniform(0.3, 1.0, (3, 1, 1)).astype(np.float32)
    petals = int(crng.randint(3, 9))
    yy, xx = np.mgrid[0:_H, 0:_W].astype(np.float32)
    cy, cx = _H / 2.0, _W / 2.0
    theta = np.arctan2(yy - cy, xx - cx)
    r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / (_H / 2.0)
    petal = (np.cos(petals * theta) * 0.5 + 0.5) * np.clip(1 - r, 0, 1)
    img = color * petal[None] + rng.normal(0, 0.08, (3, _H, _W))
    return np.clip(img, 0, 1).astype(np.float32), label


def reader_creator(split, size, mapper, buffered_size=1024,
                   use_xmap=True, cycle=False):
    def reader():
        while True:
            for i in range(size):
                yield _sample(split, i)
            if not cycle:
                break

    if use_xmap:
        return xmap_readers(mapper, reader, min(4, buffered_size),
                            buffered_size)
    return map_readers(mapper, reader)


def train(mapper=train_mapper, buffered_size=1024, use_xmap=True,
          cycle=False):
    """Train creator (ref flowers.py:146)."""
    return reader_creator("train", TRAIN_SIZE, mapper, buffered_size,
                          use_xmap, cycle)


def test(mapper=test_mapper, buffered_size=1024, use_xmap=True,
         cycle=False):
    """Test creator (ref flowers.py:175)."""
    return reader_creator("test", TEST_SIZE, mapper, buffered_size,
                          use_xmap, cycle)


def valid(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    """Validation creator (ref flowers.py:204)."""
    return reader_creator("val", VAL_SIZE, mapper, buffered_size, use_xmap)


def fetch():
    next(train(use_xmap=False)())
