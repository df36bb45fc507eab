"""PASCAL VOC2012 segmentation corpus (counterpart of
paddle_tpu/dataset/voc2012.py, ref python/paddle/dataset/voc2012.py):
creators yield ``(image, label)``, image uint8[3, H, W], label uint8[H,
W] with class ids 0..20 and 255 on the void boundary of each object.
Synthetic, equal to the JAX package's record for record: random
rectangles of random classes over a textured background.
"""
import numpy as np

from . import synthetic

__all__ = ['train', 'test', 'val']

TRAIN_SIZE = 200
TEST_SIZE = 50
VAL_SIZE = 50
_H = _W = 96
N_CLASSES = 21


def _sample(split, i):
    rng = synthetic.rng_for("voc", split, i)
    img = rng.randint(0, 255, (3, _H, _W)).astype(np.uint8)
    label = np.zeros((_H, _W), np.uint8)
    for _ in range(int(rng.randint(1, 4))):
        c = int(rng.randint(1, N_CLASSES))
        y0, x0 = rng.randint(0, _H - 16), rng.randint(0, _W - 16)
        h, w = rng.randint(8, _H - y0), rng.randint(8, _W - x0)
        y1, x1 = min(_H, y0 + h), min(_W, x0 + w)
        label[y0:y1, x0:x1] = c
        # void boundary ring, as in real VOC annotations
        label[y0, x0:x1] = 255
        label[y1 - 1, x0:x1] = 255
        label[y0:y1, x0] = 255
        label[y0:y1, x1 - 1] = 255
        img[:, y0:y1, x0:x1] = (
            img[:, y0:y1, x0:x1] // 2 + int(rng.randint(0, 128)))
    return img, label


def reader_creator(split, size):
    def reader():
        for i in range(size):
            yield _sample(split, i)

    return reader


def train():
    """Segmentation train creator (ref voc2012.py:69)."""
    return reader_creator("train", TRAIN_SIZE)


def test():
    """Test creator (ref voc2012.py:76)."""
    return reader_creator("test", TEST_SIZE)


def val():
    """Validation creator (ref voc2012.py:83)."""
    return reader_creator("val", VAL_SIZE)


def fetch():
    next(train()())
