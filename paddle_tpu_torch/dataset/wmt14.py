"""WMT14 EN->FR translation dataset (ref python/paddle/dataset/wmt14.py).

Contract: ``train(dict_size)``/``test(dict_size)`` yield
``(src_ids, trg_ids, trg_ids_next)`` where src is <s>-/<e>-bracketed,
trg is <s>-prefixed, trg_next is <e>-suffixed — exactly the teacher-
forcing triplet the reference emits (ref wmt14.py:81-113).  Special ids:
<s>=0, <e>=1, <unk>=2.  Synthetic sentence pairs share a latent "meaning"
sequence so attention models can actually learn the mapping.
"""
import numpy as np

from . import synthetic

__all__ = ['train', 'test', 'get_dict', 'convert']

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

TRAIN_SIZE = 2000
TEST_SIZE = 400
GEN_SIZE = 100


def _dicts(dict_size):
    words = [START, END, UNK] + \
        ["src%05d" % i for i in range(dict_size - 3)]
    src = dict(zip(words, range(len(words))))
    trgw = [START, END, UNK] + \
        ["trg%05d" % i for i in range(dict_size - 3)]
    trg = dict(zip(trgw, range(len(trgw))))
    return src, trg


def _pair(split, i, dict_size):
    rng = synthetic.rng_for("wmt14", split, i)
    n = int(rng.randint(4, 30))
    latent = [3 + int(w) % (dict_size - 3)
              for w in synthetic.zipf_sentence(rng, dict_size - 3, n)]
    # target is a noisy affine re-indexing of the source "meaning"
    trg = [3 + (w - 3 + 7) % (dict_size - 3) for w in latent]
    if n > 6:
        trg = trg[:-1]
    return latent, trg


def reader_creator(split, size, dict_size):
    def reader():
        for i in range(size):
            src_ids, trg_ids = _pair(split, i, dict_size)
            src_ids = [0] + src_ids + [1]
            trg_ids_next = trg_ids + [1]
            trg_ids = [0] + trg_ids
            yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size):
    """Train creator of teacher-forcing triplets (ref wmt14.py:117)."""
    return reader_creator("train", TRAIN_SIZE, dict_size)


def test(dict_size):
    """Test creator (ref wmt14.py:133)."""
    return reader_creator("test", TEST_SIZE, dict_size)


def gen(dict_size):
    """Generation split (ref wmt14.py:149)."""
    return reader_creator("gen", GEN_SIZE, dict_size)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); id->word when reverse (ref wmt14.py:155)."""
    src_dict, trg_dict = _dicts(dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict


def fetch():
    next(train(100)())


def convert(path):  # parity stub: recordio conversion is cache-side
    pass
