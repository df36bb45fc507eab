"""IMDB sentiment dataset (ref python/paddle/dataset/imdb.py).

Contract: ``build_dict(pattern, cutoff)`` -> word->id dict (ids ordered
by descending frequency, '<unk>' appended last); ``train(word_idx)`` /
``test(word_idx)`` yield ``(word_id_list, label)`` with label 0/1.
Synthetic corpus: Zipf-distributed reviews where a small set of
class-keyed sentiment words is over-sampled for one polarity, so
bag-of-words / LSTM classifiers genuinely separate the labels.
"""
import re

import numpy as np

from . import synthetic

__all__ = ['build_dict', 'train', 'test']

VOCAB = 5000
TRAIN_SIZE = 2000
TEST_SIZE = 500
_SENTI = 40  # first ids after stopwords carry class signal


def _words(split, i):
    rng = synthetic.rng_for("imdb", split, i)
    label = int(rng.randint(2))
    n = int(rng.randint(20, 120))
    ids = synthetic.zipf_sentence(rng, VOCAB, n)
    # inject polarity words: ids [100, 100+_SENTI) positive,
    # [140, 140+_SENTI) negative
    base = 100 + (0 if label else _SENTI)
    for _ in range(max(3, n // 8)):
        ids[int(rng.randint(n))] = base + int(rng.randint(_SENTI))
    return ["w%04d" % w for w in ids], label


def tokenize(pattern):
    """Yield tokenized documents for the split named by ``pattern``
    (the reference greps a tarball with an aclImdb path regex; the
    synthetic corpus keys off the train/test substring)."""
    split = "train" if "train" in str(pattern) else "test"
    size = TRAIN_SIZE if split == "train" else TEST_SIZE
    for i in range(size):
        yield _words(split, i)[0]


def build_dict(pattern, cutoff):
    """Frequency-sorted word dict over the split, dropping words with
    frequency <= cutoff; '<unk>' gets the last id (ref imdb.py:59)."""
    word_freq = {}
    for doc in tokenize(pattern):
        for w in doc:
            word_freq[w] = word_freq.get(w, 0) + 1
    word_freq = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words, _ = list(zip(*dictionary))
    word_idx = dict(list(zip(words, range(len(words)))))
    word_idx['<unk>'] = len(words)
    return word_idx


def reader_creator(split, size, word_idx):
    unk = word_idx['<unk>']

    def reader():
        for i in range(size):
            words, label = _words(split, i)
            yield [word_idx.get(w, unk) for w in words], label

    return reader


def train(word_idx):
    """Train creator: (ids, 0/1) (ref imdb.py:97)."""
    return reader_creator("train", TRAIN_SIZE, word_idx)


def test(word_idx):
    """Test creator (ref imdb.py:114)."""
    return reader_creator("test", TEST_SIZE, word_idx)


def word_dict():
    """Default dict over the train split (ref imdb.py:131)."""
    return build_dict(re.compile(r"train"), 150)


def fetch():
    next(train(word_dict())())
