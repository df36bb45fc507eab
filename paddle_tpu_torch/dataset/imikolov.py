"""imikolov (PTB-style) language-model dataset
(ref python/paddle/dataset/imikolov.py).

Contract: ``build_dict(min_word_freq)`` -> word->id with '<unk>' and
'<e>' entries; ``train(word_idx, n, data_type)`` yields n-gram tuples
(DataType.NGRAM) or whole sentences bracketed by <s>/<e> ids
(DataType.SEQ).  Synthetic sentences follow a Zipf marginal so
frequency cutoffs work.
"""
import numpy as np

from . import synthetic

__all__ = ['train', 'test', 'build_dict']

VOCAB = 2000
TRAIN_SIZE = 3000
TEST_SIZE = 500


class DataType(object):
    NGRAM = 1
    SEQ = 2


def _sentence(split, i):
    rng = synthetic.rng_for("imikolov", split, i)
    n = int(rng.randint(5, 30))
    return ["w%04d" % w for w in synthetic.zipf_sentence(rng, VOCAB, n)]


def word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = {}
    for sent in f:
        for w in sent:
            word_freq[w] = word_freq.get(w, 0) + 1
        word_freq['<s>'] = word_freq.get('<s>', 0) + 1
        word_freq['<e>'] = word_freq.get('<e>', 0) + 1
    return word_freq


def build_dict(min_word_freq=50):
    """Frequency-filtered dict over train+test, '<unk>' appended
    (ref imikolov.py:54)."""
    word_freq = word_count(
        (_sentence("train", i) for i in range(TRAIN_SIZE)),
        word_count((_sentence("test", i) for i in range(TEST_SIZE))))
    if '<unk>' in word_freq:
        del word_freq['<unk>']
    word_freq = [x for x in word_freq.items() if x[1] > min_word_freq]
    word_freq_sorted = sorted(word_freq, key=lambda el: (-el[1], el[0]))
    words, _ = list(zip(*word_freq_sorted))
    word_idx = dict(list(zip(words, range(len(words)))))
    word_idx['<unk>'] = len(words)
    return word_idx


def reader_creator(split, size, word_idx, n, data_type):
    def reader():
        UNK = word_idx['<unk>']
        for i in range(size):
            if DataType.NGRAM == data_type:
                l = ['<s>'] + _sentence(split, i) + ['<e>']
                if len(l) >= n:
                    l = [word_idx.get(w, UNK) for w in l]
                    for j in range(n, len(l) + 1):
                        yield tuple(l[j - n:j])
            elif DataType.SEQ == data_type:
                l = _sentence(split, i)
                l = [word_idx.get(w, UNK) for w in l]
                src_seq = [word_idx['<s>']] + l
                trg_seq = l + [word_idx['<e>']]
                if n > 0 and len(l) > n:
                    continue
                yield src_seq, trg_seq
            else:
                assert False, 'Unknown data type'

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    """Train creator (ref imikolov.py:114)."""
    return reader_creator("train", TRAIN_SIZE, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    """Test creator (ref imikolov.py:134)."""
    return reader_creator("test", TEST_SIZE, word_idx, n, data_type)


def fetch():
    next(train(build_dict(), 5)())
