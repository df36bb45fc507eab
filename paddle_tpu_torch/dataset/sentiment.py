"""Movie-review sentiment dataset (counterpart of
paddle_tpu/dataset/sentiment.py; ref python/paddle/dataset/sentiment.py,
NLTK movie_reviews wrapper).

Contract: ``get_word_dict()`` -> frequency-ranked word->id;
``train()``/``test()`` yield ``(word_id_list, 0/1)``.  The synthetic
corpus reuses the imdb generator family with its own seed namespace.
"""
import numpy as np

from . import synthetic

__all__ = ['train', 'test', 'get_word_dict']

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
VOCAB = 3000
_SENTI = 30


def _words(i):
    rng = synthetic.rng_for("sentiment", i)
    label = int(rng.randint(2))
    n = int(rng.randint(15, 80))
    ids = synthetic.zipf_sentence(rng, VOCAB, n)
    base = 80 + (0 if label else _SENTI)
    for _ in range(max(3, n // 6)):
        ids[int(rng.randint(n))] = base + int(rng.randint(_SENTI))
    return ["w%04d" % w for w in ids], label


_WORD_DICT = None
_DATA = None


def get_word_dict():
    """Frequency-sorted (word, id) over the whole corpus, cached at
    module level like the reference's download cache
    (ref sentiment.py:70)."""
    global _WORD_DICT
    if _WORD_DICT is None:
        words_freq = {}
        for i in range(NUM_TOTAL_INSTANCES):
            for w in _words(i)[0]:
                words_freq[w] = words_freq.get(w, 0) + 1
        words_sort_list = sorted(words_freq.items(),
                                 key=lambda x: (-x[1], x[0]))
        _WORD_DICT = dict(
            (w, i) for i, (w, _) in enumerate(words_sort_list))
    return _WORD_DICT


def load_sentiment_data():
    global _DATA
    if _DATA is None:
        word_idx = get_word_dict()
        _DATA = [([word_idx[w] for w in ws], lab)
                 for ws, lab in (_words(i)
                                 for i in range(NUM_TOTAL_INSTANCES))]
    return _DATA


def reader_creator(data):
    def reader():
        for each in data:
            yield each

    return reader


def train():
    """First 1600 labeled reviews (ref sentiment.py:133)."""
    return reader_creator(load_sentiment_data()[:NUM_TRAINING_INSTANCES])


def test():
    """Remaining 400 reviews (ref sentiment.py:141)."""
    return reader_creator(load_sentiment_data()[NUM_TRAINING_INSTANCES:])


def fetch():
    next(train()())
