"""CoNLL-2005 semantic-role-labeling dataset
(ref python/paddle/dataset/conll05.py).

Contract (ref conll05.py:150-205): ``test()`` yields 9-tuples
``(word_idx, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_idx, mark,
label_idx)`` — all length-T lists; ctx_* are the predicate's +-2-window
words broadcast to T; mark flags that window; labels are IOB SRL tags.
``get_dict()`` -> (word_dict, verb_dict, label_dict);
``get_embedding()`` -> float32[len(word_dict), 32] pretrained-style
embedding matrix (synthetic, deterministic).
"""
import numpy as np

from . import synthetic

__all__ = ['test', 'get_dict', 'get_embedding']

UNK_IDX = 0
WORD_VOCAB = 1000
VERB_VOCAB = 50
TEST_SIZE = 300
_LABELS = ['B-A0', 'I-A0', 'B-A1', 'I-A1', 'B-A2', 'I-A2', 'B-V', 'I-V',
           'B-AM-TMP', 'I-AM-TMP', 'O']
EMB_DIM = 32


def load_label_dict(filename=None):
    return {l: i for i, l in enumerate(_LABELS)}


def get_dict():
    """(word_dict, verb_dict, label_dict) (ref conll05.py:205)."""
    word_dict = synthetic.make_vocab(WORD_VOCAB)
    word_dict['bos'] = len(word_dict)
    word_dict['eos'] = len(word_dict)
    verb_dict = synthetic.make_vocab(VERB_VOCAB, prefix="v")
    return word_dict, verb_dict, load_label_dict()


def get_embedding():
    """Deterministic float32[|V|, 32] word-embedding matrix (the
    reference returns a downloaded binary; ours is generated)
    (ref conll05.py:218)."""
    word_dict, _, _ = get_dict()
    rng = synthetic.rng_for("conll05", "emb")
    return rng.normal(0, 0.1, (len(word_dict), EMB_DIM)).astype(np.float32)


def _sentence(i):
    rng = synthetic.rng_for("conll05", "test", i)
    T = int(rng.randint(5, 25))
    words = [int(w) for w in synthetic.zipf_sentence(rng, WORD_VOCAB, T)]
    verb_index = int(rng.randint(T))
    verb = int(rng.randint(VERB_VOCAB))
    labels = ['O'] * T
    labels[verb_index] = 'B-V'
    # a plausible A0 span before the verb, A1 span after
    if verb_index > 1:
        s = int(rng.randint(0, verb_index - 1))
        labels[s] = 'B-A0'
        for j in range(s + 1, verb_index):
            labels[j] = 'I-A0'
    if verb_index < T - 2:
        s = int(rng.randint(verb_index + 1, T - 1))
        labels[s] = 'B-A1'
        for j in range(s + 1, T):
            labels[j] = 'I-A1'
    return words, verb_index, verb, labels


def reader_creator(word_dict=None, predicate_dict=None, label_dict=None):
    bos = word_dict['bos']
    eos = word_dict['eos']

    def ctx(words, j):
        if 0 <= j < len(words):
            return words[j]
        return bos if j < 0 else eos

    def reader():
        for i in range(TEST_SIZE):
            words, vi, verb, labels = _sentence(i)
            T = len(words)
            mark = [0] * T
            for j in range(max(0, vi - 2), min(T, vi + 3)):
                mark[j] = 1
            yield (words,
                   [ctx(words, vi - 2)] * T, [ctx(words, vi - 1)] * T,
                   [ctx(words, vi)] * T, [ctx(words, vi + 1)] * T,
                   [ctx(words, vi + 2)] * T,
                   [verb] * T, mark,
                   [label_dict[l] for l in labels])

    return reader


def test():
    """SRL test-set creator of 9-slot samples (ref conll05.py:225)."""
    word_dict, verb_dict, label_dict = get_dict()
    return reader_creator(word_dict, verb_dict, label_dict)


def fetch():
    next(test()())
