"""WMT16 EN<->DE translation dataset (counterpart of
paddle_tpu/dataset/wmt16.py; ref python/paddle/dataset/wmt16.py).

Contract (ref wmt16.py:109-145): creators take (src_dict_size,
trg_dict_size, src_lang) and yield ``(src_ids, trg_ids, trg_ids_next)``
with <s>=0, <e>=1, <unk>=2 in both vocabularies; ``get_dict(lang,
dict_size, reverse)`` returns the per-language dict.  Synthetic pairs
share a latent sequence (same scheme as wmt14, separate namespace).
"""
import numpy as np

from . import synthetic

__all__ = [
    "train", "test", "validation", "get_dict", "fetch", "convert"
]

TRAIN_SIZE = 2000
TEST_SIZE = 400
VAL_SIZE = 400


def _lang_words(lang, n):
    return ["<s>", "<e>", "<unk>"] + \
        ["%s%05d" % (lang, i) for i in range(n - 3)]


def _pair(split, i, src_size, trg_size):
    rng = synthetic.rng_for("wmt16", split, i)
    n = int(rng.randint(4, 30))
    src = [3 + int(w) % (src_size - 3)
           for w in synthetic.zipf_sentence(rng, src_size - 3, n)]
    trg = [3 + (w - 3 + 11) % (trg_size - 3) for w in src]
    if n > 8:
        trg = trg[:-2]
    return src, trg


def reader_creator(split, size, src_dict_size, trg_dict_size, src_lang):
    def reader():
        for i in range(size):
            src_ids, trg_ids = _pair(split, i, src_dict_size,
                                     trg_dict_size)
            src_ids = [0] + src_ids + [1]
            trg_ids_next = trg_ids + [1]
            trg_ids = [0] + trg_ids
            yield src_ids, trg_ids, trg_ids_next

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    """Train creator (ref wmt16.py:147)."""
    if src_lang not in ["en", "de"]:
        raise ValueError("An error language type. Only support: "
                         "en (for English); de(for Germany).")
    return reader_creator("train", TRAIN_SIZE, src_dict_size,
                          trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    """Test creator (ref wmt16.py:196)."""
    if src_lang not in ["en", "de"]:
        raise ValueError("An error language type. Only support: "
                         "en (for English); de(for Germany).")
    return reader_creator("test", TEST_SIZE, src_dict_size, trg_dict_size,
                          src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    """Validation creator (ref wmt16.py:245)."""
    if src_lang not in ["en", "de"]:
        raise ValueError("An error language type. Only support: "
                         "en (for English); de(for Germany).")
    return reader_creator("val", VAL_SIZE, src_dict_size, trg_dict_size,
                          src_lang)


def get_dict(lang, dict_size, reverse=False):
    """Per-language word dict (ref wmt16.py:292)."""
    words = _lang_words(lang, dict_size)
    if reverse:
        return dict(enumerate(words))
    return {w: i for i, w in enumerate(words)}


def fetch():
    next(train(100, 100)())


def convert(path, src_dict_size, trg_dict_size, src_lang):  # parity stub
    pass
