"""Shared helpers for the synthetic corpus generators.

Every module in this package derives its payload from a deterministic
stream seeded on (corpus name, split, index), so readers are stable
across processes/hosts (important for data-parallel determinism,
SURVEY §5) and restartable without any materialized cache.
"""
import hashlib

import numpy as np

__all__ = ["seed_for", "rng_for", "zipf_sentence", "make_vocab"]


def seed_for(*parts):
    """Stable 32-bit seed from a tuple of strings/ints."""
    h = hashlib.md5("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


def rng_for(*parts):
    return np.random.RandomState(seed_for(*parts))


def make_vocab(n, prefix="w"):
    """word -> id dict of n synthetic word strings (id = rank)."""
    width = len(str(n - 1))
    return {"%s%0*d" % (prefix, width, i): i for i in range(n)}


def zipf_sentence(rng, vocab_size, length, a=1.3):
    """A sentence of word-ids with a Zipf-like marginal — keeps frequency
    structure (stopwords vs tail) so build_dict cutoffs behave like on
    real text."""
    ids = rng.zipf(a, size=length)
    return list(np.minimum(ids - 1, vocab_size - 1).astype(np.int64))
