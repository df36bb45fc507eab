"""The Paddle Book's corpora in the port against the JAX package's:
``uci_housing``, ``mnist``, ``cifar``, ``imikolov``, ``imdb``,
``movielens``, ``conll05``, ``wmt14`` with ``common`` and ``synthetic``
(numpy-only copies; the port imports nothing of paddle_tpu). Each
reader's first 64 samples equal the JAX package's field for field, bit
for bit, and so do the dicts and tables; ``common`` resolves files alike
and never fetches; ``uci_housing.fluid_model`` trains and saves with the
port (on the CPU here), and the saved model serves.
"""
import itertools

import numpy as np
import pytest

from paddle_tpu import dataset as jds
from paddle_tpu_torch import dataset as tds

N = 64


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _first(reader):
    return list(itertools.islice(reader(), N))


def _readers(m):
    """(name, reader creator) pairs of a corpus module, by the module's
    own API."""
    if m.__name__.endswith("uci_housing"):
        return [("train", m.train()), ("test", m.test()),
                ("predict", m.predict_reader())]
    if m.__name__.endswith("mnist"):
        return [("train", m.train()), ("test", m.test())]
    if m.__name__.endswith("cifar"):
        return [("train10", m.train10()), ("test10", m.test10()),
                ("train100", m.train100()), ("test100", m.test100())]
    if m.__name__.endswith("imikolov"):
        d = m.build_dict(min_word_freq=2)
        return [("ngram", m.train(d, 5)), ("test", m.test(d, 5)),
                ("seq", m.train(d, 5, m.DataType.SEQ))]
    if m.__name__.endswith("imdb"):
        d = m.word_dict()
        return [("train", m.train(d)), ("test", m.test(d))]
    if m.__name__.endswith("movielens"):
        return [("train", m.train), ("test", m.test)]
    if m.__name__.endswith("conll05"):
        return [("test", m.test())]
    if m.__name__.endswith("wmt14"):
        return [("train", m.train(300)), ("test", m.test(300)),
                ("gen", m.gen(300))]
    raise AssertionError(m.__name__)


CORPORA = ["uci_housing", "mnist", "cifar", "imikolov", "imdb",
           "movielens", "conll05", "wmt14"]


@pytest.mark.parametrize("name", CORPORA)
def test_first_samples_equal(name):
    jm, tm = getattr(jds, name), getattr(tds, name)
    assert tm.__name__ == "paddle_tpu_torch.dataset." + name
    for (split, jr), (_, tr) in zip(_readers(jm), _readers(tm)):
        j, t = _first(jr), _first(tr)
        assert len(j) == len(t) > 0, split
        _same(j, t)


def test_dicts_and_tables_equal():
    _same(jds.imikolov.build_dict(min_word_freq=2),
          tds.imikolov.build_dict(min_word_freq=2))
    _same(jds.imdb.word_dict(), tds.imdb.word_dict())
    _same(jds.conll05.get_dict(), tds.conll05.get_dict())
    _same(jds.wmt14.get_dict(300), tds.wmt14.get_dict(300))
    ml_j, ml_t = jds.movielens, tds.movielens
    for fn in ("max_movie_id", "max_user_id", "max_job_id",
               "movie_categories", "get_movie_title_dict"):
        _same(getattr(ml_j, fn)(), getattr(ml_t, fn)())
    assert ml_j.age_table == ml_t.age_table
    for fn in ("user_info", "movie_info"):
        j, t = getattr(ml_j, fn)(), getattr(ml_t, fn)()
        assert j.keys() == t.keys()
        _same([v.value() for v in j.values()], [v.value() for v in
                                                 t.values()])
    _same(jds.uci_housing.feature_names, tds.uci_housing.feature_names)


def test_synthetic_and_common():
    for parts in (("imdb", "train", 3), ("uci", "w")):
        assert jds.synthetic.seed_for(*parts) == \
            tds.synthetic.seed_for(*parts)
    _same(jds.synthetic.make_vocab(17), tds.synthetic.make_vocab(17))
    with pytest.raises(RuntimeError, match="not in the local cache"):
        tds.common.download("http://example.invalid/x.tgz", "nothing", None)


def test_fluid_model_trains_and_serves_in_the_port(tmp_path, monkeypatch):
    """uci_housing.fluid_model() fits the regressor with the port (on the
    CPU here) and saves it; the saved model loads and predicts."""
    import paddle_tpu_torch as ptt
    monkeypatch.setattr(tds.uci_housing, "DATA_HOME", str(tmp_path))
    d = tds.uci_housing.fluid_model(place=ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        prog, feeds, fetches = ptt.io.load_inference_model(d, exe)
        xs = np.stack([s[0] for s in _first(tds.uci_housing.test())[:8]])
        ys = np.stack([s[1] for s in _first(tds.uci_housing.test())[:8]])
        pred, = exe.run(prog, feed={feeds[0]: xs}, fetch_list=fetches)
    assert pred.shape == (8, 1)
    assert float(np.mean((pred - ys) ** 2)) < 5.0
    assert tds.uci_housing.fluid_model() == d      # cached
