"""The port's Dataset API against the JAX package's, on the same files.

QueueDataset and InMemoryDataset of each package read the same record
files and MultiSlot text, with and without ``set_length_buckets``, and
must give equal batches (every array, dtype and ``<slot>__lens``
included): reads use one thread, so both packages see the files in
order; InMemoryDataset's shuffle is ``random.Random(seed)`` in both and
must give the same order. Errors carry the same text. All comparisons
are exact.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.dataset import dataset_api as jds
from paddle_tpu_torch.dataset import dataset_api as tds
from paddle_tpu_torch.native import recordio


class _Var(object):
    def __init__(self, name, dtype):
        self.name = name
        self.dtype = dtype


USE = [_Var("ids", "int64"), _Var("label", "int64")]


def _ragged(n, seed, max_len=24):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 100, (int(rng.randint(2, max_len)),))
             .astype(np.int64), np.array([i % 2], np.int64))
            for i in range(n)]


def _files(tmp_path, kind):
    """Two files of ragged samples, as records or MultiSlot text."""
    paths = []
    for f in range(2):
        samples = _ragged(21, seed=f)
        if kind == "ptrec":
            path = str(tmp_path / ("d%d.ptrec" % f))
            recordio.write_records(path, samples)
        else:
            path = str(tmp_path / ("d%d.txt" % f))
            with open(path, "w") as out:
                for ids, label in samples:
                    out.write("%d %s 1 %d\n" % (
                        len(ids), " ".join(str(v) for v in ids), label[0]))
        paths.append(path)
    return paths


def _dataset(mod, cls, paths, batch, buckets=None, shuffle=0):
    ds = getattr(mod, cls)()
    ds.set_filelist(paths)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_use_var(USE)
    if buckets:
        ds.set_length_buckets(buckets, by="ids")
    if cls == "InMemoryDataset":
        ds.load_into_memory()
        for _ in range(shuffle):
            ds.global_shuffle()
    return ds


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["ptrec", "multislot_text"])
@pytest.mark.parametrize("cls", ["QueueDataset", "InMemoryDataset"])
@pytest.mark.parametrize("buckets", [None, (8, 16, 32)])
def test_batches_equal_the_jax_packages(tmp_path, kind, cls, buckets):
    """Two files, batch 4: ragged ids pad to the batch's longest (or to
    the bucket width) with ``ids__lens``; InMemoryDataset shuffled twice
    with the same seed in both packages."""
    paths = _files(tmp_path, kind)
    shuffle = 2 if cls == "InMemoryDataset" else 0
    got = list(_dataset(tds, cls, paths, 4, buckets, shuffle))
    want = list(_dataset(jds, cls, paths, 4, buckets, shuffle))
    _assert_same_batches(got, want)
    assert "ids__lens" in got[0]
    assert sum(len(b["label"]) for b in got) == 42
    if buckets:
        assert {b["ids"].shape[1] for b in got} <= set(buckets)


def test_in_memory_dataset_shuffles_and_releases(tmp_path):
    paths = _files(tmp_path, "ptrec")
    t = _dataset(tds, "InMemoryDataset", paths, 6)
    j = _dataset(jds, "InMemoryDataset", paths, 6)
    assert t.get_memory_data_size() == j.get_memory_data_size() == 42
    before = [b["label"].tolist() for b in t]
    for ds in (t, j):
        ds.local_shuffle()
        ds.local_shuffle()
    _assert_same_batches(list(t), list(j))
    assert [b["label"].tolist() for b in t] != before
    t.release_memory()
    assert t.get_memory_data_size() == 0 and list(t) == []


def test_dataset_factory_and_mixed_formats(tmp_path):
    """DatasetFactory's classes, and a file list mixing record files and
    text, each sniffed by its magic bytes."""
    assert isinstance(ptt.DatasetFactory().create_dataset(
        "InMemoryDataset"), tds.InMemoryDataset)
    assert isinstance(ptt.DatasetFactory().create_dataset(),
                      tds.QueueDataset)
    paths = [_files(tmp_path, "ptrec")[0],
             _files(tmp_path, "multislot_text")[1]]
    _assert_same_batches(
        list(_dataset(tds, "QueueDataset", paths, 5)),
        list(_dataset(jds, "QueueDataset", paths, 5)))
    with pytest.raises(ValueError, match="unknown data format"):
        tds.QueueDataset().set_data_format("csv")


def _error(mod, fn):
    with pytest.raises(ValueError) as e:
        fn(mod)
    return str(e.value)


def test_errors_carry_the_jax_packages_text(tmp_path):
    """A sample longer than the largest bucket, a MultiSlot file read
    with names that carry no dtype, no buckets at all."""
    long_ = [(np.ones(40, np.int64), np.zeros(1, np.int64))]
    path = str(tmp_path / "long.ptrec")
    recordio.write_records(path, long_)
    text = tmp_path / "x.txt"
    text.write_text("1 5 1 1\n")

    def overflow(mod):
        ds = mod.QueueDataset()
        ds.set_filelist([path])
        ds.set_use_var(USE)
        ds.set_length_buckets((8, 16), by="ids")
        list(ds)

    def no_dtype(mod):
        ds = mod.QueueDataset()
        ds.set_filelist([str(text)])
        ds.set_use_var(["ids", "label"])
        list(ds)

    for fn, match in ((overflow, "longer than the largest bucket 16"),
                      (no_dtype, "dtype"),
                      (lambda m: m.QueueDataset().set_length_buckets(
                          (), by="ids"), "at least one bucket")):
        got, want = _error(tds, fn), _error(jds, fn)
        assert got == want and match in got


def test_feed_rank_mismatch_is_the_jax_packages_error(tmp_path):
    """DeepFM declares sparse_input [-1, 26, 1]; MultiSlot text of 26 ids
    a line collates to (B, 26). Both packages refuse it at the feed
    boundary with the same named error, reshaping nothing."""
    path = tmp_path / "ctr.txt"
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for _ in range(4):
            f.write("26 %s\n" % " ".join(str(v) for v in
                                         rng.randint(0, 50, 26)))
    errors = []
    for pkg, mod in ((ptt, tds), (pt, jds)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            sparse = pkg.layers.data("sparse_input", [26, 1], dtype="int64")
            out = pkg.layers.reduce_sum(pkg.layers.cast(sparse, "float32"))
        ds = mod.QueueDataset()
        ds.set_filelist([str(path)])
        ds.set_batch_size(4)
        ds.set_use_var([sparse])
        batch, = list(ds)
        assert batch["sparse_input"].shape == (4, 26)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        with pytest.raises(ValueError) as e:
            exe.run(main, feed=batch, fetch_list=[out])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "has rank 2" in errors[0] and "declares rank 3" in errors[0]
