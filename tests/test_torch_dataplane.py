"""The port's C++ data plane against the JAX package's and against the
port's own plain Python readers.

Record files ("ptrec") are written by either package and read by the
other, byte for byte the same file for the same samples; MultiSlot text
written by either package's data generator is the same text and parses
to the same arrays. Reads with one thread keep the files' order and are
compared in order; reads with several threads interleave files, and a
shuffle pool draws from std::mt19937 in C++ but random.Random in the
plain reader, so those are compared as multisets. Every comparison is
exact: the plane moves bytes and parses text, no arithmetic.
"""
import os
import pickle

import numpy as np
import pytest

import paddle_tpu.native as jnative
import paddle_tpu_torch as ptt
from paddle_tpu.dataset.dataset_api import QueueDataset as JQueueDataset
from paddle_tpu.incubate import data_generator as jgen
from paddle_tpu.native.multislot import MultiSlotTextReader as JMultiSlot
from paddle_tpu_torch.incubate import data_generator as tgen
from paddle_tpu_torch.native import build, multislot, recordio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3).astype(np.float32),
             rng.randint(0, 1000, (26, 1)).astype(np.int64),
             np.array([i % 2], np.float32)) for i in range(n)]


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_plane_builds_into_the_checkout():
    assert ptt.native.native_available()
    path = build.library_path()
    assert os.path.exists(path)
    assert path.startswith(os.path.join(ROOT, "build", "paddle_tpu_torch",
                                        "dataplane") + os.sep)


def test_failed_build_raises_a_named_error(tmp_path, monkeypatch):
    """A source g++ refuses: DataPlaneBuildError with g++'s output, from
    the build and from every reader after it; no Python fallback."""
    bad = tmp_path / "dataplane.cc"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SOURCE", str(bad))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_error", None)
    with pytest.raises(build.DataPlaneBuildError, match="g\\+\\+ failed"):
        build.load_dataplane()
    assert "error" in str(build._error)
    assert not build.native_available()
    path = tmp_path / "a.ptrec"
    path.write_bytes(b"")
    with pytest.raises(build.DataPlaneBuildError):
        recordio.RecordReader([str(path)])
    with pytest.raises(build.DataPlaneBuildError):
        recordio.RecordWriter(str(tmp_path / "b.ptrec"))
    with pytest.raises(build.DataPlaneBuildError):
        list(multislot.MultiSlotTextReader([str(path)],
                                           [("x", "int64")]).samples())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_record_files_cross_packages(tmp_path, writer):
    """One package writes, both read (C++ with one thread, and the port's
    plain Python reader); the two packages' files are equal byte for
    byte. (paddle_tpu's own Python fallback checks another checksum basis
    than its C++ plane and reads no record of these files:
    recordio.FNV_BASIS.)"""
    samples = _samples(40)
    tpath, jpath = str(tmp_path / "t.ptrec"), str(tmp_path / "j.ptrec")
    assert recordio.write_records(tpath, samples) == 40
    assert jnative.write_records(jpath, samples) == 40
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    path = tpath if writer == "port" else jpath
    port = list(recordio.RecordReader(path, num_threads=1).samples())
    jax_side = list(jnative.RecordReader(path, num_threads=1).samples())
    plain = [pickle.loads(p) for p in recordio.plain_records(path)]
    for got in (port, jax_side, plain):
        _same_samples(got, samples)


def test_record_reader_threads_and_pool_against_plain(tmp_path):
    """Four files on four threads, and a shuffle pool: the same multiset
    of records as the plain reader; the pool changes the order."""
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / ("f%d.ptrec" % i)))
        recordio.write_records(paths[-1], _samples(25, seed=i))
    plain = [bytes(p) for p in recordio.plain_records(paths)]
    threaded = list(recordio.RecordReader(paths, num_threads=4))
    assert sorted(threaded) == sorted(plain)
    ordered = list(recordio.RecordReader(paths, num_threads=1))
    assert ordered == plain
    pooled = list(recordio.RecordReader(paths, num_threads=1,
                                        shuffle_pool=32, seed=7))
    plain_pooled = list(recordio.plain_records(paths, shuffle_pool=32,
                                               seed=7))
    assert sorted(pooled) == sorted(plain_pooled) == sorted(plain)
    assert pooled != plain
    jpooled = list(jnative.RecordReader(paths, num_threads=1,
                                        shuffle_pool=32, seed=7))
    assert jpooled == pooled             # the same C++ pool and seed


def test_a_bad_checksum_ends_its_file(tmp_path):
    path = str(tmp_path / "c.ptrec")
    recordio.write_records(path, _samples(3))
    size = os.path.getsize(path) // 3
    with open(path, "r+b") as f:         # a payload byte of record 2
        f.seek(size + 30)
        b = f.read(1)
        f.seek(size + 30)
        f.write(bytes([b[0] ^ 0xFF]))
    got = list(recordio.RecordReader(path, num_threads=1))
    assert got == list(recordio.plain_records(path))
    assert len(got) == 1


def test_native_data_loader(tmp_path):
    path = str(tmp_path / "l.ptrec")
    samples = _samples(10)
    recordio.write_records(path, samples)
    names = ["dense", "sparse", "label"]
    batches = list(recordio.NativeDataLoader(path, names, 4, num_threads=1,
                                             drop_last=False))
    jbatches = list(jnative.NativeDataLoader(path, names, 4, num_threads=1,
                                             drop_last=False))
    assert [b["sparse"].shape for b in batches] == \
        [(4, 26, 1), (4, 26, 1), (2, 26, 1)]
    for b, j in zip(batches, jbatches):
        for n in names:
            np.testing.assert_array_equal(b[n], j[n])
    assert len(list(recordio.NativeDataLoader(path, names, 4))) == 2


class _Gen(object):
    """A data generator of ragged ids and a float slot, for either
    package's MultiSlotDataGenerator."""

    @staticmethod
    def make(mod, n, seed):
        rng = np.random.RandomState(seed)

        class Gen(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    for i in range(n):
                        ln = int(rng.randint(1, 9))
                        yield [("ids", [int(v) for v in
                                        rng.randint(1, 500, ln)]),
                               ("dense", [float(v) for v in
                                          np.round(rng.rand(2), 4)]),
                               ("label", [i % 2])]
                return it
        return Gen()


SLOTS = [("ids", "int64"), ("dense", "float32"), ("label", "int64")]


def _gen_text(mod, n=30, seed=3):
    chunks = []
    _Gen.make(mod, n, seed).run_from_memory(write=chunks.append)
    return "".join(chunks)


def test_multislot_generators_and_parsers_agree(tmp_path):
    """Both packages' generators write the same text; the port's C++
    parse equals its plain parse and the JAX package's parse."""
    text = _gen_text(tgen)
    assert text == _gen_text(jgen)
    path = tmp_path / "g.txt"
    path.write_text(text)
    got = list(multislot.MultiSlotTextReader([str(path)], SLOTS).samples())
    plain = list(multislot.plain_multislot(str(path), SLOTS))
    jax_side = list(JMultiSlot([str(path)], SLOTS).samples())
    assert len(got) == len(plain) == len(jax_side) == 30
    for g, p, j in zip(got, plain, jax_side):
        for name, dt in SLOTS:
            assert g[name].dtype == p[name].dtype == np.dtype(dt)
            np.testing.assert_array_equal(g[name], p[name])
            np.testing.assert_array_equal(g[name], j[name])


@pytest.mark.parametrize("line,where", [("2 3", ":1:"),
                                        ("1 3 2 0.5 1.5 1 0 9", ":1:"),
                                        ("1 3 x 0.5", ":1:")])
def test_multislot_errors_name_the_file_and_line(tmp_path, line, where):
    """A short slot, trailing data, a bad count: ValueError("multislot
    parse failed: <file>:<line>: ...") from the C++ parse (the JAX
    package's text exactly), the plain parse and the JAX package."""
    path = tmp_path / "bad.txt"
    path.write_text(line + "\n")
    errors = []
    for read in (
            lambda: list(multislot.MultiSlotTextReader(
                [str(path)], SLOTS).samples()),
            lambda: list(JMultiSlot([str(path)], SLOTS).samples()),
            lambda: list(multislot.plain_multislot(str(path), SLOTS))):
        with pytest.raises(ValueError, match="multislot parse failed") as e:
            read()
        assert str(path) + where in str(e.value)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_data_generator_errors_match():
    for mod in (tgen, jgen):
        g = mod.MultiSlotDataGenerator()
        with pytest.raises(ValueError, match="list or tuple"):
            g._gen_str("x")
        g._gen_str([("a", [1])])
        with pytest.raises(ValueError, match="inconsistent"):
            g._gen_str([("a", [1]), ("b", [2])])
        s = mod.MultiSlotStringDataGenerator()
        assert s._gen_str([("w", ["x", "y"])]) == "2 x y\n"


def test_queue_dataset_reads_generated_text_like_jax(tmp_path):
    """The generated text through a QueueDataset of each package: the
    same batches, ragged ``ids`` padded to the batch's longest with
    ``ids__lens`` beside it."""
    path = tmp_path / "g.txt"
    path.write_text(_gen_text(tgen, n=11))
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        uses = [ptt.layers.data(n, [-1] if n == "ids" else [1], dtype=d)
                for n, d in SLOTS]
    batches = []
    for ds in (ptt.DatasetFactory().create_dataset("QueueDataset"),
               JQueueDataset()):
        ds.set_filelist([str(path)])
        ds.set_batch_size(4)
        ds.set_use_var(uses)
        batches.append(list(ds))
    assert [sorted(b) for b in batches[0]] == [sorted(b) for b in
                                               batches[1]]
    assert "ids__lens" in batches[0][0]
    for t, j in zip(*batches):
        for k in t:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])


def test_data_feed_desc_like_jax(tmp_path):
    from paddle_tpu.data_feed_desc import DataFeedDesc as JDesc
    proto = tmp_path / "data.proto"
    proto.write_text(
        'name: "MultiSlotDataFeed"\nbatch_size: 2\nmulti_slot_desc {\n'
        '    slots {\n        name: "words"\n        type: "uint64"\n'
        '        is_dense: false\n        is_used: false\n    }\n'
        '    slots {\n        name: "label"\n        type: "uint64"\n'
        '        is_dense: false\n        is_used: false\n    }\n}\n')
    descs = [ptt.DataFeedDesc(str(proto)), JDesc(str(proto))]
    for d in descs:
        d.set_batch_size(128)
        d.set_dense_slots(["words"])
        d.set_use_slots(["words", "label"])
    assert descs[0].slots() == descs[1].slots()
    assert descs[0].desc() == descs[1].desc()
    assert "batch_size: 128" in descs[0].desc()
