"""Binary record files ("ptrec") and the threaded loader over them.

Counterpart of paddle_tpu/native/recordio.py, with the same on-disk
format byte for byte, so either package reads the other's files:

    magic u32 0x70747263 | length u64 | FNV-1a u64 of the payload | payload

all little-endian. A sample is a pickled tuple of numpy arrays.
``RecordWriter`` and ``RecordReader`` go through the C++ plane
(``dataplane.cc``: N reader threads, a bounded ring buffer, an optional
shuffle pool, a checksum on every record); a build failure raises
``build.DataPlaneBuildError``. ``plain_records`` is the plain Python
reader the tests hold ``RecordReader`` against; no entry point falls
back to it.
"""
import ctypes
import pickle
import random
import struct

import numpy as np

from .build import load_dataplane

MAGIC = 0x70747263
_HEAD = struct.Struct("<IQQ")


# dataplane.cc's offset basis: FNV-1a's 14695981039346656037 with its last
# digit lost. Files of both packages' C++ planes carry checksums made
# from it, so the plain reader uses it too (paddle_tpu's Python fallback
# uses the published basis and reads none of the C++ plane's records).
FNV_BASIS = 1469598103934665603


def fnv1a(data):
    """The records' checksum: 64-bit FNV-1a of ``data`` from
    ``FNV_BASIS``."""
    h = FNV_BASIS
    for b in data:
        h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


class RecordWriter(object):
    """Appends records to a new file through the C++ plane."""

    def __init__(self, path):
        self._lib = load_dataplane()
        self._path = path
        self._w = self._lib.dp_writer_create(path.encode())
        if not self._w:
            raise IOError("cannot open %s" % path)

    def write(self, payload):
        if not isinstance(payload, (bytes, bytearray)):
            payload = pickle.dumps(payload, protocol=4)
        if not self._lib.dp_writer_write(self._w, bytes(payload),
                                         len(payload)):
            raise IOError("write to %s failed" % self._path)

    def write_sample(self, arrays):
        self.write(pickle.dumps(tuple(np.asarray(a) for a in arrays),
                                protocol=4))

    def close(self):
        if self._w:
            self._lib.dp_writer_close(self._w)
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, samples):
    """Write each sample (a tuple of arrays) as one record; returns the
    count."""
    n = 0
    with RecordWriter(path) as w:
        for s in samples:
            w.write_sample(s)
            n += 1
    return n


class RecordReader(object):
    """Iterates the payload bytes of one or more record files: the C++
    plane's ``num_threads`` reader threads (files dealt round-robin, so
    with more than one thread records of different files interleave),
    a ring of ``buffer_records``, and with ``shuffle_pool`` > 0 a pool
    from which each pop takes a random record (``std::mt19937`` seeded
    with ``seed``). A record whose checksum fails ends its file."""

    def __init__(self, paths, buffer_records=256, shuffle_pool=0, seed=0,
                 num_threads=2):
        if isinstance(paths, str):
            paths = [paths]
        self._paths = list(paths)
        self._buffer = buffer_records
        self._pool = shuffle_pool
        self._seed = seed
        self._threads = num_threads
        self._lib = load_dataplane()

    def __iter__(self):
        lib = self._lib
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths])
        r = lib.dp_reader_create(arr, len(self._paths), self._buffer,
                                 self._pool, self._seed, self._threads)
        try:
            data = ctypes.POINTER(ctypes.c_char)()
            ln = ctypes.c_int64()
            while lib.dp_reader_next(r, ctypes.byref(data),
                                     ctypes.byref(ln)):
                payload = ctypes.string_at(data, ln.value)
                lib.dp_free(data)
                yield payload
        finally:
            lib.dp_reader_destroy(r)

    def samples(self):
        for payload in self:
            yield pickle.loads(payload)


def plain_records(paths, shuffle_pool=0, seed=0):
    """The plain Python reader (paddle_tpu's fallback path, checking the
    C++ plane's checksum, ``FNV_BASIS``): files in order, the same
    truncation rules; its shuffle pool draws
    from ``random.Random(seed)``, so a shuffled order differs from the
    C++ plane's (compare multisets)."""
    if isinstance(paths, str):
        paths = [paths]
    rng = random.Random(seed)
    pool = []
    for path in paths:
        with open(path, "rb") as f:
            while True:
                head = f.read(_HEAD.size)
                if len(head) < _HEAD.size:
                    break
                magic, ln, hsh = _HEAD.unpack(head)
                if magic != MAGIC:
                    break
                payload = f.read(ln)
                if len(payload) < ln or fnv1a(payload) != hsh:
                    break
                if shuffle_pool > 0:
                    pool.append(payload)
                    if len(pool) >= shuffle_pool:
                        i = rng.randrange(len(pool))
                        pool[i], pool[-1] = pool[-1], pool[i]
                        yield pool.pop()
                else:
                    yield payload
    rng.shuffle(pool)
    for p in pool:
        yield p


class NativeDataLoader(object):
    """Batches of record-file samples as feed dicts for Executor.run:
    ``feed_names`` name each sample tuple's arrays in order; a batch
    stacks ``batch_size`` samples (the short last one dropped unless
    ``drop_last`` is False)."""

    def __init__(self, paths, feed_names, batch_size, shuffle_pool=0,
                 seed=0, num_threads=2, drop_last=True):
        self._reader = RecordReader(paths, shuffle_pool=shuffle_pool,
                                    seed=seed, num_threads=num_threads)
        self._feed_names = list(feed_names)
        self._batch_size = batch_size
        self._drop_last = drop_last

    def __iter__(self):
        buf = []
        for sample in self._reader.samples():
            buf.append(sample)
            if len(buf) == self._batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self._drop_last:
            yield self._collate(buf)

    def _collate(self, samples):
        cols = list(zip(*samples))
        return {n: np.stack(c) for n, c in zip(self._feed_names, cols)}
