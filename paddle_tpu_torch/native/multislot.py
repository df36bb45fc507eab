"""MultiSlot text files: the reference MultiSlotDataFeed's format.

Counterpart of paddle_tpu/native/multislot.py. One sample a line; for
each slot, in the declared order, ``<count> v0 v1 ... v(count-1)``,
space-separated, as ``incubate.data_generator`` writes it. A whole file
is parsed in one call of the C++ plane (``dataplane.cc ms_parse_file``:
the text to one packed blob; ctypes drops the GIL for it), so a file
must be seekable; shard a large corpus into many files. A build failure
raises ``build.DataPlaneBuildError``. ``plain_multislot`` is the plain
Python parser the tests hold it against, with the same errors.
"""
import ctypes
import struct

import numpy as np

from .build import load_dataplane


def _norm_dtype(d):
    d = str(d)
    if "float" in d:
        return "float32"
    if "int" in d:
        return "int64"
    raise ValueError("multislot slots are float or integer, got %r" % d)


class MultiSlotTextReader(object):
    """``slots``: [(name, dtype)] in the files' slot order. ``samples()``
    yields one {name: 1-D np.ndarray} a line (int64 or float32)."""

    def __init__(self, paths, slots):
        self._paths = list(paths)
        self._slots = [(name, _norm_dtype(dt)) for name, dt in slots]

    def samples(self):
        lib = load_dataplane()
        for path in self._paths:
            for s in self._parse(lib, path):
                yield s

    def _parse(self, lib, path):
        flags = (ctypes.c_ubyte * len(self._slots))(
            *[1 if dt == "float32" else 0 for _, dt in self._slots])
        out_len = ctypes.c_uint64()
        buf = lib.ms_parse_file(path.encode(), len(self._slots), flags,
                                ctypes.byref(out_len))
        if not buf:
            raise ValueError("multislot parse failed: %s"
                             % lib.ms_last_error().decode())
        try:
            data = ctypes.string_at(buf, out_len.value)
        finally:
            lib.dp_free(buf)
        n, = struct.unpack_from("=Q", data, 0)
        off = 8
        for _ in range(n):
            sample = {}
            for name, dt in self._slots:
                cnt, = struct.unpack_from("=I", data, off)
                off += 4
                if dt == "float32":
                    arr = np.frombuffer(data, np.float32, cnt, off)
                    off += 4 * cnt
                else:
                    arr = np.frombuffer(data, np.int64, cnt, off)
                    off += 8 * cnt
                sample[name] = arr
            yield sample


def plain_multislot(path, slots):
    """The plain Python parser of one file (paddle_tpu's fallback path):
    the same samples and the same ``multislot parse failed`` errors, a
    line number in each, as the C++ plane's."""
    slots = [(name, _norm_dtype(dt)) for name, dt in slots]
    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            toks = line.split()
            if not toks:
                continue
            sample, i = {}, 0
            for s, (name, dt) in enumerate(slots):
                try:
                    cnt = int(toks[i])
                    if cnt < 0:
                        raise ValueError
                    i += 1
                    vals = toks[i:i + cnt]
                    if len(vals) != cnt:
                        raise ValueError
                    i += cnt
                except (ValueError, IndexError):
                    raise ValueError(
                        "multislot parse failed: %s:%d: bad slot %d"
                        % (path, line_no, s))
                sample[name] = np.asarray(
                    [float(v) if dt == "float32" else int(v)
                     for v in vals],
                    np.float32 if dt == "float32" else np.int64)
            if i != len(toks):
                raise ValueError(
                    "multislot parse failed: %s:%d: trailing data "
                    "after the last slot" % (path, line_no))
            yield sample
