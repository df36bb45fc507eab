"""Build and load the C++ data plane (``dataplane.cc``) with g++ and ctypes.

Counterpart of paddle_tpu/native/build.py. The library is built at first
use into ``<repo>/build/paddle_tpu_torch/dataplane/<hash>/``, beside the
kernels' library, keyed by a hash of the source and the flags, so a
checkout builds once and an edited source rebuilds. A failed build raises
``DataPlaneBuildError`` carrying g++'s output, and so does every later
use in the process: nothing falls back to the plain Python readers
(``recordio.plain_records``, ``multislot.plain_multislot``), which stay
only as the versions the tests hold the C++ plane against.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "dataplane.cc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "paddle_tpu_torch", "dataplane")
LIB_NAME = "libdataplane.so"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None
_error = None
build_seconds = None   # wall time of this process's build, None if cached


class DataPlaneBuildError(RuntimeError):
    """g++ is missing or refused ``dataplane.cc``; the message holds its
    output."""


def _key():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_ROOT, _key(), LIB_NAME)


def _build(so_path):
    global build_seconds
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = "%s.tmp.%d.%d" % (so_path, os.getpid(), threading.get_ident())
    cmd = ["g++"] + CXX_FLAGS + [SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise DataPlaneBuildError("cannot run g++ to build %s: %s"
                                  % (SOURCE, e)) from e
    if out.returncode != 0:
        raise DataPlaneBuildError(
            "g++ failed (exit %d) building %s:\n%s%s"
            % (out.returncode, SOURCE, out.stdout, out.stderr))
    os.replace(tmp, so_path)            # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0


def _bind(lib):
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    c_char_p_out = ctypes.POINTER(ctypes.POINTER(ctypes.c_char))
    lib.dp_reader_create.restype = ctypes.c_void_p
    lib.dp_reader_create.argtypes = [c_char_pp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_int]
    lib.dp_reader_next.restype = ctypes.c_int
    lib.dp_reader_next.argtypes = [ctypes.c_void_p, c_char_p_out,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.dp_reader_destroy.argtypes = [ctypes.c_void_p]
    lib.dp_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.dp_writer_create.restype = ctypes.c_void_p
    lib.dp_writer_create.argtypes = [ctypes.c_char_p]
    lib.dp_writer_write.restype = ctypes.c_int
    lib.dp_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64]
    lib.dp_writer_close.argtypes = [ctypes.c_void_p]
    lib.ms_parse_file.restype = ctypes.POINTER(ctypes.c_char)
    lib.ms_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ms_last_error.restype = ctypes.c_char_p
    return lib


def load_dataplane():
    """The loaded library, built first if this checkout has none; raises
    DataPlaneBuildError if it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            so_path = library_path()
            try:
                if not os.path.exists(so_path):
                    _build(so_path)
                _lib = _bind(ctypes.CDLL(so_path))
            except DataPlaneBuildError as e:
                _error = e
            except OSError as e:
                _error = DataPlaneBuildError(
                    "cannot load %s: %s" % (so_path, e))
        if _error is not None:
            raise _error
        return _lib


def native_available():
    """True when the C++ plane is built and loaded (building it if need
    be); the readers use nothing else."""
    try:
        load_dataplane()
    except DataPlaneBuildError:
        return False
    return True
