"""Build the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``, then linked into one ``.so`` with a plain C
interface that ``ctypes`` loads. The library lands in
``<repo>/build/paddle_tpu_torch/<hash>/``, keyed by a hash of the sources
and flags, so a checkout builds once and an edited source rebuilds;
processes that start together take a lock on the directory and build it
once. A failed build raises ``KernelBuildError`` carrying nvcc's output.

``config_launches`` tallies the tuned kernels' launches by launch config,
as their wrappers made them (``count_config``): it shows which config a
call site's decision reached. A CUDA graph's replays are not credited to
it; the launch counters of ``ops/kernels/__init__.py`` hold those.
"""
import collections
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
    "build", "paddle_tpu_torch")
LIB_NAME = "libpaddle_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "ptt_flash_attention_fwd": (
        [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
         _ll, _i, _f, _i, _vp], _i),
    "ptt_flash_attention_bwd_dkv": (
        [_vp] * 9 + [_i] * 6 + [_ll, _i, _f, _i, _vp], _i),
    "ptt_flash_attention_bwd_dq": (
        [_vp] * 8 + [_i] * 6 + [_ll, _i, _f, _i, _vp], _i),
    "ptt_layer_norm_fwd": ([_vp] * 6 + [_i] * 3 + [_f] + [_i] * 4 + [_vp],
                           _i),
    "ptt_layer_norm_bwd": ([_vp] * 9 + [_i] * 7 + [_vp], _i),
    "ptt_layer_norm_max_cols": ([], _i),
    "ptt_fused_adam": ([_vp] * 7 + [_ll, _i] + [_f] * 6 + [_i, _vp], _i),
    "ptt_fused_head_fwd": ([_vp] * 6 + [_i] * 5 + [_vp, _vp], _i),
    "ptt_fused_head_fwd_scratch_bytes": ([_i] * 4, _ll),
    "ptt_fused_head_dh": ([_vp] * 7 + [_i] * 4 + [_vp], _i),
    "ptt_fused_head_dw": ([_vp] * 8 + [_i] * 4 + [_vp], _i),
    "ptt_fused_head_max_d": ([], _i),
    "ptt_ce_fwd": ([_vp] * 4 + [_i] * 4 + [_vp], _i),
    "ptt_ce_bwd": ([_vp] * 5 + [_i] * 4 + [_vp], _i),
    "ptt_finite_chunk": ([], _ll),
    "ptt_copy_chunk": ([], _ll),
    "ptt_finite_flags": ([_vp, _i, _ll, _vp, _vp], _i),
    "ptt_guarded_copy": ([_vp, _i, _ll, _vp, _vp], _i),
    "ptt_cuda_error_string": ([_i], ctypes.c_char_p),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its output."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error."""


_lib = None
config_launches = collections.Counter()
build_seconds = None   # wall time of this process's build, None if cached


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _key():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found on PATH or under "
                               "/usr/local/cuda/bin: the CUDA kernels of "
                               "paddle_tpu_torch cannot be built here")
    return nvcc


def _compile(out_dir):
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=out_dir, prefix="tmp")
    try:
        units = [s for s in _sources() if s.endswith(".cu")]
        procs = []
        for src in units:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, obj, p in procs:
            out = p.communicate()[0].decode(errors="replace")
            logs.append("== %s (rc=%d)\n%s" % (src, p.returncode, out))
            if p.returncode:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise KernelBuildError("nvcc failed on %s:\n%s" % (failed, log))
        lib_tmp = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp] + [o for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode:
            raise KernelBuildError("nvcc link failed:\n%s"
                                   % link.stdout.decode(errors="replace"))
        with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
            f.write(log)
        os.replace(lib_tmp, os.path.join(out_dir, LIB_NAME))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_dir():
    return os.path.join(BUILD_ROOT, _key())


def load():
    """The kernels' ctypes library, built first if this checkout's sources
    have not been built yet."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out_dir = library_dir()
    path = os.path.join(out_dir, LIB_NAME)
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        # processes starting together (the serving fleet's replicas)
        # build once: the first holds the lock and compiles, the others
        # wait for it and then load its library
        with open(os.path.join(out_dir, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(path):
                t0 = time.perf_counter()
                _compile(out_dir)
                build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def check(rc, what):
    """Raise KernelLaunchError when a C entry returned a CUDA error."""
    if rc != 0:
        msg = load().ptt_cuda_error_string(rc).decode(errors="replace")
        raise KernelLaunchError("%s failed: CUDA error %d (%s)"
                                % (what, rc, msg))


def count_config(kernel, config):
    """One launch of ``kernel`` under ``config`` (None: the default),
    tallied under ``(kernel, "knob=value,...")``, ``""`` the default."""
    tag = ",".join("%s=%s" % kv for kv in sorted((config or {}).items()))
    config_launches[(kernel, tag)] += 1
