"""Inference model save/load and the weight-carrying function.

Counterpart of paddle_tpu/io.py's inference-model half. The on-disk
format is the JAX package's ``"default"`` one: ``<dir>/__model__.json``
(format_version 2: the pruned Program, feed and fetch names and a
``param_manifest`` {name: {shape, dtype}}) beside ``<dir>/params.npz``.
A model directory written by either package loads in the other.

A bfloat16 persistable (numpy has no bfloat16) is written as its uint16
bit pattern, under ``"dtype": "bfloat16"`` in the manifest, and read back
as ``torch.bfloat16``; the JAX package's own bf16 save (numpy's opaque
``void16``, which its loader refuses) is read the same way, as bf16 bits.

``set_params_from_numpy`` carries weights into the port: it takes the
``{name: np.ndarray}`` dict that ``params.npz`` or a JAX scope yields and
places each array in a port Scope as a torch tensor, after checking it
against the program's variable of that name. For a training program
that is every persistable: the parameters, the optimizer's accumulators
(Adam's moments and beta powers, named as the JAX package names them) and
``learning_rate``.

Training state (the other half of paddle_tpu/io.py):

- ``save_params``/``save_persistables``/``load_params``/
  ``load_persistables`` (:92-133) write and read one ``params.npz`` of
  the program's parameters, or of its persistables but those whose name
  begins with ``@`` (so ``@LR_DECAY_COUNTER@`` does not travel, as in the
  reference). A bf16 value is stored as its uint16 bits and decoded
  through the program variable's dtype, which also reads the JAX
  package's ``void16``. ``load_persistables`` checks no shape, as the
  reference does: the Executor keys a captured step on each state
  tensor's shape, so a loaded shape change is a new key.
- ``save_checkpoint``/``load_checkpoint``/``scrub_checkpoint``
  (:406-1094): the whole scope, snapshotted on the host before
  ``save_checkpoint`` returns, in the reference's layout (``step_N/
  shards_p0.npz`` members ``name##full`` with ``/`` as ``#SL#``,
  ``manifest.json`` format 1, or 2 for ``compress="q8"``, the ``latest``
  pointer), so a checkpoint written by either package restores in the
  other; ``compress=None | "zlib" | "q8"`` (ops/quant_ops.py; zlib
  members deflate with Huffman coding only, on 8 threads); the
  reference's resilience (a torn step dir quarantined as
  ``step_N.corrupt`` and the newest valid one restored, a stale
  ``latest`` repaired, retention counting scrub-valid dirs only, a
  caller-side error or a newer format never quarantined); and
  ``blocking=False``, one commit in flight whose failure is raised once.
  A bf16 value is stored as uint16 bits under ``"dtype": "bfloat16"``;
  the port reads those and the JAX package's ``void16`` bit for bit (the
  JAX package's ``_stitch`` value-casts either encoding: ROADMAP.md
  Queue 3). The port's run counter ``@EAGER_SALT@`` (a Python int, the
  seed of every random draw) is written as a 0-d int64 and comes back as
  a Python int from a checkpoint the port wrote (manifest ``"writer"``);
  the counter in a JAX package's checkpoint counts that package's eager
  runs, so the port ignores it and the scope keeps its own. The commit
  carries the reference's fault hooks (:580-615): the
  ``io.member_write`` and ``io.manifest_write`` failpoints, the
  ``ckpt_write`` injection point between the shards and the manifest,
  and ``record_bytes("ckpt", raw, wire)``; ``scrub_checkpoint`` records
  a ``scrub`` event and a quarantine a ``ckpt_quarantine`` event
  (:894, :921). Its multi-host barriers and ``shardings=``
  (NotPortedError) come with the multi-GPU slice.
- The buddy tier's state blobs (:314-400): ``encode_state_blob`` /
  ``decode_state_blob`` over the same payload codec (the zlib members
  deflated on 8 threads, still a valid npz), ``leaf_digest``,
  ``leaf_digests`` and ``state_digest``; bfloat16 travels as uint16
  bits, and an f32 blob or digest of either package equals the other's.
"""
import io
import json
import logging
import os
import shutil
import struct
import tempfile
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .framework import faultinject, resilience
from .framework.dtypes import normalize_dtype, to_torch_dtype
from .framework.executor import _SALT_VAR
from .framework.place import resolve_device
from .framework.program import Parameter, Program, default_main_program
from .framework.scope import global_scope, to_numpy
from .ops import quant_ops
from .ops.registry import NotPortedError

PARAMS_FILE = "params.npz"
MODEL_FILE = "__model__.json"
INFERENCE_FORMAT_VERSION = 2


def _fsync_dir(dirname):
    """Flush a directory entry after a rename (best effort: a platform
    that cannot fsync a directory keeps the rename's atomicity only)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, write):
    """Write through a temp file in the same directory, fsync it, rename
    it into place and fsync the directory."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write_text(path, text):
    _atomic_write(path, lambda f: f.write(text.encode()))


def _write_npz(path, arrays, compressed=False):
    """``arrays`` as an npz file at ``path``: np.savez's, or with
    ``compressed`` the members deflated on _IO_THREADS threads
    (``_write_deflated_zip``), which np.load reads as it reads
    np.savez_compressed's."""
    _atomic_write(path, lambda f: _write_deflated_zip(f, arrays)
                  if compressed else np.savez(f, **arrays))


# host threads that deflate a compressed checkpoint's members and read a
# checkpoint's members back; a member is deflated in _DEFLATE_CHUNK-byte
# pieces, each its own stream ended by a sync flush (the last by the
# end of the stream), so that their concatenation is one deflate stream
_IO_THREADS = max(1, min(8, os.cpu_count() or 1))
_DEFLATE_CHUNK = 1 << 24


def _deflate(piece, last):
    # Huffman coding only: float bits hold few repeated strings, so
    # deflate's string matching (zlib's default level) buys ~nothing at
    # ~3x the time; any deflate stream inflates to the same bytes
    c = zlib.compressobj(1, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    return c.compress(piece) + c.flush(zlib.Z_FINISH if last
                                       else zlib.Z_SYNC_FLUSH)


def _write_deflated_zip(f, arrays):
    """A zip64 archive of ``{name}.npy`` members (np.save's bytes),
    deflated (``_deflate``) as np.savez_compressed writes, but with each
    member's pieces compressed in parallel."""
    members = []
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for name, arr in arrays.items():
            arr = np.asarray(arr, order="C")     # keeps a 0-d array 0-d
            head = io.BytesIO()
            np.lib.format.write_array_header_1_0(
                head, np.lib.format.header_data_from_array_1_0(arr))
            data = memoryview(arr.reshape(-1).view(np.uint8))
            pieces = [head.getvalue()] + [
                data[i:i + _DEFLATE_CHUNK]
                for i in range(0, len(data), _DEFLATE_CHUNK)]
            jobs = [pool.submit(_deflate, piece, i == len(pieces) - 1)
                    for i, piece in enumerate(pieces)]
            crc = zlib.crc32(data, zlib.crc32(pieces[0]))
            members.append(((name + ".npy").encode(), crc,
                            len(pieces[0]) + len(data), jobs))
        central, offset = [], f.tell()
        for fname, crc, size, jobs in members:
            outs = [job.result() for job in jobs]
            packed = sum(len(out) for out in outs)
            # zip64 sizes (and offset) always, as np.savez forces them;
            # bit 11 of the flags: a UTF-8 name
            flags = 0x800 if max(fname, default=0) > 127 else 0
            f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, flags, 8,
                                0, 0x21, crc, 0xFFFFFFFF, 0xFFFFFFFF,
                                len(fname), 20) + fname +
                    struct.pack("<HHQQ", 1, 16, size, packed))
            for out in outs:
                f.write(out)
            central.append(struct.pack(
                "<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, flags, 8, 0,
                0x21, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(fname), 28, 0, 0, 0,
                0, 0xFFFFFFFF) + fname + struct.pack(
                    "<HHQQQ", 1, 24, size, packed, offset))
            offset = f.tell()
    for entry in central:
        f.write(entry)
    end = f.tell()
    n = len(central)
    f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n, n,
                        end - offset, offset))
    f.write(struct.pack("<IIQI", 0x07064B50, 0, end, 1))
    f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF),
                        min(n, 0xFFFF), 0xFFFFFFFF, 0xFFFFFFFF, 0))


_BF16 = "bfloat16"


def _bf16_bits(t):
    """A bfloat16 tensor's bit pattern as a uint16 numpy array."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _is_bits(arr):
    """A uint16 or void16 array: what bfloat16 values are stored as."""
    return arr.dtype.itemsize == 2 and arr.dtype.kind in "uV"


def _from_bf16_bits(arr):
    """The bfloat16 tensor whose bits a uint16 or void16 array holds."""
    bits = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _host_array(val):
    """(a host copy of a scope value as numpy, its dtype name): a
    bfloat16 tensor as its uint16 bits under "bfloat16", a Python number
    as a 0-d array."""
    if not isinstance(val, torch.Tensor):
        arr = np.array(val)
        return arr, arr.dtype.name
    if val.dtype == torch.bfloat16:
        return _bf16_bits(val).copy(), _BF16
    arr = val.detach().to("cpu", copy=True).numpy()
    return arr, arr.dtype.name


def _decode(arr, dtype):
    """A CPU tensor of the stored ``arr`` declared as ``dtype`` (a dtype
    name): bfloat16 from uint16 or void16 bits, an int32 array (a JAX
    scope's int64 counter) widened to a declared int64, anything else as
    stored."""
    if dtype == _BF16 and _is_bits(arr):
        return _from_bf16_bits(arr)
    # ``arr`` was read from a file: the tensor may share its memory
    return _widened(torch.from_numpy(np.asarray(arr, order="C")), dtype)


def _widened(t, dtype):
    """``t``, an int32 one (a JAX scope's int64 counter) widened to a
    declared int64."""
    return t.long() if dtype == "int64" and t.dtype == torch.int32 else t


def _persistable_arrays(program, scope, keep=lambda var: var.persistable):
    """({name: numpy array}, {name: dtype name}) of the variables of
    ``program`` that ``keep`` selects and ``scope`` holds; a bfloat16 one
    as its uint16 bits."""
    out, dtypes = {}, {}
    for var in program.list_vars():
        if not keep(var):
            continue
        val = scope.find_var(var.name)
        if val is None:
            continue
        out[var.name], dtypes[var.name] = _host_array(val)
    return out, dtypes


def _device_of(executor):
    """The torch device of ``executor``'s place (CUDAPlace(0) without an
    executor)."""
    return resolve_device(executor.place if executor is not None else None)


def save_params(executor, dirname, main_program=None, filename=None):
    """The global scope's values of ``main_program``'s parameters into
    ``<dirname>/<filename or params.npz>``."""
    program = main_program or default_main_program()
    arrays, _ = _persistable_arrays(
        program, global_scope(), lambda v: isinstance(v, Parameter))
    _write_npz(os.path.join(dirname, filename or PARAMS_FILE), arrays)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """As ``save_params``, for every persistable whose name does not begin
    with ``@`` (the reference's rule: step counters stay behind)."""
    program = main_program or default_main_program()
    arrays, _ = _persistable_arrays(
        program, global_scope(),
        lambda v: v.persistable and not v.name.startswith("@"))
    _write_npz(os.path.join(dirname, filename or PARAMS_FILE), arrays)


def load_params(executor, dirname, main_program=None, filename=None):
    """Every parameter of ``main_program`` from the file into the global
    scope, on ``executor``'s place; a parameter missing from the file
    raises ValueError before anything is written."""
    device = _device_of(executor)
    program = main_program or default_main_program()
    arrays = _load_arrays(dirname, filename)
    params = [v for v in program.list_vars() if isinstance(v, Parameter)]
    for var in params:
        if var.name not in arrays:
            raise ValueError("parameter %r missing from checkpoint %s"
                             % (var.name, dirname))
    _set_decoded(global_scope(), arrays, params, device)


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Each persistable of ``main_program`` that the file holds into the
    global scope, on ``executor``'s place, at the shape stored."""
    device = _device_of(executor)
    program = main_program or default_main_program()
    arrays = _load_arrays(dirname, filename)
    _set_decoded(global_scope(), arrays,
                 [v for v in program.list_vars()
                  if v.persistable and v.name in arrays], device)


def _set_decoded(scope, arrays, variables, device):
    for var in variables:
        scope.set_var(var.name, _decode(arrays[var.name], var.dtype).to(
            device))


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, format="default",
                         batch_sizes=(1, 8, 32), example_feed=None,
                         feed_batch_factors=None, weight_compress=None):
    """Freeze: clone for_test, prune to feeds/targets, save IR + params.

    ``format="stablehlo"`` (the JAX package's name, kept for API parity)
    also writes the deployable serving artifact under dirname/serving/:
    one ``torch.export`` program per batch bucket in ``batch_sizes``,
    exported on ``executor``'s place, with the weights beside them (see
    serving.export_serving_artifact; load with
    ``serving.load_serving_artifact``). ``weight_compress="q8"`` ships
    those weights block-quantized; ``example_feed`` and
    ``feed_batch_factors`` say which feeds scale as a multiple of the
    batch. ``export_for_deployment`` is accepted and changes nothing, as
    in the JAX package."""
    if format not in ("default", "stablehlo"):
        # validate before writing anything: a mistyped format must not
        # leave a half-configured artifact directory behind
        raise ValueError("save_inference_model format must be 'default' "
                         "or 'stablehlo', got %r" % (format,))
    if format == "stablehlo" and not batch_sizes:
        raise ValueError("format='stablehlo' needs at least one "
                         "batch_sizes entry")
    program = main_program or default_main_program()
    target_names = [v.name for v in target_vars]
    pruned = program.clone(for_test=True)._prune(list(feeded_var_names),
                                                  target_names)
    arrays, dtypes = ({}, {}) if program_only else \
        _persistable_arrays(pruned, global_scope())
    manifest = {name: {"shape": list(arr.shape), "dtype": dtypes[name]}
                for name, arr in arrays.items()}
    meta = {"format_version": INFERENCE_FORMAT_VERSION,
            "program": pruned.to_dict(),
            "feed_var_names": list(feeded_var_names),
            "fetch_var_names": target_names,
            "param_manifest": manifest}
    _write_text(os.path.join(dirname, model_filename or MODEL_FILE),
                json.dumps(meta))
    if not program_only:
        _write_npz(os.path.join(dirname, params_filename or PARAMS_FILE),
                   arrays)
    if format == "stablehlo":
        from .serving import export_serving_artifact
        export_serving_artifact(dirname, feeded_var_names, target_vars,
                                executor, batch_sizes=batch_sizes,
                                pruned_program=pruned,
                                example_feed=example_feed,
                                feed_batch_factors=feed_batch_factors,
                                weight_compress=weight_compress)
    return target_names


def set_params_from_numpy(arrays, program, scope=None, place=None):
    """Put ``arrays`` ({name: np.ndarray or torch.Tensor}) into ``scope``
    (default: the global scope) as torch tensors on ``place`` (default:
    CUDAPlace(0)).

    Every name must be a persistable variable of ``program`` and every
    persistable variable of ``program`` must be given; each array's shape
    and dtype must equal the variable's (a -1 dim matches any size), but
    an int32 array fills an int64 variable (a JAX scope without 64-bit
    mode holds a schedule's int64 step counter as int32). Raises
    ValueError naming the first variable that breaks this, before
    anything is written."""
    scope = scope if scope is not None else global_scope()
    device = resolve_device(place)
    wanted = {v.name: v for v in program.list_vars() if v.persistable}
    unknown = sorted(set(arrays) - set(wanted))
    if unknown:
        raise ValueError("arrays %s are not persistable variables of the "
                         "program" % unknown)
    missing = sorted(set(wanted) - set(arrays))
    if missing:
        raise ValueError("persistable variables %s of the program have no "
                         "array" % missing)
    for name in sorted(arrays):
        arr, var = arrays[name], wanted[name]
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        shape = tuple(arr.shape)
        if var.shape is not None and (
                len(var.shape) != len(shape) or
                any(w not in (-1, g) for w, g in zip(var.shape, shape))):
            raise ValueError("variable %r has shape %s in the program but "
                             "the array has shape %s"
                             % (name, list(var.shape), list(shape)))
        dtype = normalize_dtype(arr.dtype)
        if dtype != var.dtype and (dtype, var.dtype) != ("int32", "int64"):
            raise ValueError("variable %r has dtype %s in the program but "
                             "the array has dtype %s"
                             % (name, var.dtype, dtype))
    for name in sorted(arrays):
        scope.set_var(name, _to_tensor(arrays[name]).to(
            device=device, dtype=to_torch_dtype(wanted[name].dtype)))


def _to_tensor(arr):
    # a copy: the arrays may be read-only views (a JAX scope's), and a JAX
    # scope's bfloat16 arrays are ml_dtypes', which torch reads as int16
    if isinstance(arr, torch.Tensor):
        return arr.detach().clone()
    arr = np.asarray(arr)
    if arr.dtype.name == _BF16:
        return _from_bf16_bits(arr)
    return torch.from_numpy(np.array(arr, order="C"))


def _load_arrays(dirname, filename):
    path = os.path.join(dirname, filename or PARAMS_FILE)
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a model directory into the global scope on the executor's
    place. Returns (program, feed names, fetch names)."""
    model_path = os.path.join(dirname, model_filename or MODEL_FILE)
    if not os.path.exists(model_path):
        raise ValueError("inference model file %r does not exist"
                         % model_path)
    with open(model_path) as f:
        meta = json.load(f)
    version = meta.get("format_version", 1)   # v1 artifacts predate the key
    if version > INFERENCE_FORMAT_VERSION:
        raise ValueError(
            "inference model %s has format_version %d, newer than this "
            "library's %d — upgrade paddle_tpu_torch to load it"
            % (dirname, version, INFERENCE_FORMAT_VERSION))
    program = Program.from_dict(meta["program"])
    arrays = _load_arrays(dirname, params_filename)
    manifest = meta.get("param_manifest") or {}
    if manifest:
        missing = sorted(set(manifest) - set(arrays))
        if missing:
            raise ValueError(
                "inference model %s: params file is missing variables %s "
                "declared in the manifest" % (dirname, missing))
        for name, spec in manifest.items():
            arr = arrays[name]
            if list(arr.shape) != list(spec["shape"]):
                raise ValueError(
                    "inference model %s: variable %r has shape %s on disk "
                    "but the manifest declares %s"
                    % (dirname, name, list(arr.shape), spec["shape"]))
            if spec["dtype"] == _BF16 and _is_bits(arr):
                # bf16 bits: the port's uint16, the JAX package's void16
                arrays[name] = _from_bf16_bits(arr)
            elif arr.dtype.name != spec["dtype"]:
                raise ValueError(
                    "inference model %s: variable %r has dtype %s on disk "
                    "but the manifest declares %s"
                    % (dirname, name, arr.dtype.name, spec["dtype"]))
    set_params_from_numpy(arrays, program, global_scope(), executor.place)
    return program, meta["feed_var_names"], meta["fetch_var_names"]


# ---------------------------------------------------------------------------
# checkpoints: the whole scope, in the JAX package's on-disk layout
# ---------------------------------------------------------------------------

# Format history (the reference's): 0, a legacy step dir holding one
# params.npz; 1, shards + manifest.json (also when compress="zlib": the
# npz layout is unchanged); 2, compress="q8" (lossy int8 members with
# ##q8* companions, stamped so that an older library refuses them).
CKPT_FORMAT_VERSION = 2
MANIFEST_FILE = "manifest.json"
# the manifest's "writer": a checkpoint whose @EAGER_SALT@ is the port's
CKPT_WRITER = "paddle_tpu_torch"
_Q8_SCALE = "##q8s"
_Q8_SHAPE = "##q8n"
_Q8_DTYPE = "##q8t"
_LOG = logging.getLogger(__name__)


class CheckpointFormatError(RuntimeError):
    """The checkpoint on disk is valid but was written by a newer
    library. Not an OSError/ValueError, so that load_checkpoint never
    quarantines a healthy checkpoint for it."""


def _encode_payload(own, compress, block_size=quant_ops.DEFAULT_BLOCK_SIZE):
    """A {key: array} shard payload for ``compress``: only "q8" changes
    anything, turning float32/float64 arrays of at least one block into
    int8 blocks with scale, shape and dtype companions."""
    if compress != "q8":
        return own
    out = {}
    for key, arr in own.items():
        if arr.dtype in (np.float32, np.float64) and arr.size >= block_size:
            q, scale = quant_ops.np_block_quantize(arr, block_size)
            out[key] = q
            out[key + _Q8_SCALE] = scale
            out[key + _Q8_SHAPE] = np.asarray(arr.shape, np.int64)
            out[key + _Q8_DTYPE] = np.asarray(arr.dtype.str)
        else:
            out[key] = arr
    return out


def _decode_member(z, key):
    """One member of ``z`` (an open npz or a payload dict), dequantized if
    it is a q8 one (its ##q8s companion is the marker)."""
    arr = z[key]
    if key + _Q8_SCALE in z:
        return quant_ops.np_block_dequantize(
            arr, z[key + _Q8_SCALE],
            tuple(int(d) for d in z[key + _Q8_SHAPE]),
            np.dtype(str(z[key + _Q8_DTYPE])))
    return arr


def encode_state_blob(arrays, step, compress="zlib", feed_state=None,
                      text=True):
    """One JSON-able blob of a ``{name: value}`` state snapshot in the
    checkpoint's payload codec (:func:`_encode_payload`, the same npz
    member layout and q8 companions), as the buddy tier moves it:
    ``compress`` None (plain npz), "zlib" (lossless deflate, Huffman
    coding only, on _IO_THREADS threads) or "q8" (lossy int8 blocks).
    Values go through
    ``_host_array``: a bfloat16 tensor travels as its uint16 bits, a
    Python number as a 0-d array. Returns ``(blob, raw_bytes,
    wire_bytes)``. ``text=True``: the npz bytes ride base64, JSON-safe,
    and a blob of either package decodes in the other; ``text=False``
    keeps them as bytes, for a blob that never leaves the process (the
    buddy mailboxes of the in-process coordinators: base64 costs a
    GIL-held pass each way)."""
    import base64
    if compress not in (None, "zlib", "q8"):
        raise ValueError("encode_state_blob compress must be None, "
                         "'zlib' or 'q8', got %r" % (compress,))
    own, names = {}, {}
    for name, val in sorted(arrays.items()):
        safe = name.replace("/", "#SL#")
        names[safe] = name
        own[safe] = val if isinstance(val, np.ndarray) \
            else _host_array(val)[0]
    raw = sum(int(a.nbytes) for a in own.values())
    buf = io.BytesIO()
    payload = _encode_payload(own, compress)
    if compress is None:
        np.savez(buf, **payload)
    else:
        _write_deflated_zip(buf, payload)
    data = buf.getvalue()
    blob = {"v": 1, "step": int(step), "names": names,
            "npz": base64.b64encode(data).decode("ascii") if text
            else data}
    if compress is not None:
        blob["compress"] = compress
    if feed_state is not None:
        blob["feed_state"] = feed_state
    return blob, raw, len(data)


def decode_state_blob(blob):
    """Inverse of :func:`encode_state_blob` (base64 text or bytes):
    ``(arrays, step, feed_state)``, numpy arrays with q8 members
    dequantized (bfloat16 values as their uint16 bits). A torn blob
    raises (ValueError, KeyError, zipfile errors)."""
    import base64
    data = blob["npz"]
    if not isinstance(data, bytes):
        data = base64.b64decode(data)
    names = blob.get("names", {})
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        keys = [k for k in z.files
                if not k.endswith((_Q8_SCALE, _Q8_SHAPE, _Q8_DTYPE))]
    out = {names.get(k, k): arr
           for k, arr in _read_members(data, keys).items()}
    return out, int(blob["step"]), blob.get("feed_state")


def leaf_digest(arr):
    """sha256 over one leaf's dtype, shape and C-order bytes (bit-exact:
    the buddy tier's delta skip test). Equal to the JAX package's for an
    equal numpy array."""
    import hashlib
    a = np.ascontiguousarray(arr if isinstance(arr, np.ndarray)
                             else _host_array(arr)[0])
    h = hashlib.sha256()
    h.update(str(a.dtype.str).encode("ascii"))
    h.update(repr(tuple(a.shape)).encode("ascii"))
    h.update(a.reshape(-1).view(np.uint8).data)
    return h.hexdigest()


def leaf_digests(arrays):
    """``{name: leaf_digest(value)}``, hashed on _IO_THREADS threads."""
    names = list(arrays)
    if len(names) < 2:
        return {n: leaf_digest(arrays[n]) for n in names}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        return dict(zip(names, pool.map(
            lambda n: leaf_digest(arrays[n]), names)))


def digest_of_leaves(digests):
    """The state digest of a ``{name: leaf_digest}`` map: sha256 over the
    sorted (name, leaf digest) pairs."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(digests):
        h.update(str(name).encode("utf-8"))
        h.update(b"\x00")
        h.update(digests[name].encode("ascii"))
    return h.hexdigest()


def state_digest(arrays):
    """Order-independent digest of a whole ``{name: value}`` state; the
    buddy tier publishes it and verifies every reconstruction against
    it. Equal to the JAX package's for equal numpy arrays."""
    return digest_of_leaves(leaf_digests(arrays))


class AsyncCheckpoint(object):
    """A ``save_checkpoint(..., blocking=False)`` in flight: ``result()``
    joins its writer thread and raises its failure."""

    def __init__(self, thread, box):
        self._thread = thread
        self._box = box

    def done(self):
        return not self._thread.is_alive()

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint commit still in flight")
        if self._box.get("error") is not None:
            raise self._box["error"]


_pending_save = [None]   # at most one asynchronous commit in flight
_atexit_registered = [False]


def wait_for_pending_saves():
    """Block until a previous ``blocking=False`` checkpoint has committed;
    its failure is raised here, once."""
    h = _pending_save[0]
    if h is not None:
        _pending_save[0] = None      # raise once, not at every later call
        h.result()


def save_checkpoint(executor, dirname, main_program=None, step=None,
                    keep_last=3, blocking=True, scope=None,
                    feed_state=None, compress=None):
    """Checkpoint every value of ``scope`` (default the global scope) into
    ``<dirname>/step_<step>``, then point ``latest`` at it and keep the
    newest ``keep_last`` valid step dirs (``keep_last <= 0`` prunes
    nothing).

    Every value is copied to the host before this returns, on the
    caller's stream, so after ``Executor.run`` (which ends with the
    caller's stream waiting for its own) it holds the finished step, and
    a later replay that updates the scope's tensors in place changes
    nothing written. ``compress``: None (plain npz), "zlib" (lossless
    deflate, still format 1) or "q8" (lossy int8 blocks of float32/float64
    arrays, format 2). ``feed_state``: a JSON-able dataset cursor kept in
    the manifest. ``blocking=False``: the files are written and committed
    on a thread and an ``AsyncCheckpoint`` is returned; the next save or
    load (or ``wait_for_pending_saves``) joins it first."""
    if compress not in (None, "zlib", "q8"):
        raise ValueError("save_checkpoint compress must be None, 'zlib' "
                         "or 'q8', got %r" % (compress,))
    scope = scope if scope is not None else global_scope()
    step_no = int(step if step is not None else 0)
    step_dir = "step_%d" % step_no
    full_dir = os.path.join(dirname, step_dir)
    wait_for_pending_saves()
    own, manifest_vars = {}, {}
    for name, val in sorted(scope.items()):
        if val is None:
            continue
        # the member key comes from the name, never from a counter
        key = "%s##full" % name.replace("/", "#SL#")
        own[key], dtype = _host_array(val)
        shape = list(own[key].shape)
        manifest_vars[name] = {
            "shape": shape, "dtype": dtype,
            "shards": [{"offsets": [[0, d] for d in shape],
                        "file": "shards_p0.npz", "key": key}]}

    def commit():
        raw_bytes = sum(int(a.nbytes) for a in own.values())
        shard_path = os.path.join(full_dir, "shards_p0.npz")
        faultinject.hit("io.member_write", host=0)
        _write_npz(shard_path, _encode_payload(own, compress),
                   compressed=compress is not None)
        resilience.record_bytes("ckpt", raw_bytes,
                                os.path.getsize(shard_path))
        # an I/O fault here (shards written, no manifest) is a torn step
        # dir that load_checkpoint quarantines, never restores from
        resilience.fire("ckpt_write", what=step_dir)
        manifest = {"format_version": 2 if compress == "q8" else 1,
                    "step": step_no, "process_count": 1,
                    "vars": manifest_vars, "writer": CKPT_WRITER}
        if compress is not None:
            manifest["compress"] = compress
        if feed_state is not None:
            manifest["feed_state"] = feed_state
        # the manifest is the commit record: the shards are durable first
        faultinject.hit("io.manifest_write", host=0)
        _write_text(os.path.join(full_dir, MANIFEST_FILE),
                    json.dumps(manifest))
        _write_text(os.path.join(dirname, "latest"), step_dir)
        _prune_step_dirs(dirname, keep_last)

    if blocking:
        commit()
        return None
    box = {"error": None}

    def runner():
        try:
            commit()
        except BaseException as e:
            box["error"] = e

    if not _atexit_registered[0]:
        # the last asynchronous checkpoint is not cut off at exit
        import atexit
        atexit.register(wait_for_pending_saves)
        _atexit_registered[0] = True
    th = threading.Thread(target=runner, name="ckpt-commit-%d" % step_no,
                          daemon=True)
    th.start()
    handle = _pending_save[0] = AsyncCheckpoint(th, box)
    return handle


def _step_dirs(dirname, skip=None):
    """The ``step_N`` dir names of ``dirname``, newest first."""
    return sorted((d for d in os.listdir(dirname)
                   if d.startswith("step_") and d != skip
                   and d.split("_", 1)[1].isdigit()),
                  key=_step_no, reverse=True)


def _step_no(step_dir):
    return int(step_dir.split("_")[1])


# serializes retention (possibly on a commit thread) against a scrub, so
# that no step dir a scrub calls valid is pruned while it runs
_RETENTION_LOCK = threading.Lock()


def _prune_step_dirs(dirname, keep_last):
    """Keep the newest ``keep_last`` scrub-valid step dirs and everything
    newer than the last of them (a torn dir there may be a commit still
    in flight); prune everything older. Quarantined dirs never match."""
    if keep_last <= 0:
        return
    with _RETENTION_LOCK:
        seen_valid = 0
        for d in _step_dirs(dirname):
            if seen_valid >= keep_last:
                shutil.rmtree(os.path.join(dirname, d), ignore_errors=True)
            elif _classify_step_dir(dirname, d)[0] == "valid":
                seen_valid += 1


def _stitch(meta, readers, name):
    """A var's whole value from its stored shards, in its storage dtype
    (bfloat16 as uint16 bits, which numpy can hold). Raises if the shards
    do not cover it: a torn manifest is an error, never garbage."""
    req = [[0, d] for d in meta["shape"]]
    bf16 = meta["dtype"] == _BF16
    if len(meta["shards"]) == 1 and meta["shards"][0]["offsets"] == req:
        sh = meta["shards"][0]           # one whole shard: no copy
        data = readers(sh["file"], sh["key"])
        if list(data.shape) == meta["shape"]:
            return data.view(np.uint16) if bf16 and _is_bits(data) \
                else data
    out = np.empty([b - a for a, b in req],
                   np.uint16 if bf16 else np.dtype(meta["dtype"]))
    want = int(np.prod([b - a for a, b in req])) if req else 1
    covered = 0
    for sh in meta["shards"]:
        offs = sh["offsets"]
        inter = [(max(a, ra), min(b, rb))
                 for (a, b), (ra, rb) in zip(offs, req)]
        if any(a >= b for a, b in inter):
            continue
        data = readers(sh["file"], sh["key"])
        if bf16 and _is_bits(data):
            data = data.view(np.uint16)
        src = tuple(slice(a - oa, b - oa)
                    for (a, b), (oa, _) in zip(inter, offs))
        dst = tuple(slice(a - ra, b - ra)
                    for (a, b), (ra, _) in zip(inter, req))
        out[dst] = data[src]
        covered += int(np.prod([b - a for a, b in inter])) if inter else 1
    if covered < want:
        raise ValueError(
            "checkpoint shards for %r cover only %d of %d elements: the "
            "manifest is torn or truncated" % (name, covered, want))
    return out


def _classify_step_dir(dirname, step_dir):
    """("valid" | "corrupt" | "incomplete", reason) of one step dir, from
    its manifest and the npz member lists alone (no payload is read). A
    healthy dir of a newer format is "valid" with a reason."""
    full_dir = os.path.join(dirname, step_dir)
    manifest_path = os.path.join(full_dir, MANIFEST_FILE)
    if not os.path.isdir(full_dir):
        return "incomplete", "step dir is missing"
    if not os.path.exists(manifest_path):
        legacy = os.path.join(full_dir, PARAMS_FILE)
        if os.path.exists(legacy):
            try:   # format 0: opening reads only the zip directory
                with np.load(legacy, allow_pickle=False) as z:
                    z.files
                return "valid", None
            except Exception as e:
                return "corrupt", "unreadable legacy params file: %s" % e
        try:
            kids = os.listdir(full_dir)
        except OSError as e:
            return "corrupt", "unreadable step dir: %s" % e
        if any(k.startswith("shards_p") for k in kids):
            return ("incomplete", "shard files present but no manifest: "
                    "the commit never landed")
        return "incomplete", "no manifest or shard files"
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("format_version", 0) > CKPT_FORMAT_VERSION:
            return "valid", ("format_version %s newer than supported %d"
                             % (manifest.get("format_version"),
                                CKPT_FORMAT_VERSION))
        needed = {}
        for meta in manifest["vars"].values():
            for sh in meta["shards"]:
                needed.setdefault(sh["file"], set()).add(sh["key"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        return "corrupt", "torn or malformed manifest: %s" % e
    for fname, keys in needed.items():
        try:
            with np.load(os.path.join(full_dir, fname),
                         allow_pickle=False) as z:
                missing = keys.difference(z.files)
        except Exception as e:
            return "corrupt", "unreadable shard file %s: %s" % (fname, e)
        if missing:
            return "corrupt", "shard file %s is missing keys %s" % (
                fname, sorted(missing))
    return "valid", None


def _scrub_step_dir(dirname, step_dir):
    """What is damaged on disk in a step dir, or None if nothing is (then
    a failed load was the caller's and nothing is quarantined)."""
    status, reason = _classify_step_dir(dirname, step_dir)
    return None if status == "valid" else (reason or status)


def scrub_checkpoint(dirname):
    """Classify every ``step_N`` dir of ``dirname`` as valid, corrupt or
    incomplete from manifests and npz member lists, without reading a
    payload or changing anything. Returns ``{"dirname", "latest": the
    pointer's target or None, "steps": {N: {"dir", "status", "reason"}},
    "valid_steps": sorted steps this library can restore, "quarantined":
    the step_N.corrupt dirs}``; ``load_checkpoint`` uses the same
    classifier."""
    report = {"dirname": dirname, "latest": None, "steps": {},
              "valid_steps": [], "quarantined": []}
    try:
        kids = sorted(os.listdir(dirname))
    except OSError:
        return report
    try:
        with open(os.path.join(dirname, "latest")) as f:
            report["latest"] = f.read().strip() or None
    except OSError:
        pass
    with _RETENTION_LOCK:
        for d in kids:
            if not d.startswith("step_"):
                continue
            if ".corrupt" in d:
                report["quarantined"].append(d)
                continue
            if not d.split("_", 1)[1].isdigit():
                continue
            status, reason = _classify_step_dir(dirname, d)
            report["steps"][_step_no(d)] = {"dir": d, "status": status,
                                            "reason": reason}
            if status == "valid" and reason is None:
                # a valid dir with a reason is of a newer format
                report["valid_steps"].append(_step_no(d))
    report["valid_steps"].sort()
    statuses = [st["status"] for st in report["steps"].values()]
    resilience.record_event("scrub", dirname=dirname,
                            valid=statuses.count("valid"),
                            corrupt=statuses.count("corrupt"),
                            incomplete=statuses.count("incomplete"))
    return report


def _quarantine_step_dir(dirname, step_dir, reason):
    """Rename a corrupt step dir to step_N.corrupt (the first free
    suffix): never restored again, kept for inspection."""
    src = os.path.join(dirname, step_dir)
    dst = src + ".corrupt"
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = "%s.corrupt.%d" % (src, i)
    try:
        os.rename(src, dst)
    except OSError:
        return
    _LOG.warning("checkpoint %s is corrupt (%s): quarantined as %s", src,
                 reason, os.path.basename(dst))
    resilience.record_event("ckpt_quarantine", step_dir=step_dir,
                            reason=str(reason))


def _load_step_dir(dirname, step_dir):
    """(step, {name: CPU tensor}, feed_state, writer) of one step dir, or
    a raise on any damage; nothing is written to a scope here."""
    full_dir = os.path.join(dirname, step_dir)
    manifest_path = os.path.join(full_dir, MANIFEST_FILE)
    if not os.path.exists(manifest_path):
        arrays = _load_arrays(full_dir, PARAMS_FILE)      # format 0
        return _step_no(step_dir), {
            name.replace("__AT__", "@"): _decode(arr, arr.dtype.name)
            for name, arr in arrays.items()}, None, None
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("format_version", 0) > CKPT_FORMAT_VERSION:
        raise CheckpointFormatError(
            "checkpoint %s has format_version %s, newer than this "
            "library's %d" % (full_dir, manifest.get("format_version"),
                              CKPT_FORMAT_VERSION))
    wanted = {}
    for meta in manifest["vars"].values():
        for sh in meta["shards"]:
            wanted.setdefault(sh["file"], set()).add(sh["key"])
    members = {}
    for fname, keys in wanted.items():
        for key, arr in _read_members(os.path.join(full_dir, fname),
                                      sorted(keys)).items():
            members[(fname, key)] = arr
    out = {name: _decode(_stitch(meta, lambda f, k: members[(f, k)], name),
                         meta["dtype"])
           for name, meta in manifest["vars"].items()}
    return (int(manifest["step"]), out, manifest.get("feed_state"),
            manifest.get("writer"))


def _read_members(path, keys):
    """{key: member} of one npz (a path, or its bytes; a q8 member
    dequantized), read on up to _IO_THREADS threads, each with its own
    handle (inflating a member releases the GIL)."""
    groups = [keys[i::_IO_THREADS] for i in range(_IO_THREADS)]

    def read(group):
        src = io.BytesIO(path) if isinstance(path, bytes) else path
        with np.load(src, allow_pickle=False) as z:
            return {k: _decode_member(z, k) for k in group}
    out = {}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for part in pool.map(read, [g for g in groups if g]):
            out.update(part)
    return out


def checkpoint_dir_bytes(dirname, step):
    """(raw, wire) bytes of a committed step dir: raw from the manifest's
    shapes and dtypes, wire the npz files' sizes on disk."""
    full_dir = os.path.join(dirname, "step_%d" % int(step))
    with open(os.path.join(full_dir, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    raw = 0
    for meta in manifest["vars"].values():
        size = int(np.prod(meta["shape"])) if meta["shape"] else 1
        raw += size * (2 if meta["dtype"] == _BF16
                       else np.dtype(meta["dtype"]).itemsize)
    wire = sum(os.path.getsize(os.path.join(full_dir, k))
               for k in os.listdir(full_dir) if k.endswith(".npz"))
    return raw, wire


def _restore(scope, out, writer, device, program):
    """Put a loaded step's values in ``scope`` on ``device``: the port's
    run counter as a Python int (only from a checkpoint the port wrote),
    an int32 value of a program's int64 variable widened."""
    salt = out.pop(_SALT_VAR, None)
    if salt is not None and writer == CKPT_WRITER:
        scope.set_var(_SALT_VAR, int(salt))
    block = program.global_block()
    for name, t in out.items():
        var = block._find_var_recursive(name)
        if var is not None:
            t = _widened(t, var.dtype)
        scope.set_var(name, t.to(device))


def load_checkpoint(executor, dirname, main_program=None, shardings=None,
                    step=None, scope=None, with_feed_state=False):
    """Restore the newest valid checkpoint of ``dirname`` into ``scope``
    (default the global scope), on ``executor``'s place; returns its step
    (``(step, feed_state)`` with ``with_feed_state``).

    ``step``: restore exactly that step, with no fallback. Otherwise a
    missing or stale ``latest`` pointer or a damaged step dir does not
    fail the restore: a damaged dir is quarantined (``step_N.corrupt``),
    the newest valid one is restored and ``latest`` is repaired; only
    when none is left is the first error raised. A failure on a dir that
    is healthy on disk is the caller's and is raised at once; a newer
    format raises CheckpointFormatError. ``main_program``: its int64
    variables take a stored int32 value widened. A restore into a live
    Executor replaces the scope's tensors; the next replay copies them
    into its static inputs. ``shardings`` belongs to the multi-GPU slice
    and raises NotPortedError."""
    if shardings:
        raise NotPortedError(
            "load_checkpoint(shardings=) places values on a device mesh; "
            "it arrives with the torch.distributed parallelism slice of "
            "paddle_tpu_torch")
    device = _device_of(executor)
    program = main_program or default_main_program()
    wait_for_pending_saves()
    scope = scope if scope is not None else global_scope()
    if step is not None:
        got, out, fs, writer = _load_step_dir(dirname, "step_%d" % int(step))
        _restore(scope, out, writer, device, program)
        return (got, fs) if with_feed_state else got
    latest = None
    try:
        with open(os.path.join(dirname, "latest")) as f:
            latest = f.read().strip() or None
    except OSError:
        _LOG.warning("checkpoint dir %s has no readable 'latest' pointer: "
                     "falling back to the newest step dir", dirname)
    others = _step_dirs(dirname, skip=latest)
    candidates = ([latest] if latest is not None else []) + others
    if latest is not None and not os.path.isdir(
            os.path.join(dirname, latest)):
        _LOG.warning("'latest' names missing checkpoint %s/%s: falling "
                     "back", dirname, latest)
        candidates = others
    first_err = None
    for step_dir in candidates:
        try:
            got, out, fs, writer = _load_step_dir(dirname, step_dir)
        except (OSError, ValueError, KeyError, IndexError) as e:
            reason = _scrub_step_dir(dirname, step_dir)
            if reason is None:
                raise            # healthy on disk: the caller's failure
            if first_err is None:
                first_err = e
            _quarantine_step_dir(dirname, step_dir, reason)
            continue
        _restore(scope, out, writer, device, program)
        if step_dir != latest:
            _write_text(os.path.join(dirname, "latest"), step_dir)
        return (got, fs) if with_feed_state else got
    if first_err is not None:
        raise first_err
    raise FileNotFoundError("no checkpoint found under %s" % dirname)


__all__ = ["save_inference_model", "load_inference_model",
           "set_params_from_numpy", "INFERENCE_FORMAT_VERSION",
           "save_params", "save_persistables", "load_params",
           "load_persistables", "save_checkpoint", "load_checkpoint",
           "scrub_checkpoint", "checkpoint_dir_bytes",
           "wait_for_pending_saves", "AsyncCheckpoint",
           "CheckpointFormatError", "CKPT_FORMAT_VERSION",
           "encode_state_blob", "decode_state_blob", "leaf_digest",
           "leaf_digests", "state_digest"]
