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
"""
import json
import os
import tempfile

import numpy as np
import torch

from .framework.dtypes import normalize_dtype
from .framework.place import resolve_device
from .framework.program import Program, default_main_program
from .framework.scope import global_scope, to_numpy
from .ops.registry import NotPortedError

PARAMS_FILE = "params.npz"
MODEL_FILE = "__model__.json"
INFERENCE_FORMAT_VERSION = 2


def _atomic_write(path, write):
    """Write through a temp file in the same directory, then rename."""
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
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_BF16 = "bfloat16"


def _bf16_bits(t):
    """A bfloat16 tensor's bit pattern as a uint16 numpy array."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def _from_bf16_bits(arr):
    """The bfloat16 tensor whose bits a uint16 or void16 array holds."""
    bits = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _persistable_arrays(program, scope):
    """({name: numpy array}, {name: dtype name}) of the program's
    persistables in ``scope``; a bfloat16 one as its uint16 bits."""
    out, dtypes = {}, {}
    for var in program.list_vars():
        if not var.persistable:
            continue
        val = scope.find_var(var.name)
        if val is None:
            continue
        if isinstance(val, torch.Tensor) and val.dtype == torch.bfloat16:
            out[var.name], dtypes[var.name] = _bf16_bits(val), _BF16
            continue
        out[var.name] = to_numpy(val) if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        dtypes[var.name] = out[var.name].dtype.name
    return out, dtypes


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, program_only=False,
                         format="default"):
    """Freeze: clone for_test, prune to feeds/targets, save IR + params.
    ``format="stablehlo"`` (the JAX package's compiled serving artifact)
    raises NotPortedError: its torch counterpart is a ``torch.export``
    artifact of the serving slice."""
    if format == "stablehlo":
        raise NotPortedError(
            "save_inference_model(format='stablehlo') writes a compiled "
            "serving artifact; its torch.export counterpart arrives with "
            "the serving slice of paddle_tpu_torch")
    if format != "default":
        raise ValueError("save_inference_model format must be 'default' "
                         "or 'stablehlo', got %r" % (format,))
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
    _atomic_write(os.path.join(dirname, model_filename or MODEL_FILE),
                  lambda f: f.write(json.dumps(meta).encode()))
    if not program_only:
        _atomic_write(os.path.join(dirname, params_filename or PARAMS_FILE),
                      lambda f: np.savez(f, **arrays))
    return target_names


def set_params_from_numpy(arrays, program, scope=None, place=None):
    """Put ``arrays`` ({name: np.ndarray or torch.Tensor}) into ``scope``
    (default: the global scope) as torch tensors on ``place`` (default:
    CUDAPlace(0)).

    Every name must be a persistable variable of ``program`` and every
    persistable variable of ``program`` must be given; each array's shape
    and dtype must equal the variable's (a -1 dim matches any size).
    Raises ValueError naming the first variable that breaks this, before
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
        if normalize_dtype(arr.dtype) != var.dtype:
            raise ValueError("variable %r has dtype %s in the program but "
                             "the array has dtype %s"
                             % (name, var.dtype, normalize_dtype(arr.dtype)))
    for name in sorted(arrays):
        scope.set_var(name, _to_tensor(arrays[name]).to(device))


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
            if spec["dtype"] == _BF16 and arr.dtype.itemsize == 2 and \
                    arr.dtype.kind in "uV":
                # bf16 bits: the port's uint16, the JAX package's void16
                arrays[name] = _from_bf16_bits(arr)
            elif arr.dtype.name != spec["dtype"]:
                raise ValueError(
                    "inference model %s: variable %r has dtype %s on disk "
                    "but the manifest declares %s"
                    % (dirname, name, arr.dtype.name, spec["dtype"]))
    set_params_from_numpy(arrays, program, global_scope(), executor.place)
    return program, meta["feed_var_names"], meta["fetch_var_names"]


__all__ = ["save_inference_model", "load_inference_model",
           "set_params_from_numpy", "INFERENCE_FORMAT_VERSION"]
