"""Post-training int8 weights (counterpart of paddle_tpu/contrib/
quantize.py; reference fluid/contrib/quantize and the slim passes' export
half): symmetric per-tensor abs-max int8 weights with a float scale
each, dequantized when the model is loaded, so the program runs in f32
as before.

``save_quantized_inference_model`` writes the program as
``save_inference_model`` does (pruned to the feeds and targets) and, in
``params.npz``, every Parameter of the program passed as an ``.int8``
member plus every other persistable of that program as stored (Adam's
moments, a quant-aware program's moving-average state, the learning
rate: the JAX package stores them, and so does the port), with the
scales in ``quant_scales.json``. A bfloat16 parameter is quantized by
its value (never its bit pattern); a bfloat16 persistable is stored as
its uint16 bits, as ``io`` stores it. A directory written by either
package loads in the other.
"""
import json
import os

import numpy as np
import torch

__all__ = ["quantize_weights_abs_max", "dequantize_weights",
           "save_quantized_inference_model",
           "load_quantized_inference_model"]

QUANT_SCALES_FILE = "quant_scales.json"


def quantize_weights_abs_max(arrays, bits=8):
    """arrays: {name: f32 numpy array} -> ({name: int8 array}, {name:
    scale}), symmetric per-tensor abs-max: scale = max|a| / qmax (1.0
    for an empty or all-zero array), levels clipped to [-qmax - 1,
    qmax]."""
    qmax = 2 ** (bits - 1) - 1
    q, scales = {}, {}
    for name, arr in arrays.items():
        a = np.asarray(arr, np.float32)
        s = float(np.max(np.abs(a))) / qmax if a.size else 1.0
        s = s if s > 0 else 1.0
        q[name] = np.clip(np.round(a / s), -qmax - 1, qmax).astype(np.int8)
        scales[name] = s
    return q, scales


def dequantize_weights(q, scales):
    return {name: q[name].astype(np.float32) * scales[name] for name in q}


def save_quantized_inference_model(dirname, feeded_var_names, target_vars,
                                   executor, main_program=None, bits=8):
    """``save_inference_model`` with int8 parameters and their scales (the
    global scope's values)."""
    from ..framework.program import Parameter, default_main_program
    from ..framework.scope import global_scope, to_numpy
    from ..io import (PARAMS_FILE, _persistable_arrays, _write_npz,
                      save_inference_model)
    program = main_program or default_main_program()
    save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=program, program_only=True)
    scope = global_scope()
    values = {v.name: to_numpy(scope.find_var(v.name))
              for v in program.list_vars()
              if isinstance(v, Parameter) and
              scope.find_var(v.name) is not None}
    others, _ = _persistable_arrays(
        program, scope,
        lambda v: v.persistable and not isinstance(v, Parameter))
    q, scales = quantize_weights_abs_max(values, bits)
    blob = dict(others)
    for name in q:
        blob[name + ".int8"] = q[name]
    _write_npz(os.path.join(dirname, PARAMS_FILE), blob)
    with open(os.path.join(dirname, QUANT_SCALES_FILE), "w") as f:
        json.dump(scales, f)


def load_quantized_inference_model(dirname, executor):
    """A quantized directory into the global scope on ``executor``'s
    place: each ``.int8`` member dequantized to f32 (then to its
    variable's dtype), every other member as stored. Returns (program,
    feed names, fetch names)."""
    from ..framework.dtypes import to_torch_dtype
    from ..framework.program import Program
    from ..framework.scope import global_scope
    from ..io import MODEL_FILE, _decode, _device_of, _load_arrays
    with open(os.path.join(dirname, MODEL_FILE)) as f:
        meta = json.load(f)
    with open(os.path.join(dirname, QUANT_SCALES_FILE)) as f:
        scales = json.load(f)
    program = Program.from_dict(meta["program"])
    block = program.global_block()
    device = _device_of(executor)
    scope = global_scope()
    for name, arr in _load_arrays(dirname, None).items():
        base = name[:-5] if name.endswith(".int8") else name
        var = block._find_var_recursive(base)
        if base != name:
            t = torch.from_numpy(arr.astype(np.float32) * scales[base])
            if var is not None:
                t = t.to(to_torch_dtype(var.dtype))
        else:
            t = _decode(arr, var.dtype if var is not None
                        else arr.dtype.name)
        scope.set_var(base, t.to(device))
    return program, meta["feed_var_names"], meta["fetch_var_names"]
