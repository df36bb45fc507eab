"""Dtype system: Paddle dtype strings <-> torch dtypes.

Counterpart of paddle_tpu/framework/dtypes.py. The canonical names (the
strings stored in Program JSON) are identical, so a Program written by
either package names its dtypes the same way.
"""
import numpy as np
import torch

_STR2DTYPE = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
}
_DTYPE2STR = {v: k for k, v in _STR2DTYPE.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "half": "float16",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

def normalize_dtype(dtype):
    """Canonical string name for *dtype* (str, numpy dtype or torch dtype)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name not in _STR2DTYPE:
            raise TypeError("unsupported dtype string: %r" % (dtype,))
        return name
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE2STR:
            raise TypeError("unsupported dtype: %r" % (dtype,))
        return _DTYPE2STR[dtype]
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    name = _ALIASES.get(name, name)
    if name not in _STR2DTYPE:
        raise TypeError("unsupported dtype: %r" % (dtype,))
    return name


def to_torch_dtype(dtype):
    return _STR2DTYPE[normalize_dtype(dtype)]


FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def is_float(dtype):
    return normalize_dtype(dtype) in FLOAT_DTYPES


def dtype_size(dtype):
    """Bytes per element of *dtype* (bfloat16 -> 2)."""
    return torch.empty((), dtype=to_torch_dtype(dtype)).element_size()
