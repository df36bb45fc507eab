"""The block-quantization host codec (numpy), for checkpoint payloads.

The port's own copy of paddle_tpu/ops/quant_ops.py:141-211
(``np_block_quantize``, ``np_block_dequantize``, ``encode_array``,
``decode_array``), so that ``io.save_checkpoint(compress="q8")`` writes
and reads the JAX package's layout with the same arithmetic: int8 blocks
of ``block_size`` values, one f32 abs-max scale per block. The max-
magnitude element of every block round-trips exactly, every other is
within ``absmax_block / qmax / 2`` of its value, and a non-finite input
poisons its whole block to NaN. ``mode="zlib"`` of ``encode_array`` is
lossless. The fake-quantization ops (the traced halves) come with the
slim slice.
"""
import zlib

import numpy as np

DEFAULT_BLOCK_SIZE = 256
DEFAULT_BITS = 8
SCALE_BYTES = 4          # one fp32 scale per block
_SCALE_FLOOR = 1e-12     # all-zero blocks: avoid 0/0 without moving values


def _qmax(bits):
    return 2.0 ** (int(bits) - 1) - 1


def np_block_quantize(arr, block_size=DEFAULT_BLOCK_SIZE,
                      bits=DEFAULT_BITS):
    """(int8 blocks (n_blocks, block_size), f32 scale per block) of
    ``arr`` flattened and zero-padded to whole blocks."""
    qmax = _qmax(bits)
    flat = np.asarray(arr, np.float32).reshape(-1)
    pad = (-flat.size) % int(block_size)
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
    blocks = flat.reshape(-1, int(block_size))
    scale = np.max(np.abs(blocks), axis=1).astype(np.float32)
    safe = np.maximum(scale, _SCALE_FLOOR)
    with np.errstate(invalid="ignore", over="ignore"):
        q = np.clip(np.round(blocks / safe[:, None] * qmax), -qmax, qmax)
    # an int8 cast of NaN is undefined in C; force 0 (the non-finite
    # scale still poisons the block to NaN on dequantize)
    q = np.where(np.isfinite(q), q, 0.0).astype(np.int8)
    return q, scale


def np_block_dequantize(q, scale, shape, dtype, bits=DEFAULT_BITS):
    qmax = _qmax(bits)
    safe = np.maximum(scale.astype(np.float32), _SCALE_FLOOR)
    with np.errstate(invalid="ignore"):
        blocks = q.astype(np.float32) * (safe / qmax)[:, None]
    size = int(np.prod(shape)) if len(shape) else 1
    return blocks.reshape(-1)[:size].reshape(shape).astype(dtype)


def encode_array(arr, mode="zlib", block_size=DEFAULT_BLOCK_SIZE,
                 bits=DEFAULT_BITS):
    """One host array encoded for the wire: a dict of the payload and its
    ``raw_bytes``/``wire_bytes``. ``mode="zlib"``: a lossless deflate of
    the raw bytes; ``"q8"``: the lossy block codec for float32/float64
    arrays (other dtypes fall back to zlib, so counters round-trip
    exactly). The dict holds numpy dtype objects: it is an in-process
    value, not a file format."""
    arr = np.ascontiguousarray(arr)
    enc = {"shape": arr.shape, "dtype": arr.dtype,
           "raw_bytes": int(arr.nbytes)}
    if mode == "q8" and arr.dtype in (np.float32, np.float64):
        q, scale = np_block_quantize(arr, block_size, bits)
        enc.update(mode="q8", q=q, scale=scale, block_size=int(block_size),
                   bits=int(bits), wire_bytes=int(q.nbytes + scale.nbytes))
        return enc
    if mode not in ("zlib", "q8"):
        raise ValueError("encode_array mode must be 'zlib' or 'q8', got %r"
                         % (mode,))
    payload = zlib.compress(arr.tobytes(), 1)
    enc.update(mode="zlib", data=payload, wire_bytes=int(len(payload)))
    return enc


def decode_array(enc):
    """Inverse of :func:`encode_array`."""
    if enc["mode"] == "q8":
        return np_block_dequantize(enc["q"], enc["scale"], enc["shape"],
                                   enc["dtype"], enc["bits"])
    raw = zlib.decompress(enc["data"])
    return np.frombuffer(raw, dtype=enc["dtype"]).reshape(
        enc["shape"]).copy()


__all__ = ["DEFAULT_BLOCK_SIZE", "DEFAULT_BITS", "np_block_quantize",
           "np_block_dequantize", "encode_array", "decode_array"]
