"""The three fake-quantization ops of contrib/slim and the block-
quantization host codec (numpy).

The ops (counterparts of paddle_tpu/ops/quant_ops.py:44-76,212-226):
simulated quantization, values quantized and dequantized in floating
point so the matmuls and convolutions still run in f32, with a
straight-through gradient: ``Out = X + (qdq(X) - X).detach()``, the JAX
package's ``x + stop_gradient(qdq - x)`` (not bit-equal to ``qdq``).

  * ``fake_quantize_dequantize_abs_max``: one abs-max scale a tensor;
  * ``fake_quantize_dequantize_moving_average_abs_max``: the scale is
    ``accum / state`` of an exponential moving average that the op
    advances (``OutState``/``OutAccum``, written by ``quant_aware`` under
    the names it reads), once a run: its backward reads its record;
  * ``fake_channel_wise_quantize_dequantize_abs_max``: one scale a slice
    along ``quant_axis``.

Each scale is floored at 1e-8 (an all-zero tensor), levels are rounded
half to even (``torch.round`` as ``jnp.round``) and clipped to
``[-qmax - 1, qmax]`` (the ops' asymmetric range; the block codec's is
symmetric). The arithmetic is the jitted JAX step's, so that the CPU
and the card give its bits: ``x / scale * qmax``; then ``q * scale``
times the f32 reciprocal of ``qmax`` (XLA's form of the division by a
constant) minus ``x``, and the moving averages' ``rate * v + c``, each
as the one fused multiply-add XLA's CPU code emits (``_fused``).

The codec: the port's own copy of paddle_tpu/ops/quant_ops.py:141-211
(``np_block_quantize``, ``np_block_dequantize``, ``encode_array``,
``decode_array``), so that ``io.save_checkpoint(compress="q8")`` writes
and reads the JAX package's layout with the same arithmetic: int8 blocks
of ``block_size`` values, one f32 abs-max scale per block. The max-
magnitude element of every block round-trips exactly, every other is
within ``absmax_block / qmax / 2`` of its value, and a non-finite input
poisons its whole block to NaN. ``mode="zlib"`` of ``encode_array`` is
lossless.
"""
import zlib

import numpy as np
import torch

from .math_ops import recip_f32
from .registry import register_op

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


# ---------------------------------------------------------------------------
# the fake-quantization ops (contrib/slim's quant-aware training)
# ---------------------------------------------------------------------------

_SCALE_MIN = 1e-8


def _fused(a, b, c):
    """``a * b + c`` rounded once to ``a``'s dtype, as the fused
    multiply-add XLA's CPU code emits where a product feeds a sum: the
    product of two f32 values is exact in f64, and the sum is too where
    the terms' magnitudes are within 2^5 of each other (the qdq's and
    the moving average's are; elsewhere a double rounding can differ
    from the fused one, with odds of ~2^-29 an element)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).to(a.dtype)


def _ste_qdq(x, scale, qmax):
    """The straight-through output of ``x`` quantized at the floored
    ``scale`` (a tensor that broadcasts) to the levels of ``qmax`` and
    back: ``x + (qdq - x).detach()`` with ``qdq - x`` taken as the jitted
    JAX op takes it, ``q * scale`` times 1 / qmax minus ``x`` in one fused
    operation."""
    with torch.no_grad():
        q = torch.clamp(torch.round(x / scale * qmax), -qmax - 1, qmax)
        diff = _fused(q * scale, recip_f32(qmax), -x)
    return x + diff


@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ctx, ins, attrs):
    """Per-tensor abs-max (the reference fake_quantize_dequantize_abs_max
    op)."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    scale = torch.clamp_min(x.abs().amax(), _SCALE_MIN)
    return {"Out": _ste_qdq(x, scale.detach(), qmax),
            "OutScale": scale.reshape(1)}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             nondiff=("InScale", "InState", "InAccum"))
def _fake_qdq_moving_avg(ctx, ins, attrs):
    """Moving-average abs-max (the reference
    fake_quantize_dequantize_moving_average_abs_max): state <- rate *
    state + 1, accum <- rate * accum + abs_max(X), scale = accum /
    state."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    rate = float(np.float32(attrs.get("moving_rate", 0.9)))
    state = ins["InState"][0] if ins.get("InState") else \
        torch.ones(1, device=x.device)
    accum = ins["InAccum"][0] if ins.get("InAccum") else \
        torch.zeros(1, device=x.device)
    new_state = _fused(state, rate, 1.0)
    new_accum = _fused(accum, rate, x.abs().amax())
    scale = new_accum / new_state
    floored = torch.clamp_min(scale.reshape(()), _SCALE_MIN)
    return {"Out": _ste_qdq(x, floored.detach(), qmax),
            "OutScale": scale.reshape(1), "OutState": new_state,
            "OutAccum": new_accum}


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_qdq_channel(ctx, ins, attrs):
    """Per-channel abs-max (the reference
    fake_channel_wise_quantize_abs_max): one scale a slice along
    ``quant_axis`` (0 for a conv filter, OIHW; 1 for a (in, out)
    weight)."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    axis = int(attrs.get("quant_axis", 0)) % x.dim()
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.clamp_min(x.abs().amax(dim=red, keepdim=True),
                            _SCALE_MIN)
    return {"Out": _ste_qdq(x, scale.detach(), qmax),
            "OutScale": scale.reshape(-1)}


__all__ = ["DEFAULT_BLOCK_SIZE", "DEFAULT_BITS", "np_block_quantize",
           "np_block_dequantize", "encode_array", "decode_array"]
