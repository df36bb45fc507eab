"""The three fake-quantization ops of contrib/slim: the port against the
JAX package.

Each op runs in both packages on the same seeded N(0, 1) inputs, the
JAX op under ``jax.jit`` as the JAX Executor's step runs it (XLA then
folds the division by qmax into a product with its f32 reciprocal and
fuses ``q * scale * (1 / qmax) - x`` into one multiply-add; the port
computes those forms, ops/quant_ops.py). ``Out`` and ``OutScale`` (and
the moving average's state) must be bit-equal, at 8 and 4 bits, and the
straight-through gradient must be the identity in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from op_library_helpers import compare, registry_flags_match
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops.registry import get_op as tget

OPS = ("fake_quantize_dequantize_abs_max",
       "fake_quantize_dequantize_moving_average_abs_max",
       "fake_channel_wise_quantize_dequantize_abs_max")
MA = OPS[1]
EXACT = ("Out", "OutScale", "OutState", "OutAccum")


def _ins(op, x, rng=None):
    ins = {"X": [x]}
    if op == MA:
        rng = rng or np.random.RandomState(5)
        ins["InState"] = [np.float32([1.0 + 9 * rng.rand()])]
        ins["InAccum"] = [np.float32([3.0 * rng.rand()])]
    return ins


def _attrs(op, bits, axis=0):
    attrs = {"bit_length": bits}
    if op == MA:
        attrs["moving_rate"] = 0.9
    if op == OPS[2]:
        attrs["quant_axis"] = axis
    return attrs


def _run(op, x, bits, axis=0, rng=None):
    outs = list(EXACT) if op == MA else ["Out", "OutScale"]
    return compare(op, _ins(op, x, rng), _attrs(op, bits, axis),
                   diff=[("X", 0)], outs=outs, exact=EXACT, jit=True)


def test_registry_flags_match():
    registry_flags_match(OPS)
    assert tget(MA).nondiff == ("InScale", "InState", "InAccum")


# a conv filter (OIHW: axis 0, per output channel), a mul weight ((in,
# out): axis 1 is quant_aware's), an activation; the axis is the
# channel-wise op's attribute only
SHAPES = [((8, 3, 3, 3), 0), ((16, 12), 0), ((4, 32, 16), 0)]
CASES = [(op, shape, axis) for op in OPS for shape, axis in SHAPES] + [
    (OPS[2], (8, 3, 3, 3), 1), (OPS[2], (16, 12), 1)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("op,shape,axis", CASES)
def test_op_bit_equal(op, bits, shape, axis):
    rng = np.random.RandomState(hash((op, bits, shape, axis)) % 2 ** 31)
    x = rng.standard_normal(shape).astype(np.float32)
    got, want = _run(op, x, bits, axis, rng)
    assert not np.array_equal(got["Out"][0], x)       # it quantized


@pytest.mark.parametrize("op", OPS)
def test_all_zero_hits_the_floor(op):
    """max |x| = 0: every scale is floored at 1e-8 and Out is 0."""
    x = np.zeros((6, 5), np.float32)
    got, _ = _run(op, x, 8)
    assert not got["Out"][0].any()
    if op != MA:
        np.testing.assert_array_equal(
            got["OutScale"][0], np.float32(1e-8) * np.ones_like(
                got["OutScale"][0]))


def _half_levels(qmax, scale=1.0):
    """f32 values x with x / scale * qmax exactly k + 0.5 in f32 for
    several k (found among the neighbours of the exact quotient), and
    ``scale`` itself as the abs max."""
    out = [np.float32(scale)]
    for k in range(-int(qmax), int(qmax) - 1):
        x = np.float32((k + 0.5) * scale / qmax)
        for _ in range(8):
            if np.float32(x / np.float32(scale) * np.float32(qmax)) == \
                    k + 0.5:
                out.append(x)
                break
            x = np.nextafter(x, np.float32(np.inf), dtype=np.float32)
    return np.array(out, np.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_half_levels_round_to_even(bits):
    """Values exactly halfway between two levels round to the even one
    (``torch.round`` as ``jnp.round``)."""
    qmax = 2.0 ** (bits - 1) - 1
    x = _half_levels(qmax)
    assert len(x) > qmax          # most of the levels' halves were found
    got, _ = _run(OPS[0], x, bits)
    levels = np.round(got["Out"][0][1:] * np.float32(qmax))
    assert (levels % 2 == 0).all()


@pytest.mark.parametrize("op", OPS)
def test_ste_gradient_is_identity(op):
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (5, 7)).astype(np.float32)).requires_grad_()
    ins = {k: [torch.from_numpy(v) for v in vs]
           for k, vs in _ins(op, x.detach().numpy()).items()}
    ins["X"] = [x]
    cot = torch.arange(35.0).reshape(5, 7)
    with torch.enable_grad():
        out = tget(op).fn(None, ins, _attrs(op, 8))["Out"]
        (g,) = torch.autograd.grad(out, [x], cot)
    assert torch.equal(g, cot)


def test_moving_average_closed_form_over_five_updates():
    """Five updates chained through the state: each bit-equal to the JAX
    op's, and the state equal to rate^n + (1 - rate^n) / (1 - rate) from
    1 (f64 closed form, within f32 rounding of the five updates)."""
    rate = 0.9
    jfn = jax.jit(lambda d: jget(MA).fn(None, d, {"bit_length": 8,
                                                  "moving_rate": rate}))
    rng = np.random.RandomState(3)
    state, accum = np.ones(1, np.float32), np.zeros(1, np.float32)
    for n in range(1, 6):
        x = rng.standard_normal((16, 8)).astype(np.float32)
        want = jfn({"X": [jnp.asarray(x)], "InState": [jnp.asarray(state)],
                    "InAccum": [jnp.asarray(accum)]})
        got = tget(MA).fn(None, {"X": [torch.from_numpy(x)],
                                 "InState": [torch.from_numpy(state)],
                                 "InAccum": [torch.from_numpy(accum)]},
                          {"bit_length": 8, "moving_rate": rate})
        for k in EXACT:
            np.testing.assert_array_equal(got[k].detach().numpy(),
                                          np.asarray(want[k]), err_msg=k)
        state = got["OutState"].numpy()
        accum = got["OutAccum"].detach().numpy()
        closed = rate ** n + (1 - rate ** n) / (1 - rate)
        np.testing.assert_allclose(state[0], closed, rtol=5 * 2 ** -24)
