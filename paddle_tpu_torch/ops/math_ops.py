"""Math / elementwise / reduction / activation op kernels.

Counterparts of the ops of paddle_tpu/ops/math_ops.py that BERT and GPT
serving and pretraining run. ``mul`` and ``matmul`` are plain
``torch.matmul`` (``matmul(out_dtype)`` one widened cuBLAS product): XLA
computes them outside any Pallas kernel in the JAX package.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from ..framework.dtypes import to_torch_dtype


def _x(ins, slot="X"):
    return ins[slot][0]


def _bcast(x, y, axis):
    """Paddle's elementwise ``axis`` broadcast: Y's dims align with X's
    starting at ``axis`` (-1: trailing)."""
    if x.dim() == y.dim():
        return x, y
    if y.dim() > x.dim():
        y2, x2 = _bcast(y, x, axis)
        return x2, y2
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) + \
        (1,) * (x.dim() - axis - y.dim())
    return x, y.reshape(new_shape)


def _elementwise(fn):
    def kernel(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(x, y)}
    return kernel


for _name, _fn in (("elementwise_add", torch.add),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div)):
    register_op(_name)(_elementwise(_fn))


_ACTIVATIONS = {
    "tanh": lambda x, a: torch.tanh(x),
    "gelu": lambda x, a: F.gelu(
        x, approximate="tanh" if a.get("approximate", False) else "none"),
}


def _act(fn):
    def kernel(ctx, ins, attrs):
        return {"Out": fn(_x(ins), attrs)}
    return kernel


for _name, _fn in _ACTIVATIONS.items():
    register_op(_name)(_act(_fn))


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = _x(ins)
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": _x(ins).to(to_torch_dtype(attrs["out_dtype"]))}


@register_op("mul")
def _mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(-1, math.prod(xs[xn:]))
    y2 = y.reshape(math.prod(ys[:yn]), -1)
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])}


def _widened_product(x, y, out_dtype):
    """``x @ y`` (batch dims broadcast) with products summed in f32 and
    the result in ``out_dtype``. bf16/f16 operands into f32: on the card
    one cuBLAS call with an f32 output (``torch.mm``/``torch.bmm``
    ``out_dtype``, on 2-D/3-D views); on the CPU ``x.float() @
    y.float()``, exact since a bf16 product is exact in f32. Any other
    pair: the product in the operands' common type, rounded to
    ``out_dtype``."""
    half = (torch.bfloat16, torch.float16)
    if x.dtype == y.dtype and x.dtype in half and \
            out_dtype == torch.float32:
        if x.device.type != "cuda":
            return torch.matmul(x.float(), y.float())
        if y.dim() == 2:
            out = torch.mm(x.reshape(-1, x.shape[-1]), y,
                           out_dtype=out_dtype)
            return out.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        xb = x.expand(batch + tuple(x.shape[-2:])).reshape(
            (-1,) + tuple(x.shape[-2:]))
        yb = y.expand(batch + tuple(y.shape[-2:])).reshape(
            (-1,) + tuple(y.shape[-2:]))
        out = torch.bmm(xb, yb, out_dtype=out_dtype)
        return out.reshape(batch + tuple(out.shape[-2:]))
    common = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(common), y.to(common)).to(out_dtype)


class _MatmulWiden(torch.autograd.Function):
    """The JAX package's ``_matmul_widen`` (ops/math_ops.py:193-217): the
    product in ``out_dtype``; the backward casts the cotangent to each
    operand's dtype first, forms both products the same way and rounds
    them back, summing broadcast batch dims."""

    @staticmethod
    def forward(ctx, x, y, out_dtype):
        ctx.save_for_backward(x, y)
        ctx.out_dtype = out_dtype
        return _widened_product(x, y, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _widened_product(g.to(x.dtype), y.transpose(-1, -2),
                                  ctx.out_dtype).to(x.dtype)
            dx = dx.sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            dy = _widened_product(x.transpose(-1, -2), g.to(y.dtype),
                                  ctx.out_dtype).to(y.dtype)
            dy = dy.sum_to_size(y.shape)
        return dx, dy, None


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """``X @ Y`` with batch broadcasting, either operand transposed, times
    ``alpha``. ``out_dtype``: the output's dtype, the products summed in
    f32 (bf16 operands into f32 logits, GPT's tied decode head)."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out_dtype = attrs.get("out_dtype")
    if out_dtype:
        out = _MatmulWiden.apply(x, y, to_torch_dtype(out_dtype))
    else:
        out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": _x(ins).mean().reshape((1,))}


@register_op("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    """Sum over ``dim`` (or every axis with ``reduce_all``); a full
    reduction without ``keep_dim`` has shape (1,), as in fluid."""
    x = _x(ins)
    dims = attrs.get("dim", [0])
    keep = attrs.get("keep_dim", False)
    reduce_all = attrs.get("reduce_all", False) or dims is None
    if reduce_all:
        axes = tuple(range(x.dim()))
    else:
        axes = tuple(d % x.dim() for d in np.atleast_1d(dims).tolist())
    out = x.sum(dim=axes, keepdim=keep) if axes else x.clone()
    if reduce_all and not keep:
        out = out.reshape((1,))
    return {"Out": out}
