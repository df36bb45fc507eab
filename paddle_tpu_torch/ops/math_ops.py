"""Math / elementwise / activation op kernels.

Counterparts of the ops of paddle_tpu/ops/math_ops.py that BERT serving
and pretraining run. ``mul`` is a plain ``torch.matmul``: XLA computes it
outside any Pallas kernel in the JAX package.
"""
import math

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


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
    return {"Out": x + y}


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
