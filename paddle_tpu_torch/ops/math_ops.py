"""Math / elementwise / reduction / activation / compare op kernels.

Counterparts of every op of paddle_tpu/ops/math_ops.py: the elementwise
and compare ops, the JAX package's whole activation table, the
reductions (max and min split a tied gradient evenly, as JAX's do),
``logsumexp``, the finite checks, ``maximum``/``minimum`` (JAX's
gradient rule, ``_Extremum``) and ``dot``. ``mul`` and ``matmul`` are plain
``torch.matmul`` (``matmul(out_dtype)`` one widened cuBLAS product): XLA
computes them outside any Pallas kernel in the JAX package.

Result dtypes follow JAX's: torch ranks a 0-d tensor below a tensor with
dims of the same kind (``bf16 (n,) * f32 ()`` is bf16 in torch, f32 in
JAX), so a binary op whose operands differ in dtype, one of them 0-d,
casts both to their promoted type first (``_promote``). This is what a
bf16 model's global-norm clip reads: ``squared_l2_norm`` of a bf16
gradient is a bf16 scalar, and the clipped gradient is f32.
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


def _promote(x, y):
    """(x, y) in JAX's common dtype where torch would rank a 0-d operand
    lower (see the module docstring); otherwise as they are."""
    if x.dtype != y.dtype and (x.dim() == 0 or y.dim() == 0):
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def _elementwise(fn):
    def kernel(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(*_promote(x, y))}
    return kernel


for _name, _fn in (("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_mod", torch.remainder),
                   ("elementwise_floordiv", torch.floor_divide)):
    register_op(_name)(_elementwise(_fn))


def recip_f32(n):
    """1 / n in f32, as XLA folds a division by a constant in the JAX
    package's jitted step: the quotient is x times this reciprocal, which
    torch computes alike on the CPU and the card (a division by a Python
    number is exact on the CPU and a reciprocal product on the card)."""
    return float(np.float32(1.0) / np.float32(n))


def jnp_abs(x):
    """|x| with ``jnp.abs``'s gradient, whose rule is ``select(x >= 0, g,
    -g)``: 1 at 0, where ``torch.abs``'s is 0. A logit of exactly 0 (a
    dead relu map into a zero bias) takes the JAX package's gradient
    through the log1p(exp(-|x|)) of the sigmoid losses."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _leaky_relu(x, a):
    return torch.where(x >= 0, x, a.get("alpha", 0.02) * x)


def _selu(x, a):
    alpha = a.get("alpha", 1.6732632423543772)
    return a.get("scale", 1.0507009873554805) * torch.where(
        x > 0, x, alpha * (torch.exp(x) - 1))


def _soft_relu(x, a):
    t = a.get("threshold", 40.0)
    return torch.log(1 + torch.exp(torch.clamp(x, -t, t)))


# the JAX package's table (paddle_tpu/ops/math_ops.py:70-126), each the
# same formula: a gradient differs only where JAX's would at a tie
# (relu's at 0 is 0, as jax.nn.relu's; a clamp's at its bounds is 1
# where JAX's clip gives 1/2)
_ACTIVATIONS = {
    "relu": lambda x, a: torch.relu(x),
    "relu6": lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softplus": lambda x, a: _softplus(x),
    "softsign": lambda x, a: F.softsign(x),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "square": lambda x, a: torch.square(x),
    "abs": lambda x, a: jnp_abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "round": lambda x, a: torch.round(x),       # half to even, as jnp
    "reciprocal": lambda x, a: 1.0 / x,
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
    "acos": lambda x, a: torch.acos(x),
    "asin": lambda x, a: torch.asin(x),
    "atan": lambda x, a: torch.atan(x),
    "erf": lambda x, a: torch.erf(x),
    "gelu": lambda x, a: F.gelu(
        x, approximate="tanh" if a.get("approximate", False) else "none"),
    "leaky_relu": _leaky_relu,
    "elu": lambda x, a: F.elu(x, alpha=a.get("alpha", 1.0)),
    "selu": _selu,
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    "hard_sigmoid": lambda x, a: torch.clamp(
        a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0),
    "hard_swish": lambda x, a: x * torch.clamp(
        x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0)) /
        a.get("scale", 6.0),
    "hard_shrink": lambda x, a: torch.where(
        torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)),
    "softshrink": lambda x, a: torch.sign(x) * torch.relu(
        torch.abs(x) - a.get("lambda", 0.5)),
    "thresholded_relu": lambda x, a: torch.where(
        x > a.get("threshold", 1.0), x, torch.zeros_like(x)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "soft_relu": _soft_relu,
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        a.get("scale_a", 0.67) * x),
    "sign": lambda x, a: torch.sign(x),
    "log1p": lambda x, a: torch.log1p(x),
    "expm1": lambda x, a: torch.expm1(x),
    "silu": lambda x, a: F.silu(x),
    "mish": lambda x, a: x * torch.tanh(_softplus(x)),
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


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": torch.pow(_x(ins), attrs.get("factor", 1.0))}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": torch.clamp(_x(ins), attrs["min"], attrs["max"])}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """x * max_norm / max(||x||, max_norm), in x's dtype, the norm on the
    device."""
    x = _x(ins)
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.square(x).sum())
    return {"Out": x * (max_norm / torch.clamp(norm, min=max_norm))}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    """sum(x^2) as a 0-d tensor of x's dtype (bf16 for a bf16 gradient,
    as ``jnp.sum(jnp.square(x))``)."""
    return {"Out": torch.square(_x(ins)).sum()}


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
        out, x = _promote(out, x)
        out = out + x
    return {"Out": out}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """Running sum along ``axis`` (``flatten``: of X flattened), by the
    JAX op's arithmetic: ``exclusive`` subtracts X from the inclusive sum,
    ``reverse`` sums the flipped X and flips back, then subtracts X if
    ``exclusive``."""
    x = _x(ins)
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    exclusive = attrs.get("exclusive", False)
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if exclusive:
        out = out - x
    return {"Out": out.to(x.dtype)}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": _x(ins).mean().reshape((1,))}


def _reduce(fn):
    """A reduction over ``dim`` (or every axis with ``reduce_all``); a full
    reduction without ``keep_dim`` has shape (1,), as in fluid."""
    def kernel(ctx, ins, attrs):
        x = _x(ins)
        dims = attrs.get("dim", [0])
        keep = attrs.get("keep_dim", False)
        reduce_all = attrs.get("reduce_all", False) or dims is None
        if reduce_all:
            axes = tuple(range(x.dim()))
        else:
            axes = tuple(d % x.dim() for d in np.atleast_1d(dims).tolist())
        out = fn(x, dim=axes, keepdim=keep) if axes else x.clone()
        if reduce_all and not keep:
            out = out.reshape((1,))
        return {"Out": out}
    return kernel


def _prod(x, dim, keepdim):
    """``jnp.prod`` over several axes (``torch.prod`` takes one)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


# max and min split the gradient evenly among tied maxima, as JAX's
# reduce_max does (torch.amax/amin, not torch.max)
for _name, _fn in (("reduce_sum", torch.sum), ("reduce_mean", torch.mean),
                   ("reduce_max", torch.amax), ("reduce_min", torch.amin),
                   ("reduce_prod", _prod), ("reduce_all", torch.all),
                   ("reduce_any", torch.any)):
    register_op(_name)(_reduce(_fn))


@register_op("logsumexp")
def _logsumexp(ctx, ins, attrs):
    """log(sum(exp(x))) over ``dim`` (no ``dim``: every axis, a 0-d
    result)."""
    x = _x(ins)
    dims = attrs.get("dim", None)
    axes = tuple(d % x.dim() for d in dims) if dims else \
        tuple(range(x.dim()))
    return {"Out": torch.logsumexp(x, dim=axes,
                                   keepdim=attrs.get("keep_dim", False))}


def _compare(fn):
    def kernel(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(*_promote(x, y))}
    return kernel


for _name, _fn in (("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("equal", torch.eq), ("not_equal", torch.ne)):
    register_op(_name)(_compare(_fn))

for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    register_op(_name)(_compare(_fn))


@register_op("logical_not")
def _logical_not(ctx, ins, attrs):
    return {"Out": torch.logical_not(_x(ins))}


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    """One bool, (1,): every element of X finite."""
    return {"Out": torch.isfinite(_x(ins)).all().reshape((1,))}


@register_op("isnan")
def _isnan(ctx, ins, attrs):
    return {"Out": torch.isnan(_x(ins))}


@register_op("isinf")
def _isinf(ctx, ins, attrs):
    return {"Out": torch.isinf(_x(ins))}


class _Extremum(torch.autograd.Function):
    """``jnp.maximum``/``jnp.minimum`` with JAX's gradient rule: the
    chosen operand takes the cotangent, a tie gives each half, and a NaN
    comparison (neither chosen) gives neither any (torch's own rule sends
    it to the NaN operand)."""

    @staticmethod
    def forward(ctx, x, y, take_max):
        ctx.save_for_backward(x, y)
        ctx.take_max = take_max
        return torch.maximum(x, y) if take_max else torch.minimum(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        wins = (x > y) if ctx.take_max else (x < y)
        loses = (x < y) if ctx.take_max else (x > y)
        half = (x == y).to(g.dtype) * 0.5
        gx = g * (wins.to(g.dtype) + half)
        gy = g * (loses.to(g.dtype) + half)
        return gx.sum_to_size(x.shape), gy.sum_to_size(y.shape), None


@register_op("maximum")
def _maximum(ctx, ins, attrs):
    return {"Out": _Extremum.apply(*_promote(ins["X"][0], ins["Y"][0]),
                                   True)}


@register_op("minimum")
def _minimum(ctx, ins, attrs):
    return {"Out": _Extremum.apply(*_promote(ins["X"][0], ins["Y"][0]),
                                   False)}


@register_op("dot")
def _dot(ctx, ins, attrs):
    """Row-wise inner product over the last axis, kept as size 1."""
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.sum(x * y, dim=-1, keepdim=True)}
