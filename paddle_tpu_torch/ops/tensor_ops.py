"""Tensor manipulation op kernels (counterparts in
paddle_tpu/ops/tensor_ops.py). Views stay views: transpose2 hands a
strided tensor on, and the kernel wrappers make their inputs dense.
``gather``'s gradient scatters with atomics on a CUDA card (index_add),
so its sums arrive in no fixed order there. ``gather`` (and
``lookup_table``) answer an index out of range as ``jnp.take``'s default
mode does (``take_fill``)."""
import torch

from .registry import register_op
from ..framework.dtypes import to_torch_dtype


def _x(ins, slot="X"):
    return ins[slot][0]


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = tuple(attrs.get("shape", [1]))
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=to_torch_dtype(attrs.get("dtype",
                                                             "float32")),
                              device=ctx.device)}


@register_op("fill_any_like")
def _fill_any_like(ctx, ins, attrs):
    x = _x(ins)
    dtype = attrs.get("dtype")
    dtype = to_torch_dtype(dtype) if dtype else x.dtype
    return {"Out": torch.full(x.shape, attrs.get("value", 0.0), dtype=dtype,
                              device=x.device)}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    """Zeros of X's shape and dtype; no gradient reaches X (paddle_tpu's
    ``jnp.zeros_like`` has none)."""
    x = _x(ins)
    return {"Out": torch.zeros(x.shape, dtype=x.dtype, device=x.device)}


@register_op("fill_constant_batch_size_like", nondiff=("Input",))
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """``shape`` filled with ``value``, its ``output_dim_idx`` dim taken
    from Input's ``input_dim_idx`` dim."""
    x = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        x.shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=to_torch_dtype(attrs.get("dtype",
                                                             "float32")),
                              device=x.device)}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": _x(ins)}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    """The attr's values as a tensor: copied from the host once per plan
    where the step may be captured, and on the device after
    (``RunContext.constant``)."""
    return {"Out": ctx.constant(lambda: torch.tensor(
        attrs["values"], dtype=to_torch_dtype(attrs.get("dtype", "float32")),
        device=ctx.device).reshape(attrs["shape"]))}


@register_op("increment")
def _increment(ctx, ins, attrs):
    """x + step in x's own dtype: an int64 counter stays int64 (the float
    ``step`` attr is truncated to it, as ``jnp.asarray(step, x.dtype)``)."""
    x = _x(ins)
    step = attrs.get("step", 1.0)
    return {"Out": x + (step if x.is_floating_point() else int(step))}


@register_op("flip")
def _flip(ctx, ins, attrs):
    return {"Out": torch.flip(_x(ins), tuple(attrs["axis"]))}


@register_op("where")
def _where(ctx, ins, attrs):
    cond, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": torch.where(cond, x, y)}


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN for floats, the
    minimum of a signed integer, the maximum of an unsigned one, True.
    An int64 tensor is the JAX package's int32 (no x64), so it takes
    int32's minimum."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(torch.int32 if dtype == torch.int64 else dtype)
    return info.min if info.min < 0 else info.max


def take_fill(index, n):
    """(clamped int64 index, in-range mask) of ``index`` into an axis of
    ``n``, as ``jnp.take``'s default mode reads it: an index in [-n, 0)
    wraps, one past either end reads the clamped row, which the caller
    fills (``fill_taken``). No value reaches the host and nothing asserts
    on the device, so a captured step holds it."""
    idx = index.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), ok


def fill_taken(out, ok, axis, ndim_index):
    """``out`` (rows read at a clamped index) with each row whose index was
    out of range filled with ``_fill_value``; the filled rows' gradient is
    zero, as JAX's drop-mode scatter gives it."""
    shape = [1] * out.dim()
    shape[axis:axis + ndim_index] = ok.shape
    fill = torch.full((), _fill_value(out.dtype), dtype=out.dtype,
                      device=out.device)
    return torch.where(ok.reshape(shape), out, fill)


@register_op("gather", nondiff=("Index",))
def _gather(ctx, ins, attrs):
    """``jnp.take(x, index, axis)``: an index in [-n, 0) wraps, one out of
    range gives NaN (or an integer's fill, ``_fill_value``)."""
    x, index = ins["X"][0], ins["Index"][0]
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    axis = attrs.get("axis", 0) or 0
    axis = axis + x.dim() if axis < 0 else axis
    safe, ok = take_fill(index, x.shape[axis])
    return {"Out": fill_taken(x.index_select(axis, safe), ok, axis, 1)}


def _float_order_key(x):
    """int64 keys, one per element of float ``x``, that order as
    (value, then the lower index first) along the last axis: the float's
    bits made monotone (negatives' magnitude bits flipped) in the high
    32 bits, 2^32 - 1 - index in the low 32."""
    bits = x.float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = (2 ** 32 - 1) - torch.arange(x.shape[-1], device=x.device)
    return (key << 32) + low


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    """The ``k`` largest along the last axis, largest first; among equal
    values the lower index first and the lower index kept, as
    ``lax.top_k`` picks (``torch.topk`` promises no order among ties).
    Floats take ``torch.topk`` of order keys with no ties
    (``_float_order_key``), other dtypes a stable sort."""
    x = _x(ins)
    k = attrs["k"]
    if x.is_floating_point():
        idx = torch.topk(_float_order_key(x), k, dim=-1).indices
    else:
        idx = torch.sort(x, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    return {"Out": torch.gather(x, -1, idx), "Indices": idx.long()}


@register_op("arg_max", nondiff=("X",))
def _arg_max(ctx, ins, attrs):
    """int64 index of the largest along ``axis``, the first on a tie
    (``torch.argmax``'s and ``jnp.argmax``'s rule)."""
    x = _x(ins)
    return {"Out": torch.argmax(x, dim=attrs.get("axis", -1),
                                keepdim=attrs.get("keepdims", False))}


@register_op("expand")
def _expand(ctx, ins, attrs):
    """``jnp.tile``: X repeated ``expand_times`` along each axis, in new
    memory (``Tensor.repeat``; a stride-0 ``Tensor.expand`` view would
    reach kernels that read their operand densely)."""
    return {"Out": _x(ins).repeat(*attrs["expand_times"])}


@register_op("reshape2")
def _reshape2(ctx, ins, attrs):
    x = _x(ins)
    # fluid semantics: 0 copies the input's dim
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape)}


@register_op("transpose2")
def _transpose2(ctx, ins, attrs):
    return {"Out": _x(ins).permute(*attrs["axis"])}


@register_op("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = _x(ins)
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": x}


@register_op("squeeze2")
def _squeeze2(ctx, ins, attrs):
    """X without its ``axes`` of size 1 (an axis of another size is kept,
    as ``jnp.squeeze`` of the JAX op's filtered axes); no ``axes``: every
    axis of size 1."""
    x = _x(ins)
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": x.squeeze()}
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return {"Out": x.squeeze(axes) if axes else x}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("sequence_mask", nondiff=("X",))
def _sequence_mask(ctx, ins, attrs):
    """``arange(maxlen) < x`` for each element of X, in ``out_dtype``;
    ``maxlen`` must be static, as in the JAX op."""
    x = _x(ins)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    mask = torch.arange(maxlen, device=x.device)[None, :] < x.reshape(-1, 1)
    mask = mask.reshape(tuple(x.shape) + (maxlen,))
    return {"Y": mask.to(to_torch_dtype(attrs.get("out_dtype", "int64")))}


@register_op("concat")
def _concat(ctx, ins, attrs):
    """X's tensors joined along ``axis``; the gradient splits back by
    their sizes (``torch.cat``'s own)."""
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split")
def _split(ctx, ins, attrs):
    """``num`` equal parts, or ``sections`` (the last takes the rest), along
    ``axis``; the parts are views of X."""
    x = _x(ins)
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError("split: axis %d of size %d does not divide into "
                             "%d parts" % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    else:
        bounds, acc = [], 0
        for s in attrs.get("sections", [])[:-1]:
            acc += s
            bounds.append(acc)
        outs = torch.tensor_split(x, bounds, dim=axis)
    return {"Out": list(outs)}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []) or [], reverse=True):
        out = out.squeeze(a)
    return {"Out": out}
