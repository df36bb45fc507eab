"""Tensor manipulation op kernels (counterparts in
paddle_tpu/ops/tensor_ops.py). Views stay views: transpose2 hands a
strided tensor on, and the kernel wrappers make their inputs dense.
``gather``'s gradient scatters with atomics on a CUDA card (index_add),
so its sums arrive in no fixed order there."""
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


@register_op("where")
def _where(ctx, ins, attrs):
    cond, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": torch.where(cond, x, y)}


@register_op("gather", nondiff=("Index",))
def _gather(ctx, ins, attrs):
    x, index = ins["X"][0], ins["Index"][0]
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    return {"Out": x.index_select(attrs.get("axis", 0) or 0, index.long())}


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    vals, idx = torch.topk(_x(ins), attrs["k"], dim=-1)
    return {"Out": vals, "Indices": idx.long()}


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
