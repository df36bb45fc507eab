"""Tensor manipulation op kernels (counterparts of every op of
paddle_tpu/ops/tensor_ops.py). Views stay views: transpose2 hands a
strided tensor on, and the kernel wrappers make their inputs dense.
``gather``'s gradient scatters with atomics on a CUDA card (index_add),
so its sums arrive in no fixed order there; the op library's gathers
and scatters add in a fixed order (the note above ``wrap_index``). ``gather``,
``index_select``, ``take_along_axis`` (and ``lookup_table``) answer an
index out of range as ``jnp.take``'s default mode does (``take_fill``),
``gather_nd`` as JAX indexing does (``clamped_read``), and the scatters
drop it. ``range``, ``linspace``, ``where_index`` and ``load_tensor``
read the host (``syncs_host``)."""
import math

import numpy as np
import torch

from .registry import register_op
from .math_ops import _promote
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
    """``jnp.where``'s result dtype: a 0-d operand of another dtype is
    promoted, not ranked below the other (math_ops._promote)."""
    cond, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": torch.where(cond, *_promote(x, y))}


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


# ---- the op library's tensor ops (paddle_tpu/ops/tensor_ops.py) ----------
#
# Bit-stable sums on the card: torch's own backward of ``torch.gather``,
# ``index_select`` and ``take_along_dim``, and ``scatter_add_``, add with
# atomics on a CUDA card, so their sums arrive in no fixed order. The ops
# below read rows by advanced indexing (``x[idx]``), whose backward is
# ``index_put_(accumulate=True)``, and add rows with that same call: on a
# CUDA card it sorts the indices and sums each run of equal ones in order,
# so two runs (or a replay and an op-by-op run) give equal bits.


def wrap_index(index, n):
    """int64 ``index`` with an entry in [-n, 0) wrapped, as JAX's
    indexing normalises a negative index."""
    idx = index.long()
    return torch.where(idx < 0, idx + n, idx)


def add_rows(x, idx, ok, updates):
    """``x.at[idx].add(updates)`` along axis 0 with the updates whose
    ``ok`` is False dropped (JAX's scatter drops an index out of range):
    they go to a row appended past the end, sliced off after."""
    n = x.shape[0]
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    target = torch.where(ok, idx, torch.full_like(idx, n))
    out = torch.index_put(torch.cat([x, pad]), (target,), updates,
                          accumulate=True)
    return out[:n]


@register_op("shape", nondiff=("Input",))
def _shape(ctx, ins, attrs):
    """The input's static shape as int32, made once per plan."""
    shp = list(ins["Input"][0].shape)
    return {"Out": ctx.constant(lambda: torch.tensor(
        shp, dtype=torch.int32, device=ctx.device))}


@register_op("flatten2")
def _flatten2(ctx, ins, attrs):
    x = _x(ins)
    axis = attrs.get("axis", 1)
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": x.reshape(lead, -1)}


@register_op("flatten_contiguous_range")
def _flatten_range(ctx, ins, attrs):
    x = _x(ins)
    start = attrs.get("start_axis", 1) % x.dim()
    stop = attrs.get("stop_axis", -1) % x.dim()
    return {"Out": x.reshape(tuple(x.shape[:start]) + (-1,) +
                             tuple(x.shape[stop + 1:]))}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    x = _x(ins)
    return {"Y": list(torch.unbind(x, dim=attrs.get("axis", 0)))}


@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python slicing ``x[s:e:st]`` on each axis; a negative stride reads
    the flipped axis with the positive one."""
    x = ins["Input"][0]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        r = range(*slice(s, e, st).indices(x.shape[a]))
        idx = [slice(None)] * x.dim()
        if st > 0:
            idx[a] = slice(r.start, r.start + len(r) * st, st) \
                if len(r) else slice(0, 0)
            x = x[tuple(idx)]
        else:
            start = x.shape[a] - 1 - r.start
            idx[a] = slice(start, start + len(r) * -st, -st) \
                if len(r) else slice(0, 0)
            x = torch.flip(x, (a,))[tuple(idx)]
    return {"Out": x}


def clamped_read(x, coords):
    """``x[coords]`` as JAX indexing reads it: each coordinate wrapped from
    [-n, 0), then clamped into its axis for the value, while the gradient
    of a read whose coordinate was out of range is dropped (JAX's scatter
    transpose drops it). Advanced indexing: the gradient adds in a fixed
    order (the note above)."""
    ok = None
    safe = []
    for k, c in enumerate(coords):
        n = x.shape[k]
        c = wrap_index(c, n)
        inside = (c >= 0) & (c < n)
        ok = inside if ok is None else ok & inside
        safe.append(c.clamp(0, n - 1))
    out = x[tuple(safe)]
    ok = ok.reshape(tuple(ok.shape) + (1,) * (out.dim() - ok.dim()))
    return torch.where(ok, out, out.detach())


@register_op("gather_nd", nondiff=("Index",))
def _gather_nd(ctx, ins, attrs):
    """``x[tuple(index[..., k] for k)]`` as JAX indexes (``clamped_read``)."""
    x, index = ins["X"][0], ins["Index"][0]
    return {"Out": clamped_read(x, [index[..., k]
                                    for k in range(index.shape[-1])])}


@register_op("scatter", nondiff=("Ids",))
def _scatter(ctx, ins, attrs):
    """Rows of X replaced by (``overwrite``) or added to the Updates rows
    their Ids name; an id in [-n, 0) wraps, one out of range is dropped.
    Repeated ids under ``overwrite``: the last update wins, on either
    device (found by a max over update positions, which needs no order)."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    n = x.shape[0]
    idx = wrap_index(ids.reshape(-1), n)
    ok = (idx >= 0) & (idx < n)
    updates = updates.reshape((idx.shape[0],) + tuple(x.shape[1:]))
    if not attrs.get("overwrite", True):
        return {"Out": add_rows(x, idx, ok, updates)}
    pos = torch.arange(idx.shape[0], device=x.device)
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=x.device)
    winner = winner.scatter_reduce(0, torch.where(ok, idx, n), pos, "amax")
    winner = winner[:n]
    won = (winner >= 0).reshape((n,) + (1,) * (x.dim() - 1))
    return {"Out": torch.where(won, updates[winner.clamp(min=0)], x)}


@register_op("scatter_nd_add", nondiff=("Index",))
def _scatter_nd_add(ctx, ins, attrs):
    """``x.at[tuple(index[..., k] for k)].add(updates)``: coordinates
    wrapped from [-n, 0), an update with a coordinate out of range
    dropped; the adds land in a fixed order (module note)."""
    x, index, updates = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    k = index.shape[-1]
    lead = tuple(x.shape[:k])
    rest = tuple(x.shape[k:])
    flat = torch.zeros(index.shape[:-1], dtype=torch.long, device=x.device)
    ok = torch.ones(index.shape[:-1], dtype=torch.bool, device=x.device)
    for j in range(k):
        c = wrap_index(index[..., j], lead[j])
        ok = ok & (c >= 0) & (c < lead[j])
        flat = flat * lead[j] + c
    out = add_rows(x.reshape((-1,) + rest), flat.reshape(-1),
                        ok.reshape(-1), updates.reshape((-1,) + rest))
    return {"Out": out.reshape(x.shape)}


def _take_along(x, idx, axis):
    """``x`` read along ``axis`` at ``idx`` (broadcast against x on the
    other axes) by advanced indexing; ``idx`` must be in range."""
    axis = axis % x.dim()
    shape = torch.broadcast_shapes(
        tuple(s if i != axis else 1 for i, s in enumerate(x.shape)),
        tuple(s if i != axis else 1 for i, s in enumerate(idx.shape)))
    full = list(shape)
    full[axis] = idx.shape[axis]
    coords = []
    for i in range(x.dim()):
        if i == axis:
            coords.append(idx.expand(full))
        else:
            ar = torch.arange(shape[i], device=x.device).reshape(
                [-1 if j == i else 1 for j in range(x.dim())])
            coords.append(ar.expand(full) if x.shape[i] != 1
                          else torch.zeros(full, dtype=torch.long,
                                           device=x.device))
    return x[tuple(coords)]


@register_op("index_select", nondiff=("Index",))
def _index_select(ctx, ins, attrs):
    """``jnp.take(x, index, axis=dim)``: [-n, 0) wraps, an index out of
    range reads ``_fill_value`` (``take_fill``); rows read by advanced
    indexing, so the gradient sums in a fixed order."""
    x, index = ins["X"][0], ins["Index"][0]
    axis = attrs.get("dim", 0) % x.dim()
    safe, ok = take_fill(index, x.shape[axis])
    idx = [slice(None)] * axis + [safe]
    return {"Out": fill_taken(x[tuple(idx)], ok, axis, safe.dim())}


@register_op("take_along_axis", nondiff=("Index",))
def _take_along_axis(ctx, ins, attrs):
    """``jnp.take_along_axis(x, index, axis)``: [-n, 0) wraps, an index
    out of range reads ``_fill_value`` (JAX's fill mode)."""
    x, index = ins["Input"][0], ins["Index"][0]
    axis = attrs.get("Axis", 0) % x.dim()
    safe, ok = take_fill(index, x.shape[axis])
    out = _take_along(x, safe, axis)
    fill = torch.full((), _fill_value(out.dtype), dtype=out.dtype,
                      device=out.device)
    return {"Result": torch.where(ok.expand(out.shape), out, fill)}


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    x, target = ins["X"][0], ins["target_tensor"][0]
    return {"Out": torch.tile(x, tuple(t // s for t, s in
                                       zip(target.shape, x.shape)))}


@register_op("tile")
def _tile(ctx, ins, attrs):
    """``jnp.tile``: fewer repeats than axes repeat the trailing ones."""
    return {"Out": torch.tile(_x(ins), tuple(attrs["repeat_times"]))}


def _host_scalar(t):
    """A 1-element tensor's value on the host (a sync on the card)."""
    return t.reshape(()).item()


@register_op("range", nondiff=("Start", "End", "Step"), syncs_host=True)
def _range(ctx, ins, attrs):
    """start + step * arange(ceil((end - start) / step)) in f32, cast to
    Start's dtype. The length is read on the host."""
    start = ins["Start"][0]
    s = float(_host_scalar(start))
    e = float(_host_scalar(ins["End"][0]))
    st = float(_host_scalar(ins["Step"][0]))
    n = max(0, int(math.ceil((e - s) / st)))
    ar = torch.arange(n, dtype=torch.float32, device=start.device)
    return {"Out": (s + st * ar).to(start.dtype)}


@register_op("linspace", nondiff=("Start", "Stop", "Num"), syncs_host=True)
def _linspace(ctx, ins, attrs):
    """``jnp.linspace``: start * (1 - i/(n-1)) + stop * i/(n-1) in f32,
    the last value ``stop``; Start, Stop and Num read on the host."""
    start = ins["Start"][0]
    s = float(_host_scalar(start))
    e = float(_host_scalar(ins["Stop"][0]))
    n = int(_host_scalar(ins["Num"][0]))
    dev = start.device
    if n <= 1:
        out = torch.full((max(n, 0),), s, dtype=torch.float32, device=dev)
    else:
        step = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
        out = torch.cat([s * (1 - step) + e * step,
                         torch.full((1,), e, dtype=torch.float32,
                                    device=dev)])
    if not start.is_floating_point():
        out = torch.floor(out)
    return {"Out": out.to(start.dtype)}


@register_op("arg_min", nondiff=("X",))
def _arg_min(ctx, ins, attrs):
    """int64 index of the smallest along ``axis``, the first on a tie."""
    return {"Out": torch.argmin(_x(ins), dim=attrs.get("axis", -1))}


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    """A stable sort along ``axis``, as ``jnp.argsort`` of X (ascending)
    or of -X (descending: ties keep their order and NaN goes last, where
    torch's ``descending=True`` would put NaN first). Out is X read at the
    indices; the index is a permutation, so each element's gradient is
    one add."""
    x = _x(ins)
    axis = attrs.get("axis", -1)
    key = x
    if attrs.get("descending", False):
        # an int64 tensor holds the JAX package's int32, whose negation
        # wraps at its smallest value: negate in int32 to sort alike
        key = -(x.to(torch.int32) if x.dtype == torch.int64 else x)
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": torch.gather(x, axis, idx), "Indices": idx}


@register_op("where_index", nondiff=("Condition",), syncs_host=True)
def _where_index(ctx, ins, attrs):
    """(k, ndim) int64 coordinates of the true elements: its shape
    depends on the data, so it is read on the host."""
    return {"Out": torch.nonzero(ins["Condition"][0]).long()}


@register_op("roll")
def _roll(ctx, ins, attrs):
    return {"Out": torch.roll(_x(ins), tuple(attrs["shifts"]),
                              tuple(attrs["axis"]))}


@register_op("tril_triu")
def _tril_triu(ctx, ins, attrs):
    x = _x(ins)
    k = attrs.get("diagonal", 0)
    fn = torch.tril if attrs.get("lower", True) else torch.triu
    return {"Out": fn(x, k)}


@register_op("eye")
def _eye(ctx, ins, attrs):
    n = attrs["num_rows"]
    return {"Out": torch.eye(n, attrs.get("num_columns", n),
                             dtype=to_torch_dtype(attrs.get("dtype",
                                                            "float32")),
                             device=ctx.device)}


@register_op("diag")
def _diag(ctx, ins, attrs):
    """A vector into a square diagonal matrix (a matrix: its diagonal),
    as ``jnp.diag``."""
    return {"Out": torch.diag(ins["Diagonal"][0])}


@register_op("meshgrid")
def _meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("coalesce_tensor")
def _coalesce_tensor(ctx, ins, attrs):
    """The inputs passed on, and one flat tensor of them all (the
    reference fuses gradients into one buffer for a collective)."""
    xs = list(ins["Input"])
    return {"Output": xs,
            "FusedOutput": torch.cat([x.reshape(-1) for x in xs])}


@register_op("load_tensor", differentiable=False, syncs_host=True)
def _load_tensor(ctx, ins, attrs):
    """A ``.npy`` file read on the host (``layers.load``)."""
    arr = np.load(attrs["file_path"])
    if attrs.get("load_as_fp16"):
        arr = arr.astype(np.float16)
    return {"Out": torch.from_numpy(np.ascontiguousarray(arr)).to(
        ctx.device)}
