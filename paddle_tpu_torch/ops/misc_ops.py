"""Misc op kernels (counterparts of every op of paddle_tpu/ops/
misc_ops.py): multiplex, crop, cos_sim, bilinear_tensor_product, unique
and unique_with_counts (static shapes: padded to len(X), with the count
of distinct values), mean_iou, chunk_eval (begin and end masks and a
running max of start positions), data_norm (its accumulators written
back under their own names), spectral_norm and py_func (a host
function; a program holding one is run op by op on the card). Plain jnp
in the JAX package, plain torch here.
"""
import numpy as np
import torch

from .registry import register_op
from .tensor_ops import clamped_read


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, i] = x[b] @ W[i] @ y[b] (+ bias), one einsum
    (paddle_tpu's :52)."""
    x, w, y = ins["X"][0], ins["Weight"][0], ins["Y"][0]
    out = torch.einsum("bm,imn,bn->bi", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": out}


@register_op("spectral_norm", nondiff=("U", "V"))
def _spectral_norm(ctx, ins, attrs):
    """Power iteration on W reshaped to (h, w) with ``dim`` moved first;
    Out = W / sigma (paddle_tpu's :257, ref spectral_norm_op.h). The U/V
    iterates are constants to the gradient, as in the reference."""
    w = ins["Weight"][0]
    u = ins["U"][0]                        # (h,)
    v = ins["V"][0]                        # (w,)
    dim = int(attrs.get("dim", 0))
    power_iters = int(attrs.get("power_iters", 1))
    eps = float(attrs.get("eps", 1e-12))
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    wm = w.permute(perm)
    wmat = wm.reshape(wm.shape[0], -1)

    def l2n(a):
        return a / torch.clamp(torch.linalg.vector_norm(a), min=eps)

    for _ in range(power_iters):
        v = l2n(wmat.t() @ u)
        u = l2n(wmat @ v)
    u, v = u.detach(), v.detach()
    sigma = u @ (wmat @ v)
    out = (wmat / sigma).reshape(wm.shape)
    inv = [perm.index(i) for i in range(w.dim())]
    return {"Out": out.permute(inv), "UOut": u, "VOut": v}


# ---- the op library's misc ops (paddle_tpu/ops/misc_ops.py) --------------

@register_op("multiplex", nondiff=("Ids",))
def _multiplex(ctx, ins, attrs):
    """out[i] = X[ids[i]][i], read as JAX indexing reads it
    (``tensor_ops.clamped_read``)."""
    xs = torch.stack(ins["X"], dim=0)
    ids = ins["Ids"][0].reshape(-1)
    rows = torch.arange(xs.shape[1], device=xs.device)
    return {"Out": clamped_read(xs, [ids, rows])}


@register_op("crop", nondiff=("Y", "Offsets"))
def _crop(ctx, ins, attrs):
    """X sliced to ``shape`` (or Y's shape) at ``offsets``."""
    x = ins["X"][0]
    shape = attrs.get("shape")
    if shape is None and ins.get("Y"):
        shape = list(ins["Y"][0].shape)
    offsets = attrs.get("offsets") or [0] * x.dim()
    return {"Out": x[tuple(slice(int(o), int(o) + int(s))
                           for o, s in zip(offsets, shape))]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine of X and Y (Y may be one row, broadcast), the
    norms' product floored at 1e-12; XNorm and YNorm (rows, 1)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    num = torch.sum(x * y, dim=1, keepdim=True)
    return {"Out": num / torch.clamp(xn * yn, min=1e-12), "XNorm": xn,
            "YNorm": yn}


def _unique_parts(x):
    """(sorted values, each sorted element's group id, the sort's order,
    the number of distinct values) of flat ``x``, all on the device."""
    s, order = torch.sort(x, stable=True)
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    gid = torch.cumsum(new.long(), 0) - 1
    return s, gid, order, new.sum().to(torch.int32)


def _unique(x, counts):
    """``jnp.unique(x, return_inverse=True, size=len(x))`` with static
    shapes: the sorted distinct values, padded to len(x) with the
    smallest value (``fill_value=None``), each element's index among
    them (int32), with ``counts`` each value's count (0 in the pad), and
    the number of distinct values. Written by a scatter whose colliding
    writes carry equal values, so the result has no order to depend
    on."""
    n = x.shape[0]
    s, gid, order, count = _unique_parts(x)
    uniq = torch.full_like(s, 0).index_put((gid,), s)
    pad = torch.arange(n, device=x.device) >= count
    uniq = torch.where(pad, s[:1].expand(n), uniq)
    inverse = torch.empty_like(gid).index_put((order,), gid)
    out = {"Out": uniq, "Index": inverse.to(torch.int32), "Count": count}
    if counts:
        out["Counts"] = torch.zeros(n, dtype=torch.int32,
                                    device=x.device).index_put(
            (gid,), torch.ones_like(gid, dtype=torch.int32),
            accumulate=True)
    return out


@register_op("unique", nondiff=("X",), differentiable=False)
def _unique_op(ctx, ins, attrs):
    """Static shapes, as the JAX op (paddle_tpu's :71): Out padded to
    len(X), Count the number of distinct values; Index has X's shape."""
    x = ins["X"][0]
    out = _unique(x.reshape(-1), False)
    out["Index"] = out["Index"].reshape(x.shape)
    return out


@register_op("unique_with_counts", nondiff=("X",), differentiable=False)
def _unique_with_counts(ctx, ins, attrs):
    return _unique(ins["X"][0].reshape(-1), True)


def _one_hot_rows(ids, depth):
    """f32 one-hot rows; an id outside [0, depth) gives zeros."""
    return (ids[:, None] == torch.arange(depth, device=ids.device)).float()


@register_op("mean_iou", nondiff=("Predictions", "Labels"),
             differentiable=False)
def _mean_iou(ctx, ins, attrs):
    """Each class's IoU from one-hot confusion counts, averaged over the
    classes that appear (paddle_tpu's :96)."""
    nc = int(attrs["num_classes"])
    oh_p = _one_hot_rows(ins["Predictions"][0].reshape(-1).long(), nc)
    oh_l = _one_hot_rows(ins["Labels"][0].reshape(-1).long(), nc)
    inter = torch.sum(oh_p * oh_l, dim=0)
    np_ = torch.sum(oh_p, dim=0)
    nl = torch.sum(oh_l, dim=0)
    union = np_ + nl - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(union))
    denom = torch.clamp(present.float().sum(), min=1.0)
    return {"OutMeanIou": iou.sum() / denom,
            "OutWrong": (np_ + nl - 2 * inter).to(torch.int32),
            "OutCorrect": inter.to(torch.int32)}


# chunk_eval's schemes: (tag types, begin, inside, end, single)
_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _shift(t, fill, right):
    """``t`` shifted one step along axis 1 (``right``: t[i-1] at i),
    ``fill`` entering at the open end."""
    edge = torch.full_like(t[:, :1], fill)
    return torch.cat([edge, t[:, :-1]], 1) if right else \
        torch.cat([t[:, 1:], edge], 1)


def _chunk_begin_end(tag, typ, tb, ti, te, ts, other, seq_mask):
    """begin[i]: position i starts a chunk; end[i]: it ends one
    (paddle_tpu's ``_chunk_begin_end``, chunk_eval_op.h's ChunkBegin and
    ChunkEnd)."""
    prev_tag, prev_typ = _shift(tag, -1, True), _shift(typ, other, True)
    in_other = typ == other
    diff_type = typ != prev_typ
    tag_rule = ((tag == tb) |
                ((tag == ti) & ((prev_tag == te) | (prev_tag == ts))) |
                ((tag == te) & ((prev_tag == te) | (prev_tag == ts))) |
                (tag == ts))
    begin = torch.where(prev_typ == other, ~in_other,
                        ~in_other & (diff_type | tag_rule)) & seq_mask
    next_tag, next_typ = _shift(tag, -1, False), _shift(typ, other, False)
    n_other = next_typ == other
    n_diff = next_typ != typ
    end_rule = (((tag == tb) & ((next_tag == tb) | (next_tag == ts))) |
                ((tag == ti) & ((next_tag == tb) | (next_tag == ts))) |
                (tag == te) | (tag == ts))
    ends = ~in_other & (n_other | n_diff | end_rule)
    last = torch.cat([~seq_mask[:, 1:], torch.ones_like(seq_mask[:, :1])],
                     1) & seq_mask
    in_chunk = ~in_other & seq_mask
    return begin & in_chunk, in_chunk & (last | ends)


@register_op("chunk_eval", nondiff=("Inference", "Label", "SeqLength"),
             differentiable=False)
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 of Inference against Label (dense
    (B, T) tags, SeqLength masking each row): the segments found by begin
    and end masks and a running max of start positions
    (paddle_tpu's :180)."""
    inf, lab = ins["Inference"][0], ins["Label"][0]
    if inf.dim() > 2:
        inf = inf.reshape(inf.shape[0], -1)
        lab = lab.reshape(lab.shape[0], -1)
    b, t = inf.shape
    pos = torch.arange(t, device=inf.device)
    if ins.get("SeqLength"):
        seq_mask = pos[None, :] < ins["SeqLength"][0].reshape(-1, 1)
    else:
        seq_mask = torch.ones((b, t), dtype=torch.bool, device=inf.device)
    ntt, tb, ti, te, ts = _SCHEMES[attrs.get("chunk_scheme", "IOB")]
    other = int(attrs["num_chunk_types"])
    excluded = attrs.get("excluded_chunk_types") or []

    def seg(x):
        x = x.long()
        tag, typ = x % ntt, x // ntt
        begin, end = _chunk_begin_end(tag, typ, tb, ti, te, ts, other,
                                      seq_mask)
        start = torch.cummax(torch.where(begin, pos[None, :],
                                         torch.full_like(tag, -1)), 1).values
        keep = torch.ones_like(begin)
        for e in excluded:
            keep = keep & (typ != int(e))
        return begin & keep, end & keep, start, typ

    b_i, e_i, s_i, ty_i = seg(inf)
    b_l, e_l, s_l, ty_l = seg(lab)
    num_inf = b_i.sum()
    num_lab = b_l.sum()
    correct = (e_i & e_l & (s_i == s_l) & (ty_i == ty_l)).sum()
    zero = torch.zeros((), device=inf.device)
    p = torch.where(num_inf > 0, correct / torch.clamp(num_inf, min=1), zero)
    r = torch.where(num_lab > 0, correct / torch.clamp(num_lab, min=1), zero)
    f1 = torch.where(correct > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     zero)
    return {"Precision": p.reshape(1).float(),
            "Recall": r.reshape(1).float(),
            "F1-Score": f1.reshape(1).float(),
            "NumInferChunks": num_inf.reshape(1).to(torch.int32),
            "NumLabelChunks": num_lab.reshape(1).to(torch.int32),
            "NumCorrectChunks": correct.reshape(1).to(torch.int32)}


@register_op("data_norm", nondiff=("BatchSize", "BatchSum",
                                   "BatchSquareSum"))
def _data_norm(ctx, ins, attrs):
    """y = (x - sum/size) * sqrt(size/square_sum), and the accumulators
    moved by this batch, written back under their own names as
    batch_norm's moving statistics are (paddle_tpu's :234)."""
    x = ins["X"][0]
    bsize, bsum, bsq = (ins["BatchSize"][0], ins["BatchSum"][0],
                        ins["BatchSquareSum"][0])
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsq)
    y = (x - means[None, :]) * scales[None, :]
    xd = x.detach()
    return {"Y": y, "Means": means, "Scales": scales,
            "BatchSizeOut": bsize + x.shape[0],
            "BatchSumOut": bsum + torch.sum(xd, dim=0),
            "BatchSquareSumOut": bsq + torch.sum(
                torch.square(xd - means[None, :]), dim=0)}


# py_func: the host's escape hatch. The function objects live in a
# process-local table (as in the JAX package and the reference), so a
# program holding py_func runs in the process that built it.
_PY_FUNC_REGISTRY = {}


def register_py_func(func, backward_func=None):
    fid = len(_PY_FUNC_REGISTRY)
    _PY_FUNC_REGISTRY[fid] = (func, backward_func)
    return fid


def _host_results(res, metas, device):
    """The host function's results as tensors of the declared shapes
    and dtypes."""
    if not isinstance(res, (list, tuple)):
        res = [res]
    if len(res) != len(metas):
        raise ValueError("py_func returned %d values, declared %d outputs"
                         % (len(res), len(metas)))
    return [torch.from_numpy(np.ascontiguousarray(
        np.asarray(r, dtype=dt).reshape(shape))).to(device)
        for r, (shape, dt) in zip(res, metas)]


class _PyFunc(torch.autograd.Function):
    """The host function in the forward and ``backward_func(*inputs,
    *outputs, *out_grads)`` in the backward (None: zeros), each on numpy
    copies; only floating inputs take a gradient."""

    @staticmethod
    def forward(ctx, fid, metas, *xs):
        func = _PY_FUNC_REGISTRY[fid][0]
        outs = _host_results(func(*[x.detach().cpu().numpy() for x in xs]),
                             metas, xs[0].device if xs else "cpu")
        ctx.fid = fid
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        bwd = _PY_FUNC_REGISTRY[ctx.fid][1]
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        arrays = [t.detach().cpu().numpy() for t in list(xs) + list(outs)]
        arrays += [g.detach().cpu().numpy() for g in gouts]
        gs = bwd(*arrays)
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        grads = []
        for x, g in zip(xs, gs):
            if not x.is_floating_point():
                grads.append(None)
            elif g is None:
                grads.append(torch.zeros_like(x))
            else:
                grads.append(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(g, dtype=_np_dtype(x.dtype)).reshape(
                        x.shape))).to(x.device))
        return (None, None) + tuple(grads)


def _np_dtype(dt):
    return torch.empty((), dtype=dt).numpy().dtype


@register_op("py_func", syncs_host=True)
def _py_func(ctx, ins, attrs):
    """A host Python function on numpy copies of X (paddle_tpu's :314):
    the step is never captured on the card. Without a backward function
    the outputs carry no gradient, as in the reference."""
    func, bwd = _PY_FUNC_REGISTRY[attrs["func_id"]]
    metas = [(tuple(s), np.dtype(d)) for s, d in attrs["out_meta"]]
    xs = list(ins["X"])
    device = xs[0].device if xs else ctx.device
    if bwd is None:
        outs = _host_results(func(*[x.detach().cpu().numpy() for x in xs]),
                             metas, device)
        return {"Out": outs}
    return {"Out": list(_PyFunc.apply(attrs["func_id"], metas, *xs))}
