"""Sequence op kernels (counterparts of every op of
paddle_tpu/ops/sequence_ops.py): dense (N, T, ...) tensors with an (N,)
length vector in place of the reference's ragged LoD rows. Rows are
read by advanced indexing and added with ``index_put_(accumulate=True)``
(ops/tensor_ops.py's note): ``sequence_expand``'s and
``sequence_slice``'s gradients and ``sequence_scatter``'s adds sum in a
fixed order on the card."""
import torch

from .registry import register_op
from .tensor_ops import add_rows, wrap_index


def _lengths(ins, n, t, device):
    if ins.get("Length"):
        return ins["Length"][0].reshape(-1).long()
    return torch.full((n,), t, dtype=torch.long, device=device)


@register_op("sequence_reverse", nondiff=("Length",))
def _sequence_reverse(ctx, ins, attrs):
    """Each row's valid prefix reversed, its padding left in place. The
    index is a permutation of each row, so the gradient's scatter adds
    one value to each element: its bits do not depend on the order of
    the adds."""
    x = ins["X"][0]
    n, t = x.shape[0], x.shape[1]
    lens = _lengths(ins, n, t, x.device)
    pos = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(pos < lens[:, None], lens[:, None] - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return {"Y": torch.gather(x, 1, idx)}


@register_op("reorder_by_rank", nondiff=("RankTable",))
def _reorder_by_rank(ctx, ins, attrs):
    """Rows stably sorted by descending length (reference
    reorder_lod_tensor_by_rank_op); the rank table is the (N,) lengths."""
    lens = ins["RankTable"][0].reshape(-1)
    order = torch.argsort(-lens.long(), stable=True)
    return {"Out": ins["X"][0].index_select(0, order)}


# ---- the op library's sequence ops (paddle_tpu/ops/sequence_ops.py) ------

def _trailing(mask, ndim):
    """(N, T) ``mask`` with ones appended up to ``ndim`` axes."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


def _rows_at(x, idx):
    """``x[n, idx[n, ...]]`` along axis 1 for an in-range (N, ...) ``idx``,
    by advanced indexing: the gradient adds in a fixed order
    (ops/tensor_ops.py's note)."""
    rows = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[rows, idx]


@register_op("sequence_erase", nondiff=("X", "Length"), differentiable=False)
def _sequence_erase(ctx, ins, attrs):
    """Each row with the listed tokens removed and the rest moved left in
    order (a stable sort of the removal mask), ``pad_value`` after the new
    length; OutLength int32 (paddle_tpu's :34)."""
    x = ins["X"][0]
    n, t = x.shape
    lens = _lengths(ins, n, t, x.device)
    pos = torch.arange(t, device=x.device)[None, :]
    keep = pos < lens[:, None]
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    gathered = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1).to(torch.int32)
    pad = torch.full((), attrs.get("pad_value", 0), dtype=x.dtype,
                     device=x.device)
    return {"Out": torch.where(pos < new_len[:, None], gathered, pad),
            "OutLength": new_len}


@register_op("sequence_enumerate", nondiff=("X", "Length"),
             differentiable=False)
def _sequence_enumerate(ctx, ins, attrs):
    """out[i, t, k] = x[i, t + k] while t + k is inside row i's length,
    else ``pad_value``."""
    x = ins["X"][0]
    n, t = x.shape
    lens = _lengths(ins, n, t, x.device)
    win = int(attrs["win_size"])
    pos = torch.arange(t, device=x.device)[None, :, None] + \
        torch.arange(win, device=x.device)[None, None, :]
    src = _rows_at(x, pos.clamp(max=t - 1).expand(n, t, win))
    pad = torch.full((), attrs.get("pad_value", 0), dtype=x.dtype,
                     device=x.device)
    return {"Out": torch.where(pos < lens[:, None, None], src, pad)}


@register_op("sequence_slice", nondiff=("Offset", "SliceLength", "Length"))
def _sequence_slice(ctx, ins, attrs):
    """Row i's steps offset[i] .. offset[i] + length[i], moved to the
    front, zeros after; the length is clamped to what the row holds
    (OutLength, int32) (paddle_tpu's :77)."""
    x = ins["X"][0]
    n, t = x.shape[0], x.shape[1]
    lens = _lengths(ins, n, t, x.device)
    offset = ins["Offset"][0].reshape(-1).long().clamp(min=0)
    slen = ins["SliceLength"][0].reshape(-1).long()
    eff = torch.minimum(slen.clamp(min=0), (lens - offset).clamp(min=0))
    pos = torch.arange(t, device=x.device)[None, :]
    out = _rows_at(x, (pos + offset[:, None]).clamp(0, t - 1))
    mask = _trailing(pos < eff[:, None], x.dim())
    return {"Out": torch.where(mask, out, torch.zeros((), dtype=x.dtype,
                                                      device=x.device)),
            "OutLength": eff.to(torch.int32)}


@register_op("sequence_expand_as", nondiff=("Y", "Length"))
def _sequence_expand_as(ctx, ins, attrs):
    """Row i of X repeated over Y's T steps, zeros past its length."""
    x, y = ins["X"][0], ins["Y"][0]
    t = y.shape[1]
    if x.dim() == 2:
        x = x[:, None, :]
    n = x.shape[0]
    lens = _lengths(ins, n, t, x.device)
    out = x.expand((n, t) + tuple(x.shape[2:]))
    mask = _trailing(torch.arange(t, device=x.device)[None, :] <
                     lens[:, None], out.dim())
    return {"Out": torch.where(mask, out, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))}


@register_op("sequence_pad_dense", nondiff=("Length",))
def _sequence_pad_dense(ctx, ins, attrs):
    """``pad_value`` past each row's length, T cut or padded to
    ``padded_length`` first; Length is the lengths capped at T
    (paddle_tpu's sequence_pad)."""
    x = ins["X"][0]
    n, t = x.shape[0], x.shape[1]
    lens = _lengths(ins, n, t, x.device)
    pad_value = attrs.get("pad_value", 0.0)
    maxlen = int(attrs.get("padded_length", -1))
    if maxlen > 0 and maxlen != t:
        if maxlen < t:
            x = x[:, :maxlen]
        else:
            x = torch.cat([x, torch.full(
                (n, maxlen - t) + tuple(x.shape[2:]), pad_value,
                dtype=x.dtype, device=x.device)], 1)
        t = maxlen
    mask = _trailing(torch.arange(t, device=x.device)[None, :] <
                     lens[:, None], x.dim())
    out = torch.where(mask, x, torch.full((), pad_value, dtype=x.dtype,
                                          device=x.device))
    return {"Out": out, "Length": lens.clamp(max=t).to(torch.int32)}


@register_op("sequence_expand", nondiff=("RepeatCounts",))
def _sequence_expand(ctx, ins, attrs):
    """Row i of X repeated RepeatCounts[i] times, packed from the top of
    an ``out_len``-row output, zero rows past the total; OutLength the
    total capped at out_len (paddle_tpu's :132). Rows read by advanced
    indexing: the gradient adds in a fixed order."""
    x = ins["X"][0]
    counts = ins["RepeatCounts"][0].reshape(-1).long()
    out_len = int(attrs["out_len"])
    cum = torch.cumsum(counts, 0)
    total = cum[-1].clamp(max=out_len)
    pos = torch.arange(out_len, device=x.device)
    row = torch.searchsorted(cum, pos, right=True).clamp(0, x.shape[0] - 1)
    mask = (pos < total).reshape((-1,) + (1,) * (x.dim() - 1))
    return {"Out": x[row] * mask.to(x.dtype),
            "OutLength": total.reshape(1).to(torch.int32)}


@register_op("sequence_scatter", nondiff=("Ids", "Length"))
def _sequence_scatter(ctx, ins, attrs):
    """x[n, ids[n, k]] += updates[n, k] for k below row n's length; an id
    in [-T, 0) wraps and one out of range is dropped, as JAX's scatter
    does. The adds land in a fixed order (ops/tensor_ops.py's note)."""
    x = ins["X"][0]
    ids = ins["Ids"][0].long()
    upd = ins["Updates"][0]
    n, k = ids.shape
    t = x.shape[1]
    if ins.get("Length"):
        lens = ins["Length"][0].reshape(-1)
        upd = upd * (torch.arange(k, device=x.device)[None, :] <
                     lens[:, None]).to(upd.dtype)
    ids = wrap_index(ids, t)
    ok = (ids >= 0) & (ids < t)
    flat = torch.arange(n, device=x.device)[:, None] * t + ids
    out = add_rows(x.reshape(-1), flat.reshape(-1), ok.reshape(-1),
                   upd.reshape(-1))
    return {"Out": out.reshape(x.shape)}
