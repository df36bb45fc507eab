"""Sequence op kernels (counterparts in paddle_tpu/ops/sequence_ops.py):
dense (N, T, ...) tensors with an (N,) length vector in place of the
reference's ragged LoD rows. ``sequence_reverse``, which the
bidirectional RNNs of ``contrib.layers.basic_gru`` and ``layers.rnn``
run, and ``reorder_by_rank`` (``layers.reorder_lod_tensor_by_rank``)."""
import torch

from .registry import register_op


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
