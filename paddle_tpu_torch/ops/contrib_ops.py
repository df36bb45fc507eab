"""Contrib op kernels (counterparts of paddle_tpu/ops/contrib_ops.py):
the text-matching ops ``shuffle_batch``, ``match_matrix_tensor``,
``sequence_topk_avg_pooling`` and ``var_conv_2d``, and ``tree_conv``.
Plain jnp in the JAX package, plain torch here: ragged inputs are padded
tensors with length vectors, trees one-hot adjacency matrices, products
einsums.
"""
import torch
import torch.nn.functional as F

from .registry import register_op
from .tensor_ops import _float_order_key


def _one_hot(idx, m):
    """One-hot rows of ``idx`` over ``m`` classes; an index outside
    [0, m) gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(m, device=idx.device)).float()


def _tree_eta(depth, max_depth, pos, n_sib):
    """Continuous-binary-tree interpolation weights (TBCNN, Mou et al.):
    eta_t favors patch roots, eta_l/eta_r split by sibling position."""
    eta_t = (max_depth - depth) / max_depth if max_depth > 1 else 1.0
    frac = torch.where(n_sib > 1,
                       (pos - 1.0) / torch.clamp(n_sib - 1.0, min=1.0),
                       torch.full_like(pos, 0.5))
    eta_r = (1.0 - eta_t) * frac
    eta_l = (1.0 - eta_t) * (1.0 - frac)
    return eta_t, eta_l, eta_r


@register_op("tree_conv", nondiff=("EdgeSet",))
def _tree_conv(ctx, ins, attrs):
    """Tree-based convolution (paddle_tpu's :106, ref contrib nn.py:372,
    operators/tree_conv_op.*): nodes (N, M, F), edge_set (N, E, 2) int
    rows [parent, child] (negative = padding), filter (F, 3, H, K) ->
    Out (N, M, H, K). One (M, M) descendant matrix per depth level, built
    by repeated products of the child adjacency."""
    nodes, edges, filt = ins["NodesVector"][0], ins["EdgeSet"][0], \
        ins["Filter"][0]
    max_depth = int(attrs.get("max_depth", 2))
    m = nodes.shape[1]
    parent = edges[:, :, 0].long()
    child = edges[:, :, 1].long()
    valid = ((parent >= 0) & (child >= 0)).float()[..., None]
    oh_p = _one_hot(torch.where(parent >= 0, parent, 0), m) * valid
    oh_c = _one_hot(torch.where(child >= 0, child, 0), m) * valid
    adj = torch.einsum("bep,bec->bpc", oh_p, oh_c)
    # sibling order = edge order: position of each child among its
    # parent's earlier edges
    order = torch.cumsum(oh_p, dim=1)
    pos_e = torch.einsum("bem,bem->be", order, oh_p)  # 1-based position
    pos = torch.einsum("be,bep,bec->bpc", pos_e, oh_p, oh_c)
    n_sib = torch.sum(adj, dim=2, keepdim=True)
    nf = nodes.float()
    wt, wl, wr = filt[:, 0], filt[:, 1], filt[:, 2]  # (F, H, K)
    md = float(max_depth)

    def level_feature(level_adj, level_pos, depth):
        eta_t, eta_l, eta_r = _tree_eta(float(depth), md, level_pos,
                                        n_sib.expand_as(level_pos))
        mask = (level_adj > 0).float()
        out = 0
        for eta, w in ((eta_t, wt), (eta_l, wl), (eta_r, wr)):
            gathered = torch.einsum("bpc,bcf->bpf", eta * mask, nf)
            out = out + torch.einsum("bpf,fhk->bphk", gathered, w)
        return out

    # depth 0: the node itself is the patch root (eta_t = 1)
    out = torch.einsum("bmf,fhk->bmhk", nf, wt)
    level_adj, level_pos = adj, pos
    for depth in range(1, max_depth):
        out = out + level_feature(level_adj, level_pos, depth)
        if depth + 1 < max_depth:
            # descendants one level deeper; positions propagate from the
            # first hop (the sibling split happens at the top branching)
            level_adj = torch.einsum("bpc,bcd->bpd", level_adj, adj)
            level_pos = torch.einsum("bpc,bcd->bpd", pos, (adj > 0).float())
            level_pos = torch.where(level_adj > 0,
                                    torch.clamp(level_pos, min=1.0),
                                    torch.zeros_like(level_pos))
    return {"Out": out.to(nodes.dtype)}


@register_op("shuffle_batch", uses_rng=True, nondiff=("Seed",))
def _shuffle_batch(ctx, ins, attrs):
    """A random permutation of X's rows and the permutation (int64):
    from ``startup_seed`` when it is >= 0 (the same draw at every run),
    else from the run's draw; the permutation sorts random 62-bit keys.
    Both draw from the run context's generators, which a captured step
    keeps (a generator made inside a capture fails on the card)."""
    x = ins["X"][0]
    seed = int(attrs.get("startup_seed", -1))
    g = ctx.generator({"seed": seed + 1} if seed >= 0 else attrs)
    keys = torch.randint(0, 2 ** 62, (x.shape[0],), generator=g,
                         device=x.device)
    perm = torch.sort(keys, stable=True).indices
    return {"Out": x[perm], "ShuffleIdx": perm}


@register_op("match_matrix_tensor", nondiff=())
def _match_matrix_tensor(ctx, ins, attrs):
    """Bilinear match matrix: x (N, Tx, D1), y (N, Ty, D2), W (D1, C,
    D2) -> (N, C, Tx, Ty), out[n, c] = x[n] W[:, c, :] y[n]^T."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    out = torch.einsum("btd,dce,bse->bcts", x.float(), w.float(), y.float())
    return {"Out": out.to(x.dtype)}


@register_op("sequence_topk_avg_pooling", nondiff=("RowLen", "ColLen"))
def _sequence_topk_avg_pooling(ctx, ins, attrs):
    """For each k of ``topks``, the sum of each row's k largest valid
    columns over k: x (N, C, Tx, Ty) with row/col lengths (N,) -> (N, Tx,
    C * len(topks)), rows past their length 0. The columns are ordered
    as the JAX package's ``-sort(-x)`` orders them (descending, equal
    values lower index first, -0.0 equal to 0.0: ``_float_order_key`` of
    x + 0.0), so a tie's gradient goes to the same column."""
    x = ins["X"][0]
    row_len = ins["RowLen"][0].long()
    col_len = ins["ColLen"][0].long()
    topks = [int(k) for k in attrs["topks"]]
    n, c, tx, ty = x.shape
    dev = x.device
    col_mask = torch.arange(ty, device=dev) < col_len[:, None, None, None]
    neg = torch.full((), torch.finfo(torch.float32).min, dtype=x.dtype,
                     device=dev)
    masked = torch.where(col_mask, x, neg)
    order = torch.sort(_float_order_key(masked + 0.0), dim=-1,
                       descending=True).indices
    srt = torch.gather(masked, -1, order)
    n_valid = col_mask.to(x.dtype).sum(-1)                   # (N, 1, 1)
    csum = torch.cumsum(torch.where(srt <= neg / 2, torch.zeros_like(srt),
                                    srt), dim=-1)
    outs = []
    for k in topks:
        kk = torch.clamp(torch.clamp(n_valid, min=1.0), max=float(k))
        idx = torch.clamp(kk.long() - 1, 0, ty - 1)
        top = torch.gather(csum, -1, idx[..., None].expand(n, c, tx, 1))
        outs.append(top[..., 0] / float(k))
    out = torch.stack(outs, dim=-1).permute(0, 2, 1, 3) \
        .reshape(n, tx, c * len(topks))
    rows = (torch.arange(tx, device=dev) < row_len[:, None])[..., None]
    return {"Out": torch.where(rows, out, torch.zeros((), dtype=out.dtype,
                                                      device=dev))}


def _same_pads(size, k, s):
    """XLA's "SAME" padding of one dim: (low, high) with the total
    max((ceil(size / s) - 1) * s + k - size, 0), the low side total // 2."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@register_op("var_conv_2d", nondiff=("RowLen", "ColLen"))
def _var_conv_2d(ctx, ins, attrs):
    """A dense conv2d of the padded batch with XLA's "SAME" padding (also
    at a stride above 1, padded explicitly: ``_same_pads``), outputs past
    each sample's ceil(rows / stride) x ceil(cols / stride) zeroed."""
    x, w = ins["X"][0], ins["W"][0]
    row_len = ins["RowLen"][0].long()
    col_len = ins["ColLen"][0].long()
    st = [int(v) for v in attrs.get("stride", [1, 1])]
    ph = _same_pads(x.shape[2], w.shape[2], st[0])
    pw = _same_pads(x.shape[3], w.shape[3], st[1])
    out = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=st)
    h_out, w_out = out.shape[2], out.shape[3]
    r = (row_len + st[0] - 1) // st[0]
    c = (col_len + st[1] - 1) // st[1]
    dev = x.device
    keep = (torch.arange(h_out, device=dev)[:, None] < r[:, None, None, None]) \
        & (torch.arange(w_out, device=dev) < c[:, None, None, None])
    return {"Out": torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                      device=dev))}
