"""Contrib op kernels the dygraph layers run: tree_conv (counterpart in
paddle_tpu/ops/contrib_ops.py; the rest of that module waits for the op
library). Plain jnp in the JAX package, plain torch here: one-hot
adjacency matrices and batched einsums.
"""
import torch

from .registry import register_op


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
