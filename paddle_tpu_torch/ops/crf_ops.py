"""Linear-chain CRF and CTC op kernels (counterparts in
paddle_tpu/ops/crf_ops.py, where each recursion is a ``lax.scan``).

Dense (N, T, C) emissions with (N,) lengths. The forward algorithm, the
Viterbi decode and the CTC alpha recursion are Python loops over time of
plain torch ops; autograd through the loop is the backward. The
transition parameter is laid out as the reference's: w[0] = start,
w[1] = stop, w[2:2 + C] = transition[from, to].

Where the JAX ops pick values by label (``take_along_axis`` into the
emissions, ``trans[prev, label]``), these multiply by one-hot rows and
sum, or take one product with them: a product with 0 and 1 and a sum
with zeros are exact, so the values are the same, and the gradient is a
product or a sum, which a CUDA card computes in a fixed order. A
gather's gradient scatters with atomics there, and labels repeat (CTC's
blanks, a tag seen twice), so its sums would arrive in no fixed order
and a CUDA-graph replay would not equal an op-by-op run bit for bit.
"""
import torch
import torch.nn.functional as F

from .registry import register_op

# CTC's log zero: finite, as in the JAX op, whose logsumexp gradient at
# -inf is NaN
_NEG_INF = -1e30


def _one_hot(idx, depth, dtype):
    """(..., depth) rows, a row of zeros for an index outside [0, depth)
    (built by comparison: ``F.one_hot`` checks the range on the host)."""
    return (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        dtype)


def _lengths(ins, slot, n, full, device):
    if ins.get(slot):
        return ins[slot][0].reshape(-1).long()
    return torch.full((n,), full, dtype=torch.long, device=device)


def _labels(ins, slot):
    label = ins[slot][0]
    if label.dim() == 3:
        label = label.reshape(label.shape[:2])
    return label.long()


@register_op("linear_chain_crf", nondiff=("Label", "Length"))
def _linear_chain_crf(ctx, ins, attrs):
    """ins: Emission (N, T, C), Transition (C + 2, C), Label (N, T[, 1]),
    optional Length (N,). outs: LogLikelihood (N, 1), the gold path's
    score less the log partition function; Alpha, EmissionExps and
    TransitionExps carry no gradient. The partition function is the JAX
    op's recursion; the gold path's score sums its terms over time at
    once (the JAX op adds them step by step: the same terms, summed in
    another order)."""
    em = ins["Emission"][0].float()
    w = ins["Transition"][0].float()
    label = _labels(ins, "Label")
    n, t, c = em.shape
    start, stop, trans = w[0], w[1], w[2:]
    length = _lengths(ins, "Length", n, t, em.device)
    valid = torch.arange(t, device=em.device)[None, :] < length[:, None]

    em_steps = em.transpose(0, 1).unbind(0)
    valid_steps = valid.t()[:, :, None].unbind(0)
    alpha = start[None, :] + em_steps[0]
    for em_t, valid_t in zip(em_steps[1:], valid_steps[1:]):
        # alpha'(j) = logsumexp_i alpha(i) + trans(i, j) + em(j)
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + em_t
        alpha = torch.where(valid_t, new, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)

    hot = _one_hot(label, c, em.dtype)                       # (N, T, C)
    em_score = (em * hot).sum(-1)                            # (N, T)
    tr_score = ((hot[:, :-1] @ trans) * hot[:, 1:]).sum(-1)  # (N, T - 1)
    steps = torch.where(valid[:, 1:], em_score[:, 1:] + tr_score,
                        torch.zeros_like(tr_score))
    last = torch.gather(hot, 1, (length - 1).clamp(min=0)[:, None, None]
                        .expand(n, 1, c))[:, 0]
    path = (hot[:, 0] * start).sum(-1) + em_score[:, 0] + steps.sum(-1) + \
        (last * stop).sum(-1)
    with torch.no_grad():
        alpha_out, em_exps, tr_exps = alpha.clone(), em.exp(), w.exp()
    return {"LogLikelihood": (path - log_z)[:, None], "Alpha": alpha_out,
            "EmissionExps": em_exps, "TransitionExps": tr_exps}


@register_op("crf_decoding", nondiff=("Emission", "Transition", "Label",
                                      "Length"), differentiable=False)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode: ViterbiPath (N, T, 1) int64 (int32 in the JAX
    package, which runs without x64). Each step keeps the best previous
    label, the first on a tie (``torch.max``'s rule and
    ``jnp.argmax``'s); a padded step points to itself, and the path is 0
    past each row's length."""
    em = ins["Emission"][0].float()
    w = ins["Transition"][0].float()
    n, t, c = em.shape
    start, stop, trans = w[0], w[1], w[2:]
    length = _lengths(ins, "Length", n, t, em.device)
    valid = torch.arange(t, device=em.device)[None, :] < length[:, None]
    labels = torch.arange(c, device=em.device)[None, :]

    em_steps = em.transpose(0, 1).unbind(0)
    valid_steps = valid.t()[:, :, None].unbind(0)
    score = start[None, :] + em_steps[0]
    bps = []
    for em_t, valid_t in zip(em_steps[1:], valid_steps[1:]):
        best, best_prev = (score[:, :, None] + trans[None, :, :]).max(dim=1)
        score = torch.where(valid_t, best + em_t, score)
        bps.append(torch.where(valid_t, best_prev, labels))
    lbl = torch.argmax(score + stop[None, :], dim=1)
    path = [lbl]
    for bp in reversed(bps):
        lbl = torch.gather(bp, 1, lbl[:, None])[:, 0]
        path.append(lbl)
    path = torch.stack(path[::-1], dim=1)
    path = torch.where(valid, path, torch.zeros_like(path))
    return {"ViterbiPath": path[..., None]}


@register_op("warpctc", nondiff=("Label", "LogitsLength", "LabelLength"))
def _warpctc(ctx, ins, attrs):
    """CTC loss over the blank-interleaved labels (the reference wraps
    warp-ctc): Logits (T, N, C) unnormalised (log-softmax inside), Label
    (N, Lmax), optional LogitsLength and LabelLength (N,); attrs
    ``blank``, ``norm_by_times``. outs: Loss (N, 1).

    The JAX op's recursion: log-space alphas with the finite sentinel
    ``_NEG_INF``; an alignment that cannot fit (too few steps for the
    labels and the blanks they need) gives loss inf and a zero gradient
    for its row; ``norm_by_times`` scales the gradient by 1 / length and
    leaves the loss as it is. Each step's emissions come from one product
    with the one-hot rows of the extended labels, taken for every step
    before the loop."""
    logits = ins["Logits"][0].float()
    label = _labels(ins, "Label")
    t, n, c = logits.shape
    lmax = label.shape[1]
    blank = int(attrs.get("blank", 0))
    dev = logits.device
    in_len = _lengths(ins, "LogitsLength", n, t, dev)
    lbl_len = _lengths(ins, "LabelLength", n, lmax, dev)

    logp = F.log_softmax(logits, dim=-1)
    # extended sequence: blank, l1, blank, l2, ..., lL, blank: S = 2L + 1
    s = 2 * lmax + 1
    pos = torch.arange(s, device=dev)
    ext = torch.where(pos[None, :] % 2 == 1,
                      label[:, (pos // 2).clamp(0, lmax - 1)],
                      torch.full((1, s), blank, dtype=torch.long,
                                 device=dev))                 # (N, S)
    valid_s = pos[None, :] < (2 * lbl_len[:, None] + 1)
    # a skip into s is allowed when ext[s] is no blank and differs from
    # ext[s - 2]
    ext_m2 = torch.cat([torch.full((n, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], dim=1)
    allow_skip = (pos[None, :] >= 2) & (ext != blank) & (ext != ext_m2)
    emit = torch.matmul(logp.transpose(0, 1),
                        _one_hot(ext, c, logp.dtype).transpose(1, 2))
    emit_steps = emit.transpose(0, 1).unbind(0)              # T x (N, S)
    active = (torch.arange(1, t, device=dev)[:, None] <
              in_len[None, :])[:, :, None].unbind(0)        # T - 1 x (N, 1)
    neg = torch.full((n, s), _NEG_INF, device=dev)

    alpha = torch.where((pos[None, :] < 2) & valid_s, emit_steps[0], neg)
    for emit_t, active_t in zip(emit_steps[1:], active):
        a1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG_INF)
        a2 = torch.where(allow_skip,
                         F.pad(alpha[:, :-2], (2, 0), value=_NEG_INF), neg)
        tot = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0)
        new = torch.where(valid_s, tot + emit_t, neg)
        alpha = torch.where(active_t, new, alpha)

    # p(label) = alpha[2L] + alpha[2L - 1] at t = in_len - 1
    end = 2 * lbl_len
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end1 = torch.gather(alpha, 1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_end1 = torch.where(lbl_len > 0, a_end1, neg[:, 0])
    ll = torch.logaddexp(a_end, a_end1)
    loss = -ll
    if attrs.get("norm_by_times"):
        # the gradient scaled by 1 / length, the loss left as it is (while
        # the loss is finite, so an infeasible row gives no NaN)
        scale = 1.0 / in_len.float().clamp(min=1.0)
        loss = (loss * (1.0 - scale)).detach() + loss * scale
    loss = torch.where(ll > 0.5 * _NEG_INF, loss,
                       torch.full_like(loss, float("inf")))
    return {"Loss": loss[:, None]}
