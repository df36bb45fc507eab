"""Loss op kernels (counterparts of every op of
paddle_tpu/ops/loss_extra_ops.py): teacher_student_sigmoid_loss,
center_loss (its centers written back), edit_distance, nce,
hierarchical_sigmoid and sampled_softmax_with_cross_entropy. Plain jnp
in the JAX package, plain torch here.

``nce`` and the sampled softmax draw their classes from the seeded
``torch.Generator`` that ``ctx.generator`` hands them (the dygraph
context's, or the Executor's): torch's Philox stream is not JAX's
threefry, so the two packages agree in distribution only; given the
same samples the loss is the same function (``nce_cost``,
``sampled_softmax_ce``).
"""
import math

import torch

from .math_ops import jnp_abs
from .registry import register_op
from .tensor_ops import add_rows, fill_taken, take_fill


def _softplus(x):
    """max(x, 0) + log1p(exp(-|x|)), the reference's stable spelling, with
    ``jnp.maximum``'s and ``jnp.abs``'s gradients at 0 (1/2 and 1), as
    the JAX package differentiates it."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) + torch.log1p(torch.exp(-jnp_abs(x)))


def sample_classes(generator, num_total, num_samples, sampler, device):
    """``num_samples`` noise classes in [0, num_total): uniform, or
    log-uniform (Zipfian) as the JAX package draws them."""
    if sampler == "log_uniform":
        u = torch.rand(num_samples, generator=generator, device=device)
        s = (torch.exp(u * math.log(num_total + 1.0)) - 1.0).to(torch.int64)
        return torch.clamp(s, 0, num_total - 1)
    return torch.randint(0, num_total, (num_samples,), generator=generator,
                         device=device)


def _sampler_prob(classes, num_total, sampler):
    if sampler == "log_uniform":
        c = classes.float()
        return torch.log((c + 2.0) / (c + 1.0)) / math.log(num_total + 1.0)
    return torch.full(classes.shape, 1.0 / num_total, device=classes.device)


def _rows(t, idx):
    """``t[idx]`` along axis 0 read as ``jnp.take`` (tensor_ops.take_fill)."""
    safe, ok = take_fill(idx, t.shape[0])
    return fill_taken(t[safe], ok, 0, idx.dim())


def nce_cost(x, label, w, b, neg, num_total, sampler):
    """The NCE cost (N, 1) of inputs x (N, D) with true classes ``label``
    (N,) against the noise classes ``neg`` (K,): a binary logistic on
    each, its score corrected by log(K * q(class))."""
    num_neg = neg.shape[0]
    xf = x.float()
    s_true = torch.sum(xf * _rows(w, label).float(), dim=1)
    s_neg = xf @ _rows(w, neg).float().t()
    if b is not None:
        s_true = s_true + _rows(b, label)
        s_neg = s_neg + _rows(b, neg)[None, :]
    logq_true = torch.log(num_neg * _sampler_prob(label, num_total, sampler)
                          + 1e-20)
    logq_neg = torch.log(num_neg * _sampler_prob(neg, num_total, sampler)
                         + 1e-20)
    loss = _softplus(-(s_true - logq_true)) + \
        torch.sum(_softplus(s_neg - logq_neg[None, :]), dim=1)
    return loss.reshape(-1, 1).to(x.dtype)


@register_op("nce", nondiff=("Label",), uses_rng=True)
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation (paddle_tpu's :128, ref nce_op.h)."""
    x = ins["Input"][0]                       # (N, D)
    label = ins["Label"][0].reshape(-1).long()
    w = ins["Weight"][0]                      # (C, D)
    b = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    num_total = int(attrs["num_total_classes"])
    sampler = attrs.get("sampler", "uniform")
    neg = sample_classes(ctx.generator(attrs), num_total,
                         int(attrs.get("num_neg_samples", 10)), sampler,
                         x.device)
    return {"Cost": nce_cost(x, label, w, b, neg, num_total, sampler)}


# ---- the op library's other losses (paddle_tpu/ops/loss_extra_ops.py) ---

@register_op("teacher_student_sigmoid_loss", nondiff=("Label",))
def _ts_sigmoid_loss(ctx, ins, attrs):
    """The CTR distillation loss's four label cases (label < -1: no
    teacher, no click; [-1, 0): no teacher, a click; [0, 1): teacher z',
    no click; >= 1: teacher z' + 1, a click), (N, 1)."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).float()
    base = _softplus(x)
    y = torch.where(label < -1.0, base,
                    torch.where(label < 0.0, base - x,
                                torch.where(label < 1.0,
                                            base + base - x * label,
                                            base - x + base -
                                            x * (label - 1.0))))
    return {"Y": y.reshape(-1, 1)}


@register_op("center_loss", nondiff=("Label", "Centers", "CenterUpdateRate"))
def _center_loss(ctx, ins, attrs):
    """0.5 ||x - center_label||^2 (N, 1); with ``update_center`` each
    class's center moves by alpha times its rows' summed differences over
    (1 + their count), written back onto Centers (paddle_tpu's :40). The
    centers are read as ``jnp.take`` reads them (an id out of range gives
    NaN) and the sums are added in a fixed order (ops/tensor_ops.py's
    note); an id out of range adds nothing."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1)
    centers = ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0].reshape(())
    c = centers.shape[0]
    picked = _rows(centers, label)
    diff = x.float() - picked.float()
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    new_centers = centers
    if attrs.get("update_center", True):
        safe, ok = take_fill(label, c)
        counts = add_rows(torch.zeros(c, device=x.device), safe, ok,
                          torch.ones_like(safe, dtype=torch.float32))
        accum = add_rows(torch.zeros((c, centers.shape[1]),
                                     device=x.device), safe, ok,
                         diff.detach())
        update = accum / (1.0 + counts)[:, None]
        new_centers = centers + alpha.to(centers.dtype) * \
            update.to(centers.dtype)
    return {"Loss": loss.to(x.dtype), "SampleCenterDiff": diff.to(x.dtype),
            "CentersOut": new_centers.detach()}


@register_op("edit_distance", nondiff=("Hyps", "Refs", "HypsLength",
                                       "RefsLength"), differentiable=False)
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each row of Hyps (N, Th) to Refs (N, Tr)
    within their lengths (paddle_tpu's :66), one DP row a step over the
    hypothesis: the left-to-right dependency of a row is a running
    minimum (``cummin`` of cell - j, plus j), so each step is a few
    whole-batch ops. Distances are whole numbers in f32: exact."""
    hyps, refs = ins["Hyps"][0], ins["Refs"][0]
    n, th = hyps.shape
    tr = refs.shape[1]
    dev = hyps.device
    hl = ins["HypsLength"][0].reshape(-1).long() if ins.get("HypsLength") \
        else torch.full((n,), th, dtype=torch.long, device=dev)
    rl = ins["RefsLength"][0].reshape(-1).long() if ins.get("RefsLength") \
        else torch.full((n,), tr, dtype=torch.long, device=dev)
    j = torch.arange(tr + 1, dtype=torch.float32, device=dev)
    row = torch.minimum(j[None, :].expand(n, tr + 1), rl[:, None].float())
    for i in range(th):
        sub = (hyps[:, i:i + 1] != refs).float()           # (N, Tr)
        cand = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        first = torch.full((n, 1), float(i + 1), device=dev)
        new = torch.cummin(torch.cat([first, cand], 1) - j, 1).values + j
        row = torch.where((i < hl)[:, None], new, row)
    dist = row.gather(1, rl.clamp(max=tr)[:, None]).reshape(n)
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(rl.float(), min=1.0)
    return {"Out": dist.reshape(n, 1),
            "SequenceNum": torch.full((1,), n, dtype=torch.int32,
                                      device=dev)}


@register_op("hierarchical_sigmoid", nondiff=("Label",))
def _hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the default complete binary tree
    (paddle_tpu's :164): leaf code label + C, path nodes its heap
    ancestors, each a sigmoid cross-entropy on the bit stepped through;
    only the path's weight rows are read (advanced indexing: the
    gradient adds in a fixed order)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    w = ins["W"][0]
    b = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    num_classes = int(attrs["num_classes"])
    depth = max(1, int(math.ceil(math.log2(num_classes))))
    code = label + num_classes
    xf = x.float()
    loss = torch.zeros(label.shape, device=x.device)
    path = []
    zero = torch.zeros((), device=x.device)
    for k in range(1, depth + 1):
        node = code >> k
        valid = node >= 1
        bit = ((code >> (k - 1)) & 1).float()
        idx = torch.clamp(node - 1, 0, num_classes - 2)
        s = torch.sum(xf * w[idx].float(), dim=1)
        if b is not None:
            s = s + b[idx]
        path.append(torch.where(valid, s, zero))
        loss = loss + torch.where(valid, _softplus(s) - s * bit, zero)
    return {"Out": loss.reshape(-1, 1).to(x.dtype),
            "PreOut": torch.stack(path, dim=1).to(x.dtype)}


def sampled_softmax_ce(logits, label, neg):
    """The sampled softmax cross-entropy (N, 1) given the sampled classes
    ``neg`` (S,): the true class's logit at column 0, each sampled logit
    corrected by log q (log-uniform), an accidental hit of the true class
    masked."""
    num_total = logits.shape[-1]
    n = logits.shape[0]
    safe, ok = take_fill(label, num_total)
    lt = fill_taken(logits[torch.arange(n, device=logits.device), safe],
                    ok, 0, 1)[:, None]
    ln = logits[:, neg]
    qn = torch.log(_sampler_prob(neg, num_total, "log_uniform") + 1e-20)
    qt = torch.log(_sampler_prob(label, num_total, "log_uniform") + 1e-20)
    hit = neg[None, :] == label[:, None]
    ln = torch.where(hit, torch.full((), -1e30, dtype=ln.dtype,
                                     device=ln.device), ln - qn[None, :])
    z = torch.cat([lt - qt[:, None], ln], dim=1)
    logp = torch.log_softmax(z, dim=1)
    return (-logp[:, :1]).to(logits.dtype)


@register_op("sampled_softmax_with_cross_entropy", nondiff=("Label",),
             uses_rng=True)
def _sampled_softmax_ce(ctx, ins, attrs):
    """Softmax cross-entropy over the true class and ``num_samples``
    classes drawn log-uniformly from the op's generator
    (paddle_tpu's :200); Philox is not threefry, so the draws agree with
    the JAX package's in distribution only."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].reshape(-1).long()
    neg = sample_classes(ctx.generator(attrs), logits.shape[-1],
                         int(attrs.get("num_samples", 64)), "log_uniform",
                         logits.device)
    return {"Loss": sampled_softmax_ce(logits, label, neg)}
