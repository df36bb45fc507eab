"""Loss op kernels the dygraph layers run: nce (counterpart in
paddle_tpu/ops/loss_extra_ops.py; the rest of that module waits for the
op library). Plain jnp in the JAX package, plain torch here.

``nce`` samples its noise classes from the seeded ``torch.Generator``
that ``ctx.generator`` hands it (the dygraph context's, or the
Executor's): torch's Philox stream is not JAX's threefry, so the two
packages agree in distribution only; given the same samples the cost is
the same function.
"""
import math

import torch

from .registry import register_op
from .tensor_ops import fill_taken, take_fill


def _softplus(x):
    # max(x,0) + log1p(exp(-|x|)) — the reference's stable spelling
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


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
