"""Neural-net op kernels BERT and GPT serving and pretraining run:
lookup_table, dropout, layer_norm, softmax_with_cross_entropy,
fused_mlm_head_loss (counterparts in paddle_tpu/ops/nn_ops.py).

``softmax_with_cross_entropy`` and ``fused_mlm_head_loss`` follow the JAX
package's routing rule (``blockwise_kernel_would_tile``, its ``fit_blocks``
for compiled kernels): where its blockwise Pallas kernels tile (GPT's vocab
32000) they run the port's blockwise-CE and fused-head autograd Functions
(ops/kernels/blockwise_ce.py), which launch the hand-written kernels for a
CUDA tensor and their plain versions for a CPU tensor. Where the rule
declines (BERT-base's vocab 30522, the NSP head's 2 classes) they take the
JAX package's own non-Pallas lowering: a ``torch.matmul`` for the head and
a plain log-softmax cross-entropy, as the JAX package runs there too.
"""
import math

import torch

from .kernels import blockwise_ce as _ce_kernel
from .kernels import layer_norm as _ln_kernel
from .registry import register_op

# the JAX package's blockwise-CE / fused-head kernel defaults
# (ops/pallas/blockwise_ce.py: block_t=128, block_v=512)
_CE_BLOCK_T, _CE_BLOCK_V = 128, 512


@register_op("lookup_table", nondiff=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """``w[ids]``; its gradient scatters rows with atomics on a CUDA card
    (index_put with accumulate), so repeated ids sum in no fixed order
    there."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    out = w[ids]
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return {"Out": out}


@register_op("dropout", uses_rng=True)
def _dropout(ctx, ins, attrs):
    """Training mode keeps each element with probability 1 - p, drawn
    from the op's seeded generator (Philox on a CUDA card); autograd saves
    the mask, so the backward reuses the forward's draw."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        mask = torch.ones_like(x, dtype=torch.uint8)
        if impl == "upscale_in_train":
            return {"Out": x, "Mask": mask}
        return {"Out": x * (1.0 - p), "Mask": mask}
    if p <= 0.0:
        return {"Out": x, "Mask": torch.ones_like(x, dtype=torch.uint8)}
    keep = torch.rand(x.shape, generator=ctx.generator(attrs),
                      device=x.device) < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    return {"Out": torch.where(keep, kept, zero).to(x.dtype),
            "Mask": keep.to(torch.uint8)}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Collapse to (rows, cols) at begin_norm_axis and run the LayerNorm
    kernels' autograd Function; Mean/Variance come from its per-row mean
    and rstd and carry no gradient."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    cols = math.prod(x.shape[begin:])
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    y, mean, rstd = _ln_kernel.LayerNorm.apply(x.reshape(-1, cols), scale,
                                               bias, eps)
    return {"Y": y.reshape(x.shape),
            "Mean": mean.reshape(lead),
            "Variance": (rstd.pow(-2) - eps).reshape(lead)}


def fit_blocks(t, v, block_t, block_v):
    """(bt, bv) tile sizes for a (T, V) blockwise-CE/MLM-head problem, or
    None when it cannot tile: halve each block until it divides its axis;
    compiled Mosaic needs tiles of 128 or more. (The port's copy of
    paddle_tpu/ops/pallas/costmodel.py:71 ``fit_blocks`` for compiled
    kernels, the JAX package's tiling rule.)"""
    bt, bv = min(block_t, t), min(block_v, v)
    while bt >= 1 and t % bt:
        bt //= 2
    while bv >= 1 and v % bv:
        bv //= 2
    if bt < 128 or bv < 128:
        return None
    return bt, bv


def blockwise_kernel_would_tile(t, v, d=None):
    """Whether the JAX package's compiled blockwise-CE (``d`` None) or
    fused-MLM-head (hidden width ``d``) kernel takes a (T, V) problem."""
    if fit_blocks(t, v, _CE_BLOCK_T, _CE_BLOCK_V) is None:
        return False
    return d is None or d % 8 == 0


@register_op("softmax_with_cross_entropy", nondiff=("Label",))
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1)
    soft = attrs.get("soft_label", False)
    if not soft:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        v = logits.shape[-1]
        if logits.dim() >= 2 and axis in (-1, logits.dim() - 1) and \
                lbl.dim() == logits.dim() - 1 and \
                blockwise_kernel_would_tile(logits.numel() // max(v, 1), v):
            return _blockwise_softmax_ce(logits, lbl, attrs)
    x = logits.float()
    logp = torch.log_softmax(x, dim=axis)
    if soft:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        ignore = attrs.get("ignore_index", -100)
        idx = lbl[..., None].long()
        loss = torch.where(idx == ignore, torch.zeros((), device=x.device),
                           _label_loss(x, logp, idx, axis))
    return {"Softmax": torch.exp(logp).to(logits.dtype),
            "Loss": loss.to(logits.dtype)}


def _label_loss(x, logp, idx, axis):
    """-logp at the labels ``idx`` along ``axis``. A label outside [0, V)
    is never used as an address: its row's loss is the lse (the label's
    term 0, as the kernels' label hit gives it), x_j - logp_j at any
    column j."""
    v = x.shape[axis]
    safe = idx.clamp(0, v - 1)
    off = torch.where((idx >= 0) & (idx < v),
                      torch.zeros((), device=x.device),
                      torch.take_along_dim(x, safe, dim=axis))
    return off - torch.take_along_dim(logp, safe, dim=axis)


def _blockwise_softmax_ce(logits, lbl, attrs):
    """The blockwise-CE route: the CE kernels' autograd Function on the
    (rows, V) logits; ``ignore_index`` rows are zeroed afterwards, and
    Softmax is exp(logits - lse) from the kernel's lse, one elementwise
    expression beside it (the JAX package's ``_pallas_softmax_ce``)."""
    v = logits.shape[-1]
    x = logits.reshape(-1, v)
    flat = lbl.reshape(-1)
    loss, lse = _ce_kernel.BlockwiseCE.apply(x, flat)
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(flat == ignore, torch.zeros((), device=loss.device),
                       loss)
    softmax = torch.exp(x.float() - lse[:, None]).reshape(logits.shape)
    return {"Softmax": softmax.to(logits.dtype),
            "Loss": loss.reshape(lbl.shape)[..., None].to(logits.dtype)}


@register_op("fused_mlm_head_loss", nondiff=("Label",))
def _fused_mlm_head_loss(ctx, ins, attrs):
    """LM/MLM head + softmax CE: ``Hidden (T, D) @ Weight^T (+ Bias)`` ->
    per-token Loss (T, 1), Weight the (V, D) tied embedding table. Where
    the blockwise kernel tiles, the fused-head autograd Function (no (T, V)
    logits on the card); elsewhere the JAX package's non-Pallas lowering,
    where the logits exist."""
    hidden, weight = ins["Hidden"][0], ins["Weight"][0]
    label = ins["Label"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    lbl = label.reshape(label.shape[:-1]) if label.dim() > 1 and \
        label.shape[-1] == 1 else label
    cast_bf16 = attrs.get("cast_bf16", False)
    if hidden.dim() == 2 and lbl.dim() == 1 and blockwise_kernel_would_tile(
            hidden.shape[0], weight.shape[0], hidden.shape[1]):
        h, w = hidden, weight
        if cast_bf16:
            # the kernels take bf16 operands and sum in f32, as the JAX op
            # casts before its kernel
            h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
        loss = _ce_kernel.FusedHeadLoss.apply(h, w, bias, lbl)
        return {"Loss": loss[:, None]}
    h, w = hidden, weight
    if cast_bf16:
        # bf16 inputs, f32 products and sums (bf16 products are exact in
        # f32), as the JAX package's preferred_element_type=f32 matmul
        h = h.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    logits = torch.matmul(h, w.t()).float()
    if bias is not None:
        logits = logits + bias.float()
    logp = torch.log_softmax(logits, dim=-1)
    return {"Loss": _label_loss(logits, logp, lbl[..., None].long(), -1)}
