"""Neural-net op kernels (counterparts of every op of
paddle_tpu/ops/nn_ops.py): the convolutions, pool2d, the norms,
lookup_table(_v2), dropout, the softmaxes and cross-entropies, the
regression and ranking losses, one_hot, label_smooth, pad and pad2d
(``reflect`` and ``edge`` read at mirrored or clamped indices),
add_position_encoding and the two resizes.

Convolution, pooling and batch norm have no Pallas kernel in the JAX
package (``lax.conv_general_dilated``, ``lax.reduce_window`` and jnp
statistics), so they lower to torch calls here (cuDNN on the card),
as ``mul`` and ``matmul`` lower to cuBLAS; a CUDA tensor stays on the
card.

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
import torch.nn.functional as F

from .kernels import blockwise_ce as _ce_kernel
from .kernels import layer_norm as _ln_kernel
from .math_ops import jnp_abs
from .registry import register_op
from .tensor_ops import fill_taken, take_fill
from ..framework.dtypes import to_torch_dtype

# the JAX package's blockwise-CE / fused-head kernel defaults
# (ops/pallas/blockwise_ce.py: block_t=128, block_v=512)
_CE_BLOCK_T, _CE_BLOCK_V = 128, 512


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv(conv, x, w, **args):
    """``conv`` (F.conv2d, F.conv3d, or their transposes); a bf16
    convolution sums in f32 and rounds once to bf16 (the JAX package's
    ``preferred_element_type=f32``): cuDNN's bf16 convolution on the card
    accumulates in f32; on the CPU the operands are widened first (a bf16
    product is exact in f32)."""
    if x.dtype == torch.bfloat16 and x.device.type != "cuda":
        return conv(x.float(), w.float(), **args).to(x.dtype)
    return conv(x, w, **args)


def _conv_args(attrs, nd):
    return dict(stride=_ntuple(attrs.get("strides", 1), nd),
                padding=_ntuple(attrs.get("paddings", 0), nd),
                dilation=_ntuple(attrs.get("dilations", 1), nd),
                groups=attrs.get("groups", 1) or 1)


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter, symmetric padding, dilation, groups."""
    return {"Output": _conv(F.conv2d, ins["Input"][0], ins["Filter"][0],
                            **_conv_args(attrs, 2))}


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW input, OIDHW filter (paddle_tpu/ops/nn_ops.py:99)."""
    return {"Output": _conv(F.conv3d, ins["Input"][0], ins["Filter"][0],
                            **_conv_args(attrs, 3))}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    return _conv2d(ctx, ins, attrs)


def _window_pool(x, ptype, ks, strides, pads, exclusive):
    """Max (padding -inf, as ``lax.reduce_window``'s init) or average
    (``exclusive``: over the window's unpadded elements; else over the
    whole window) pooling. torch's pools pad implicitly up to half the
    window; a wider padding is made explicit first."""
    if all(p <= k // 2 for p, k in zip(pads, ks)):
        if ptype == "max":
            return F.max_pool2d(x, ks, strides, pads)
        return F.avg_pool2d(x, ks, strides, pads,
                            count_include_pad=not exclusive)
    pad4 = (pads[1], pads[1], pads[0], pads[0])
    if ptype == "max":
        return F.max_pool2d(F.pad(x, pad4, value=float("-inf")), ks,
                            strides)
    total = F.avg_pool2d(F.pad(x, pad4), ks, strides) * (ks[0] * ks[1])
    if not exclusive:
        return total / (ks[0] * ks[1])
    ones = F.pad(torch.ones_like(x[:1, :1]), pad4)
    return total / (F.avg_pool2d(ones, ks, strides) * (ks[0] * ks[1]))


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """``pooling_type`` max or avg over ``ksize`` windows; global pooling
    (also adaptive to 1 x 1) reduces H and W; adaptive pooling to a size
    that divides the input reduces equal blocks, as the JAX op does."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and
            _ntuple(attrs.get("ksize", [1, 1]), 2) == (1, 1)):
        if ptype == "max":
            return {"Out": x.amax(dim=(2, 3), keepdim=True)}
        return {"Out": x.mean(dim=(2, 3), keepdim=True)}
    ks = _ntuple(attrs.get("ksize", [2, 2]), 2)
    if attrs.get("adaptive", False):
        oh, ow = ks
        h, w = x.shape[2], x.shape[3]
        if h % oh or w % ow:
            raise NotImplementedError(
                "adaptive pool2d needs input divisible by output size "
                "(got %sx%s -> %sx%s)" % (h, w, oh, ow))
        x6 = x.reshape(x.shape[0], x.shape[1], oh, h // oh, ow, w // ow)
        if ptype == "max":
            return {"Out": x6.amax(dim=(3, 5))}
        return {"Out": x6.mean(dim=(3, 5))}
    return {"Out": _window_pool(
        x, ptype, ks, _ntuple(attrs.get("strides", ks), 2),
        _ntuple(attrs.get("paddings", [0, 0]), 2), attrs.get("exclusive", True))}


@register_op("batch_norm", nondiff=("Mean", "Variance"))
def _batch_norm(ctx, ins, attrs):
    """The JAX op's arithmetic, not ``F.batch_norm``'s: in f32, the biased
    batch variance for both the normalisation and VarianceOut, the moving
    stats as ``stat * momentum + batch * (1 - momentum)``, SavedVariance
    the variance itself (not an inverse std), Y in x's dtype. The gradient
    flows through the batch mean and variance; the moving stats and the
    Mean*/Saved* outputs carry none. MeanOut and VarianceOut name the same
    persistables as Mean and Variance, so a run rebinds them, as the
    optimizer ops rebind a parameter."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    xf = x.float()
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out, saved_mean, saved_var = mean, var, mean, var
    else:
        use_var, use_mean = torch.var_mean(xf, dim=axes, unbiased=False)
        saved_mean, saved_var = use_mean.detach(), use_var.detach()
        mean_out = mean * momentum + saved_mean * (1 - momentum)
        var_out = var * momentum + saved_var * (1 - momentum)
    inv = torch.rsqrt(use_var.float() + eps)
    y = (xf - use_mean.reshape(bshape)) * \
        (inv * scale.float()).reshape(bshape) + bias.float().reshape(bshape)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    """NC... input normalised over each group of channels and the spatial
    axes (biased variance), then Scale and Bias per channel; Mean and
    Variance (N, groups) (paddle_tpu/ops/nn_ops.py:251)."""
    x = ins["X"][0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    var, mean = torch.var_mean(xg, dim=axes, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = [1, c] + [1] * (x.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": y, "Mean": mean.reshape(n, g), "Variance": var.reshape(n, g)}


@register_op("lookup_table", nondiff=("Ids",))
def _lookup_table(ctx, ins, attrs):
    """``w[ids]`` read as ``jnp.take(w, ids, axis=0)``: an id in [-V, 0)
    wraps, one out of range gives a row of NaN (``take_fill``); rows of
    ``padding_idx`` are zeros. Its gradient scatters rows with index_put
    (accumulate) on a CUDA card."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    safe, ok = take_fill(ids, w.shape[0])
    out = fill_taken(w[safe], ok, 0, ids.dim())
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


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(ins["X"][0], dim=attrs.get("axis", -1))}


@register_op("label_smooth", nondiff=("PriorDist",))
def _label_smooth(ctx, ins, attrs):
    """(1 - eps) * X + eps * PriorDist, or + eps / K (K: X's last dim)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": (1 - eps) * x + eps * ins["PriorDist"][0]}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("one_hot", nondiff=("X",))
def _one_hot(ctx, ins, attrs):
    """(..., depth) rows of ``dtype``, a trailing 1 of X dropped first. An
    id outside [0, depth) gives a row of zeros, as ``jax.nn.one_hot``
    (``F.one_hot`` would raise)."""
    x = ins["X"][0]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = attrs["depth"]
    hot = x.long()[..., None] == torch.arange(depth, device=x.device)
    return {"Out": hot.to(to_torch_dtype(attrs.get("dtype", "float32")))}


def _position_table(l, d, offset, device):
    """(l, d) f32 sinusoids of positions offset .. offset + l - 1: sin in
    the first d // 2 columns, cos in the rest, angle pos / 10000^(2i/d)
    (the JAX op's arithmetic)."""
    pos = (torch.arange(l, dtype=torch.float32, device=device) +
           float(offset))[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


@register_op("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """alpha * X + beta * the sinusoid table of X's (L, D), positions from
    ``pos_offset`` (a cached decode step's absolute position). The table
    is made on the device, once per plan where the run may be
    captured."""
    x = ins["X"][0]
    _, l, d = x.shape
    table = ctx.constant(lambda: _position_table(
        l, d, attrs.get("pos_offset", 0), x.device))
    return {"Out": attrs.get("alpha", 1.0) * x +
            attrs.get("beta", 1.0) * table[None].to(x.dtype)}


@register_op("sigmoid_cross_entropy_with_logits", nondiff=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)) (``torch.maximum``, whose
    gradient splits a tie in halves as ``jnp.maximum``'s does); elements
    whose label is ``ignore_index`` give 0; ``normalize`` divides by the
    count of the others (at least 1). |x| is ``jnp_abs``: at x = 0 the
    gradient is the JAX package's, -label, not sigmoid(0) - label."""
    x, label = ins["X"][0], ins["Label"][0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    loss = torch.maximum(x, zero) - x * label + \
        torch.log1p(torch.exp(-jnp_abs(x)))
    ignore = attrs.get("ignore_index", -100)
    kept = label != ignore
    loss = torch.where(kept, loss, zero)
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(kept.sum(), min=1)
    return {"Out": loss}


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


@register_op("cross_entropy", nondiff=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """-log(max(p, 1e-20)) of probabilities X at the labels (hard), or
    -sum(label * log(max(X, 1e-20))) over the last axis (``soft_label``).
    A hard label in [-C, 0) wraps and one out of range picks NaN, as
    ``jnp.take_along_axis`` does; ``ignore_index`` rows give 0."""
    x, label = ins["X"][0], ins["Label"][0]
    floor = torch.full((), 1e-20, dtype=x.dtype, device=x.device)
    if attrs.get("soft_label", False):
        return {"Y": -(label * torch.log(torch.maximum(x, floor))).sum(
            dim=-1, keepdim=True)}
    lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
        else label
    idx = lbl[..., None]
    safe, ok = take_fill(idx, x.shape[-1])
    picked = fill_taken(torch.take_along_dim(x, safe, dim=-1), ok, 0,
                        ok.dim())
    loss = -torch.log(torch.maximum(picked, floor))
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    return {"Y": torch.where(idx == attrs.get("ignore_index", -100), zero,
                             loss)}


def conv_transpose(ins, attrs, nd):
    """The input gradient of the forward convolution, as the JAX package
    builds it (its vjp): ``F.conv_transpose{nd}d`` with the same (in_c,
    out_c / g, k...) filter; the ``output_size`` attr becomes the output
    padding past the derived size."""
    x, w = ins["Input"][0], ins["Filter"][0]
    args = _conv_args(attrs, nd)
    out_sp = attrs.get("output_size") or None
    extra = (0,) * nd
    if out_sp is not None:
        extra = tuple(
            int(out_sp[i]) - ((x.shape[2 + i] - 1) * args["stride"][i] -
                              2 * args["padding"][i] + args["dilation"][i] *
                              (w.shape[2 + i] - 1) + 1)
            for i in range(nd))
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    return {"Output": _conv(conv, x, w, output_padding=extra, **args)}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    return conv_transpose(ins, attrs, 2)


def _interp_src(out_size, in_size, align_corners, align_mode, device):
    """Source coordinates of one axis in f32, in the JAX package's order of
    operations (an f32 ``arange`` times the ratio rounded to f32):
    align_corners the corner-pinned (in-1)/(out-1) ratio; else ratio
    in/out with align_mode 0 half-pixel centres, 1 src = ratio * dst."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        ratio = (in_size - 1) / max(out_size - 1, 1)
        return i * torch.full((), ratio, dtype=torch.float32, device=device)
    ratio = torch.full((), in_size / out_size, dtype=torch.float32,
                       device=device)
    if align_mode == 0:
        return torch.clamp((i + 0.5) * ratio - 0.5, 0.0, in_size - 1.0)
    return i * ratio


def _take_axis(x, idx, axis):
    """``x`` rows ``idx`` along ``axis`` 2 or 3 by advanced indexing, whose
    gradient on a CUDA card sums repeated rows in a fixed order (a sorted
    index_put), not with atomics."""
    return x[:, :, idx] if axis == 2 else x[:, :, :, idx]


def _lin_axis(x, out_size, axis, align_corners, align_mode):
    in_size = x.shape[axis]
    src = _interp_src(out_size, in_size, align_corners, align_mode,
                      x.device)
    lo = torch.floor(src).long().clamp(0, in_size - 1)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    ft = x.dtype if x.is_floating_point() else torch.float32
    shape = [1] * x.dim()
    shape[axis] = out_size
    d = (src - lo).to(ft).reshape(shape)
    out = _take_axis(x, lo, axis).to(ft) * (1 - d) + \
        _take_axis(x, hi, axis).to(ft) * d
    return out.to(x.dtype)


@register_op("interp_nearest")
def _interp_nearest(ctx, ins, attrs):
    """Nearest resize of H and W to (out_h, out_w): align_corners picks
    floor(ratio * dst + 0.5) with the corner-pinned ratio, else
    floor(ratio * dst) (the JAX package's rule, not ``F.interpolate``'s),
    the indices computed in f32 exactly as the JAX package computes
    them."""
    out = ins["X"][0]
    ac = attrs.get("align_corners", True)
    for axis, osz in ((2, attrs["out_h"]), (3, attrs["out_w"])):
        in_size = out.shape[axis]
        src = _interp_src(osz, in_size, ac, 1, out.device)
        idx = torch.floor(src + 0.5 if ac else src).long()
        out = _take_axis(out, idx.clamp(0, in_size - 1), axis)
    return {"Out": out}


@register_op("interp_bilinear")
def _interp_bilinear(ctx, ins, attrs):
    """Bilinear resize, one axis after the other (H, then W), each a
    blend of the floor and next rows in float (an integer X blends in
    f32 and is cast back)."""
    x = ins["X"][0]
    ac = attrs.get("align_corners", True)
    am = attrs.get("align_mode", 1)
    out = _lin_axis(x, attrs["out_h"], 2, ac, am)
    return {"Out": _lin_axis(out, attrs["out_w"], 3, ac, am)}


# ---- the op library's nn ops (paddle_tpu/ops/nn_ops.py) ------------------

@register_op("lookup_table_v2", nondiff=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    return _lookup_table(ctx, ins, attrs)


@register_op("instance_norm")
def _instance_norm(ctx, ins, attrs):
    """Each (sample, channel) normalised over its spatial axes (biased
    variance), then Scale and Bias per channel; SavedMean and
    SavedVariance keep the reduced axes (paddle_tpu's :270)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    bshape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": y, "SavedMean": mean, "SavedVariance": var}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True))
    return {"Out": x / torch.clamp(norm, min=attrs.get("epsilon", 1e-10)),
            "Norm": norm}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": torch.square(ins["X"][0] - ins["Y"][0])}


@register_op("mse_loss", nondiff=("Label",))
def _mse(ctx, ins, attrs):
    return {"Out": torch.square(ins["Input"][0] - ins["Label"][0])}


@register_op("smooth_l1_loss", nondiff=("Y",))
def _smooth_l1(ctx, ins, attrs):
    """Per sample, the sum over the other axes of 0.5 s^2 d^2 (|d| < 1/s^2)
    or |d| - 0.5/s^2, d = (X - Y) * InsideWeight, each term times
    OutsideWeight; Out (N, 1), Diff the weighted d."""
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if ins.get("InsideWeight"):
        d = d * ins["InsideWeight"][0]
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": torch.sum(loss, dim=tuple(range(1, x.dim())))[..., None],
            "Diff": d}


@register_op("huber_loss", nondiff=("Y",))
def _huber(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    d = y - x
    ad = torch.abs(d)
    return {"Out": torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)),
            "Residual": d}


@register_op("log_loss", nondiff=("Labels",))
def _log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps) -
            (1 - label) * torch.log(1 - p + eps)}


@register_op("kldiv_loss", nondiff=("Target",))
def _kldiv(ctx, ins, attrs):
    """target * (log target - x), 0 where target <= 0; reduced by
    ``reduction`` (mean, sum, batchmean: the sum over N, or none)."""
    x, target = ins["X"][0], ins["Target"][0]
    loss = target * (torch.log(torch.clamp(target, min=1e-20)) - x)
    loss = torch.where(target <= 0, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device), loss)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": loss}


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@register_op("bpr_loss", nondiff=("Label",))
def _bpr_loss(ctx, ins, attrs):
    """-(1/(C-1)) sum over the negatives j of log sigmoid(x_pos - x_j)
    (paddle_tpu's :522). The positive logit is read as
    ``jnp.take_along_axis`` reads it: a label out of range gives NaN."""
    x, label = ins["X"][0], ins["Label"][0]
    n, c = x.shape
    safe, ok = take_fill(label.reshape(n), c)
    pos = fill_taken(x[torch.arange(n, device=x.device), safe], ok, 0, 1)
    logsig = _log_sigmoid(pos[:, None] - x)
    # the negatives' mask is 1 - one_hot(label): a label outside [0, C)
    # excludes no column
    neg = label.reshape(n, 1).long() != torch.arange(c, device=x.device)
    return {"Y": -torch.sum(logsig * neg.to(x.dtype), dim=1,
                            keepdim=True) / (c - 1)}


@register_op("margin_rank_loss", nondiff=("Label",))
def _margin_rank(ctx, ins, attrs):
    x1, x2, label = ins["X1"][0], ins["X2"][0], ins["Label"][0]
    out = torch.relu(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("pad")
def _pad(ctx, ins, attrs):
    """``paddings`` [before_0, after_0, before_1, ...] filled with
    ``pad_value``."""
    x = ins["X"][0]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, flat, value=attrs.get("pad_value", 0.0))}


def _pad_index(n, before, after, mode, device):
    """Source index of each padded position of an axis of ``n``:
    ``reflect`` mirrors without repeating the edge, ``edge`` repeats it
    (numpy's modes, as ``jnp.pad``)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    """NCHW padded by [top, bottom, left, right]: ``constant`` with
    ``pad_value``; ``reflect`` and ``edge`` read X at mirrored or clamped
    indices, so the gradient adds in a fixed order (ops/tensor_ops.py's
    note) where the library's reflection-pad backward uses atomics."""
    x = ins["X"][0]
    p = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x, [p[2], p[3], p[0], p[1]],
                             value=attrs.get("pad_value", 0.0))}
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    rows = _pad_index(x.shape[2], p[0], p[1], mode, x.device)
    cols = _pad_index(x.shape[3], p[2], p[3], mode, x.device)
    return {"Out": x[:, :, rows[:, None], cols[None, :]]}
