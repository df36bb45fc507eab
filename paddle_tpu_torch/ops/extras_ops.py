"""Long-tail op kernels closing the reference layers/nn.py surface
(counterparts of every op of paddle_tpu/ops/extras_ops.py): scatter_nd,
gather_tree, hash, space_to_depth, shuffle_channel, similarity_focus,
filter_by_instag, random_crop, ctc_greedy_decoder, resize_trilinear, cvm
and deformable_roi_pooling.

None reaches a Pallas kernel in the JAX package. The sequential
algorithms (similarity focus's greedy row/column elimination,
gather_tree's back-trace) are loops of device ops with no host read, so a
captured step holds them; orderings that choose data (argmax, the stable
sorts of filter_by_instag and the CTC decoder) keep JAX's first-index
rules and sort integer keys. Gradients that gather rows add through the
sorted ``index_put_`` (tensor_ops' module note).
"""
import numpy as np
import torch

from .registry import register_op
from .tensor_ops import add_rows, wrap_index

_U32 = 0xFFFFFFFF


def _x(ins, slot="X"):
    return ins[slot][0]


def _scalar(v, value):
    """A 0-d tensor of ``v``'s dtype and device, filled on the device (no
    host copy enters a captured step)."""
    return torch.full((), value, dtype=v.dtype, device=v.device)


@register_op("scatter_nd", nondiff=("Index",))
def _scatter_nd(ctx, ins, attrs):
    """Zeros of ``shape`` with ``updates[i]`` added at ``index[i]``
    (duplicates accumulate; a coordinate in [-n, 0) wraps, one out of
    range is dropped, as ``jnp.zeros(shape).at[idx].add``)."""
    index = ins["Index"][0]
    updates = ins["Updates"][0]
    shape = tuple(attrs["shape"])
    k = index.shape[-1]
    lead, rest = shape[:k], shape[k:]
    flat = torch.zeros(index.shape[:-1], dtype=torch.long,
                       device=updates.device)
    ok = torch.ones(index.shape[:-1], dtype=torch.bool,
                    device=updates.device)
    for j in range(k):
        c = wrap_index(index[..., j], lead[j])
        ok = ok & (c >= 0) & (c < lead[j])
        flat = flat * lead[j] + c
    zeros = torch.zeros((int(np.prod(lead)),) + rest, dtype=updates.dtype,
                        device=updates.device)
    out = add_rows(zeros, flat.reshape(-1), ok.reshape(-1),
                   updates.reshape((-1,) + rest))
    return {"Out": out.reshape(shape)}


@register_op("gather_tree", nondiff=("Ids", "Parents"), differentiable=False)
def _gather_tree(ctx, ins, attrs):
    """Beam-search back-trace (ref gather_tree_op.h): walk the parents
    from the last step to recover each beam's full token path."""
    ids = ins["Ids"][0]          # (T, B, W)
    parents = ins["Parents"][0]
    t = ids.shape[0]
    parent = parents[t - 1].long()
    toks = [ids[t - 1]]
    for step in range(t - 2, -1, -1):
        toks.append(torch.gather(ids[step], 1, parent))
        parent = torch.gather(parents[step], 1, parent).long()
    return {"Out": torch.stack(toks[::-1], dim=0)}


@register_op("hash", nondiff=("X",), differentiable=False)
def _hash(ctx, ins, attrs):
    """The JAX package's multi-seed FNV-style hash of each id row into
    [0, mod_by): uint32 arithmetic done in int64 with the high bits
    masked off after every step, so a negative or wide id wraps as
    ``astype(uint32)`` wraps it (ref hash_op.h uses xxhash: the family
    differs, the contract is the same). Out (*dims[:-1], num_hash, 1)
    int64."""
    x = _x(ins).long() & _U32
    mod_by = int(attrs["mod_by"])
    num_hash = int(attrs.get("num_hash", 1))
    outs = []
    for i in range(num_hash):
        seed = (2166136261 ^ (i * 16777619)) & _U32
        h = torch.full(x.shape[:-1], seed, dtype=torch.long,
                       device=x.device)
        for j in range(x.shape[-1]):
            h = ((h ^ x[..., j]) * 16777619) & _U32
        outs.append(h % mod_by)
    return {"Out": torch.stack(outs, dim=-1)[..., None]}


@register_op("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = _x(ins)                  # (N, C, H, W)
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": x.reshape(n, c * b * b, h // b, w // b)}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    x = _x(ins)                  # (N, C, H, W)
    g = int(attrs["group"])
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2)
            .reshape(n, c, h, w)}


@register_op("similarity_focus", nondiff=("X",), differentiable=False)
def _similarity_focus(ctx, ins, attrs):
    """Greedy row/column-exclusive maxima mask (ref similarity_focus_op):
    per selected channel slice (B_, C_) pick min(B_, C_) maxima, each row
    and column used at most once (the first maximal element in raster
    order, as ``jnp.argmax``); the masks of the indexes OR-ed and
    broadcast over the axis."""
    x = _x(ins)
    axis = int(attrs["axis"])
    indexes = list(attrs["indexes"])
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    n, a, b_, c_ = x.shape
    npick = min(b_, c_)
    neg_inf = _scalar(x, float("-inf"))
    rows_b = torch.arange(b_, device=x.device)
    cols_c = torch.arange(c_, device=x.device)
    masks = torch.zeros((n, b_, c_), dtype=x.dtype, device=x.device)
    for idx in indexes:
        t = x[:, idx]                        # (N, B_, C_)
        row_used = torch.zeros((n, b_), dtype=torch.bool, device=x.device)
        col_used = torch.zeros((n, c_), dtype=torch.bool, device=x.device)
        mask = torch.zeros((n, b_, c_), dtype=x.dtype, device=x.device)
        for _ in range(npick):
            blocked = row_used[:, :, None] | col_used[:, None, :]
            flat = torch.argmax(torch.where(blocked, neg_inf, t)
                                .reshape(n, -1), dim=1)
            i, j = flat // c_, flat % c_
            hit_r = rows_b[None, :] == i[:, None]            # (N, B_)
            hit_c = cols_c[None, :] == j[:, None]            # (N, C_)
            mask = torch.where(hit_r[:, :, None] & hit_c[:, None, :],
                               torch.ones_like(mask), mask)
            row_used = row_used | hit_r
            col_used = col_used | hit_c
        masks = torch.maximum(masks, mask)
    out = masks[:, None].expand(n, a, b_, c_)
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return {"Out": out.contiguous()}


def _stable_kept_first(keep, dim):
    """Positions of ``keep``'s True entries first, then the rest, each in
    order along ``dim``: JAX's ``argsort(~keep, stable=True)`` on integer
    keys."""
    return torch.sort((~keep).to(torch.int32), dim=dim, stable=True).indices


@register_op("filter_by_instag", nondiff=("Ins", "Ins_tag", "Filter_tag"))
def _filter_by_instag(ctx, ins, attrs):
    """Keep rows whose tag set meets the filter tags (ref
    filter_by_instag_op), in the JAX package's dense form: kept rows
    packed to the top in order, the rest zeroed; LossWeight the keep
    mask, IndexMap packed row -> original row."""
    rows = ins["Ins"][0]                   # (N, D)
    tags = ins["Ins_tag"][0]               # (N, K) int
    filt = ins["Filter_tag"][0]            # (F,) int
    keep = (tags[..., None] == filt.reshape(-1)[None, None, :]) \
        .any(dim=2).any(dim=1)
    n = rows.shape[0]
    order = _stable_kept_first(keep, 0)
    packed = rows[order]
    kept_sorted = keep[order]
    out = packed * kept_sorted[:, None].to(rows.dtype)
    return {"Out": out,
            "LossWeight": kept_sorted.to(rows.dtype).reshape(n, 1),
            "IndexMap": torch.stack(
                [order, torch.arange(n, device=rows.device)], dim=1)}


@register_op("random_crop", nondiff=("Seed",), uses_rng=True,
             differentiable=False)
def _random_crop(ctx, ins, attrs):
    """A random crop of the trailing dims to ``shape`` (ref
    random_crop_op) as the JAX package draws it: one offset per cropped
    dim, for the whole batch, drawn on the device (torch's Philox, not
    JAX's threefry: the two agree in distribution only). The window is
    read with device indices, so no draw visits the host."""
    x = _x(ins)
    out_shape = tuple(attrs["shape"])
    lead = x.dim() - len(out_shape)
    g = ctx.generator(attrs)
    out = x
    for i, os_ in enumerate(out_shape):
        hi = x.shape[lead + i] - os_ + 1
        start = torch.randint(0, hi, (1,), generator=g, device=x.device)
        out = out.index_select(lead + i,
                               start + torch.arange(os_, device=x.device))
    return {"Out": out}


@register_op("ctc_greedy_decoder", nondiff=("Input", "Length"),
             differentiable=False)
def _ctc_greedy_decoder(ctx, ins, attrs):
    """argmax per step (the first maximal class), collapse repeats, drop
    blanks (ref ctc_align_op), in the JAX package's dense form: input
    (N, T, V) probabilities and optional lengths; Out (N, T) ids packed
    left and padded with ``padding_value``, OutLength (N,) int32."""
    probs = ins["Input"][0]
    blank = int(attrs.get("blank", 0))
    n, t, _ = probs.shape
    ids = torch.argmax(probs, dim=-1)       # (N, T)
    if ins.get("Length"):
        lens = ins["Length"][0].reshape(-1)
        valid = torch.arange(t, device=probs.device)[None, :] < \
            lens[:, None]
    else:
        valid = torch.ones((n, t), dtype=torch.bool, device=probs.device)
    prev = torch.cat([torch.full((n, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & valid
    order = _stable_kept_first(keep, 1)
    packed = torch.gather(ids, 1, order)
    kept_sorted = torch.gather(keep, 1, order)
    pad = int(attrs.get("padding_value", -1))
    out = torch.where(kept_sorted, packed, torch.full_like(packed, pad))
    return {"Out": out, "OutLength": keep.sum(dim=1).to(torch.int32)}


def _resize_weights(in_size, out_size):
    """``jax.image.resize``'s (in_size, out_size) trilinear weights on
    one axis (scale_and_translate's ``compute_weight_mat`` with the
    triangle kernel and antialiasing), in float32 as JAX computes them:
    the kernel widened by 1 / scale when shrinking."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.float32(max(1.0 / scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) *
                inv_scale - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] -
               np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@register_op("resize_trilinear", nondiff=("OutSize",))
def _resize_trilinear(ctx, ins, attrs):
    """3-D linear resize of (N, C, D, H, W) to ``out_shape`` as
    ``jax.image.resize(method="trilinear")``, which antialiases when it
    shrinks (so not ``F.interpolate``): one weight matrix an axis that
    changes size (one constant of the plan), applied as products."""
    x = _x(ins)
    out_dhw = tuple(int(s) for s in attrs["out_shape"])
    moves = [(axis, x.shape[axis], size) for axis, size
             in zip((2, 3, 4), out_dhw) if x.shape[axis] != size]

    def make():
        return torch.from_numpy(np.concatenate(
            [_resize_weights(a, s).reshape(-1) for _, a, s in moves])).to(
                device=x.device, dtype=x.dtype)

    flat = ctx.constant(make) if moves else None
    out, at = x, 0
    for axis, a, s in moves:
        wm = flat[at:at + a * s].reshape(a, s)
        at += a * s
        out = torch.movedim(torch.matmul(torch.movedim(out, axis, -1), wm),
                            -1, axis)
    return {"Out": out}


@register_op("cvm")
def _cvm(ctx, ins, attrs):
    """Show/click handling for CTR embeddings (ref cvm_op): use_cvm keeps
    D, the first two columns replaced with log(show + 1), log(click + 1);
    otherwise the two leading columns are dropped."""
    x = _x(ins)                   # (N, D), D = 2 + emb
    cvm = ins["CVM"][0]           # (N, 2) show, click
    if attrs.get("use_cvm", True):
        c32 = cvm.float()
        logs = torch.log(torch.maximum(c32, _scalar(c32, 1e-20)) + 1.0)
        return {"Y": torch.cat([logs.to(x.dtype), x[:, 2:]], dim=1)}
    return {"Y": x[:, 2:]}


def _clip(v, lo, hi):
    """``jnp.clip``: its gradient is 1/2 at a bound a value touches
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(v, _scalar(v, lo)), _scalar(v, hi))


@register_op("deformable_roi_pooling", nondiff=("ROIs",))
def _deformable_roi_pooling(ctx, ins, attrs):
    """Deformable (PS-)RoI pooling (ref deformable_psroi_pooling_op.h) in
    the JAX package's dense form: ROIs (R, 5) with the image index in
    column 0, Trans (R, 2, PH, PW); each bin's centre moves by trans_std *
    Trans * the RoI's size, then one bilinear sample of every channel
    there. Position-sensitive output channel k of bin (i, j) reads input
    channel (i * PW + j) * C/(PH*PW) + k; only the channels each bin
    reads are gathered (the JAX package gathers the RoI's whole map:
    the same values)."""
    x = ins["Input"][0]                     # (N, C, H, W)
    rois = ins["ROIs"][0]
    trans = ins["Trans"][0]                 # (R, 2, PH, PW)
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    ss = float(attrs.get("spatial_scale", 1.0))
    tstd = float(attrs.get("trans_std", 0.1))
    pos_sensitive = bool(attrs.get("position_sensitive", False))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    batch_idx = torch.clamp(rois[:, 0].long(), 0, n - 1)
    boxes = rois[:, 1:]

    x1 = boxes[:, 0] * ss
    y1 = boxes[:, 1] * ss
    rw = torch.clamp(boxes[:, 2] * ss - x1, min=0.1)
    rh = torch.clamp(boxes[:, 3] * ss - y1, min=0.1)
    bw = (rw / pw)[:, None, None]
    bh = (rh / ph)[:, None, None]
    jj = torch.arange(pw, device=dev, dtype=x1.dtype)[None, None, :]
    ii = torch.arange(ph, device=dev, dtype=x1.dtype)[None, :, None]
    cx = x1[:, None, None] + (jj + 0.5) * bw              # (R, PH, PW)
    cy = y1[:, None, None] + (ii + 0.5) * bh
    cy = cy + trans[:, 0] * tstd * rh[:, None, None]
    cx = cx + trans[:, 1] * tstd * rw[:, None, None]
    cy = _clip(cy, 0.0, h - 1.0)
    cx = _clip(cx, 0.0, w - 1.0)
    y0 = torch.floor(cy).long()
    x0 = torch.floor(cx).long()
    y1i = torch.clamp(y0 + 1, max=h - 1)
    x1i = torch.clamp(x0 + 1, max=w - 1)
    fy = cy - y0
    fx = cx - x0
    if pos_sensitive:
        co = c // (ph * pw)
        # (R, CO, PH, PW): channel (i * PW + j) * CO + k of its image
        blk = (torch.arange(ph, device=dev)[:, None] * pw +
               torch.arange(pw, device=dev)[None, :]) * co   # (PH, PW)
        chan = blk[None] + torch.arange(co, device=dev)[:, None, None]
        plane = (batch_idx[:, None, None, None] * c + chan[None]) * h
        flat = x.reshape(-1)

        def read(yy, xx):
            return flat[(plane + yy[:, None]) * w + xx[:, None]]
        fyb, fxb = fy[:, None], fx[:, None]
    else:
        table = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
        base = (batch_idx * (h * w))[:, None, None]

        def read(yy, xx):                     # (R, C, PH, PW)
            return table[base + yy * w + xx].permute(0, 3, 1, 2)
        fyb, fxb = fy[:, None], fx[:, None]
    out = (read(y0, x0) * (1 - fyb) * (1 - fxb) +
           read(y0, x1i) * (1 - fyb) * fxb +
           read(y1i, x0) * fyb * (1 - fxb) +
           read(y1i, x1i) * fyb * fxb)
    return {"Output": out}
