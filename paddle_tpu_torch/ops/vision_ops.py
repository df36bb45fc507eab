"""Vision op kernels (counterparts of every op of
paddle_tpu/ops/vision_ops.py): the 3-D transposed convolution and pool,
the sampling grids, pixel shuffle, LRN, im2col, the temporal shift,
row_conv, deformable convolution and the position-sensitive and precise
RoI poolings.

None has a Pallas kernel in the JAX package (``lax`` convolutions,
``reduce_window`` and batched bilinear gathers), so they lower to torch
calls. Two runs on a CUDA card give the same bits: a window reduction is
a fixed sequence of strided slices (torch's pool3d backward adds with
atomics); a bilinear tap reads rows of a table by advanced indexing,
whose backward is the sorted ``index_put_(accumulate=True)`` of
``tensor_ops.add_rows``; products are matmuls.
"""
import torch
import torch.nn.functional as F

from .nn_ops import conv_transpose
from .registry import register_op


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """The input gradient of the forward conv3d (paddle_tpu's :29 builds
    it as that vjp): nn_ops.conv_transpose in three dimensions."""
    return conv_transpose(ins, attrs, 3)


# ---------------------------------------------------------------------------
# pool3d: a window reduction over the padded input's strided slices, one
# slice a window offset in (kd, kh, kw) raster order
# ---------------------------------------------------------------------------

def _window_slices(xp, ks, strides, out_sz):
    """Window offset (a, b, c)'s values of every output position: the
    padded input's slice from (a, b, c) with the strides, cut to
    ``out_sz``, for each offset in raster order."""
    def cut(start, i):
        return slice(start, start + (out_sz[i] - 1) * strides[i] + 1,
                     strides[i])
    return [xp[:, :, cut(a, 0), cut(b, 1), cut(c, 2)]
            for a in range(ks[0]) for b in range(ks[1])
            for c in range(ks[2])]


def _pool3d_pads(shape, ks, strides, pads, ceil_mode):
    """(low, high) padding of each spatial dim, as paddle_tpu's :68-85:
    ceil mode pads the high side so the last partial window exists,
    never one that starts in the right padding."""
    pads2 = [(p, p) for p in pads]
    if ceil_mode:
        for i in range(3):
            i_sz, k, s, p = shape[2 + i], ks[i], strides[i], pads[i]
            out_sz = -(-(i_sz + 2 * p - k) // s) + 1
            if (out_sz - 1) * s >= i_sz + p:
                out_sz -= 1
            extra = (out_sz - 1) * s + k - (i_sz + 2 * p)
            pads2[i] = (p, p + max(0, extra))
    return pads2


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """Max or average over (kd, kh, kw) windows of (N, C, D, H, W).
    A max takes the first of tied elements in raster order (the gradient
    goes there, as XLA's select-and-scatter sends it); a NaN wins.
    ``exclusive`` averages count only the input's elements. Adaptive mode
    splits each dim into equal cells and raises when a size does not
    divide, as the JAX package does; global and adaptive maxima share a
    tie's gradient evenly, as ``jnp.max`` does."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return {"Out": torch.amax(x, dim=(2, 3, 4), keepdim=True)}
        return {"Out": torch.mean(x, dim=(2, 3, 4), keepdim=True)}
    ks = _triple(attrs.get("ksize", [2, 2, 2]))
    if attrs.get("adaptive", False):
        od, oh, ow = ks
        n, c, d, h, w = x.shape
        if d % od or h % oh or w % ow:
            raise NotImplementedError(
                "adaptive pool3d needs input divisible by output size "
                "(got %sx%sx%s -> %sx%sx%s)" % (d, h, w, od, oh, ow))
        x8 = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
        if ptype == "max":
            return {"Out": torch.amax(x8, dim=(3, 5, 7))}
        return {"Out": torch.mean(x8, dim=(3, 5, 7))}
    strides = _triple(attrs.get("strides", ks))
    pads = _triple(attrs.get("paddings", [0, 0, 0]))
    pads2 = _pool3d_pads(x.shape, ks, strides, pads,
                         attrs.get("ceil_mode", False))
    flat_pads = [p for lo_hi in reversed(pads2) for p in lo_hi]
    out_sz = [(x.shape[2 + i] + pads2[i][0] + pads2[i][1] - ks[i]) //
              strides[i] + 1 for i in range(3)]
    if ptype == "max":
        init = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        sl = _window_slices(F.pad(x, flat_pads, value=init), ks, strides,
                            out_sz)
        out = sl[0]
        for s in sl[1:]:
            take = s > out
            if s.is_floating_point():
                take = take | (torch.isnan(s) & ~torch.isnan(out))
            out = torch.where(take, s, out)
        return {"Out": out}
    sl = _window_slices(F.pad(x, flat_pads), ks, strides, out_sz)
    total = sl[0]
    for s in sl[1:]:
        total = total + s
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                                device=x.device), flat_pads)
        cnt = _window_slices(ones, ks, strides, out_sz)
        count = cnt[0]
        for s in cnt[1:]:
            count = count + s
        return {"Out": total / count}
    return {"Out": total / (ks[0] * ks[1] * ks[2])}


# ---------------------------------------------------------------------------
# bilinear taps: rows of a (M, C) table read at (row base + y * W + x),
# the taps outside the map weighted 0 (ref GetGridPointValue)
# ---------------------------------------------------------------------------

def _bilinear(table, base, gy, gx, h, w):
    """paddle_tpu's ``_grid_sample_2d`` taps on a row table: the four
    neighbours of (gy, gx) (any shape P) from ``table`` (M, C), row
    ``base + y * w + x``, each weighted by its bilinear weight times its
    validity, summed in the JAX package's order. Returns (P..., C)."""
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0

    def tap(yi, xi, wgt):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        row = base + torch.clamp(yi, 0, h - 1).long() * w + \
            torch.clamp(xi, 0, w - 1).long()
        return table[row] * (wgt * valid)[..., None]

    return (tap(y0, x0, (1 - fy) * (1 - fx)) +
            tap(y0, x0 + 1, (1 - fy) * fx) +
            tap(y0 + 1, x0, fy * (1 - fx)) +
            tap(y0 + 1, x0 + 1, fy * fx))


def _rows(x):
    """(N, C, H, W) as its (N * H * W, C) row table."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


@register_op("affine_grid", nondiff=("OutputShape",))
def _affine_grid(ctx, ins, attrs):
    """(N, H, W, 2) sampling points: theta (N, 2, 3) applied to the
    align-corners base grid over [-1, 1]^2 (made once per plan)."""
    theta = ins["Theta"][0]
    shape = attrs["output_shape"]
    h, w = int(shape[2]), int(shape[3])

    def make():
        ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
        xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1) \
            .reshape(h * w, 3).to(theta.dtype)

    base = ctx.constant(make)
    out = torch.matmul(base, theta.transpose(1, 2))      # (N, H*W, 2)
    return {"Output": out.reshape(theta.shape[0], h, w, 2)}


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear samples of X (N, C, H, W) at Grid (N, H', W', 2) in
    [-1, 1] (align corners, zeros outside the map) -> (N, C, H', W')."""
    x, grid = ins["X"][0], ins["Grid"][0]
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    base = (torch.arange(n, device=x.device) * (h * w)).reshape(n, 1, 1)
    out = _bilinear(_rows(x), base, gy, gx, h, w)          # (N, H', W', C)
    return {"Output": out.permute(0, 3, 1, 2)}


# ---------------------------------------------------------------------------
# pixel_shuffle / lrn / unfold / temporal_shift / row_conv
# ---------------------------------------------------------------------------

@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]                       # (N, C*r*r, H, W)
    r = int(attrs["upscale_factor"])
    n, c, h, w = x.shape
    oc = c // (r * r)
    y = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": y.reshape(n, oc, h * r, w * r)}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Ref lrn_op.cc: mid = k + alpha * (the sum of x^2 over a window of
    n channels, zero padded); out = x * mid^-beta."""
    x = ins["X"][0]                       # (N, C, H, W)
    n_sz = int(attrs.get("n", 5))
    k = float(attrs.get("k", 1.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = (n_sz - 1) // 2
    c = x.shape[1]
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n_sz - 1 - half))
    acc = sq[:, 0:c]
    for i in range(1, n_sz):
        acc = acc + sq[:, i:i + c]
    mid = k + alpha * acc
    return {"Out": x * torch.pow(mid, -beta), "MidOut": mid}


@register_op("unfold")
def _unfold(ctx, ins, attrs):
    """im2col (ref unfold_op.h): (N, C, H, W) -> (N, C*kh*kw, L), patch
    channel order (c, kh, kw) with c slowest, as
    ``conv_general_dilated_patches``; each kernel offset one strided
    slice of the padded input."""
    x = ins["X"][0]
    kh, kw = [int(v) for v in attrs["kernel_sizes"]]
    sh, sw = [int(v) for v in attrs.get("strides", [1, 1])]
    pads = [int(v) for v in attrs.get("paddings", [0, 0])]
    if len(pads) == 4:        # [top, left, bottom, right]
        top, left, bottom, right = pads
    else:
        top, left, bottom, right = pads[0], pads[1], pads[0], pads[1]
    dh, dw = [int(v) for v in attrs.get("dilations", [1, 1])]
    n, c, h, w = x.shape
    xp = F.pad(x, (left, right, top, bottom))
    oh = (h + top + bottom - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + left + right - (dw * (kw - 1) + 1)) // sw + 1
    cols = [xp[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
               j * dw:j * dw + (ow - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw)]
    out = torch.stack(cols, dim=2)        # (N, C, kh*kw, OH, OW)
    return {"Y": out.reshape(n, c * kh * kw, oh * ow)}


@register_op("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    """Ref temporal_shift_op.h: x (N*T, C, H, W); the first fold of
    channels reads t + 1, the second t - 1, the rest stay; zero padded."""
    x = ins["X"][0]
    t = int(attrs["seg_num"])
    ratio = float(attrs.get("shift_ratio", 0.25))
    nt, c, h, w = x.shape
    n = nt // t
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    xr = x.reshape(n, t, c, h, w)
    zeros = torch.zeros_like(xr[:, :1])
    fwd = torch.cat([xr[:, 1:], zeros], dim=1)            # reads t+1
    bwd = torch.cat([zeros, xr[:, :-1]], dim=1)           # reads t-1
    out = torch.cat([fwd[:, :, :c1], bwd[:, :, c1:c2], xr[:, :, c2:]],
                    dim=2)
    return {"Out": out.reshape(nt, c, h, w)}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution on a dense (B, T, D) batch (paddle_tpu's
    :227, ref row_conv_op.cc): out[b, t, d] = sum_{i=0..k} x[b, t+i, d] *
    w[i, d], zeros past the end."""
    x, w = ins["X"][0], ins["Filter"][0]
    ctx_len = w.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx_len - 1))
    out = x.new_zeros(x.shape)
    for i in range(ctx_len):               # static, small
        out = out + pad[:, i:i + t, :] * w[i][None, None, :]
    return {"Out": out}


# ---------------------------------------------------------------------------
# deformable conv (ref deformable_conv_op.cu): bilinear-sampled im2col at
# learned offsets, then one product a group
# ---------------------------------------------------------------------------

@register_op("deformable_conv", nondiff=())
def _deformable_conv(ctx, ins, attrs):
    x = ins["Input"][0]                   # (N, C, H, W)
    offset = ins["Offset"][0]             # (N, 2*dg*kh*kw, OH, OW), (y,x)
    w = ins["Filter"][0]                  # (O, C/g, kh, kw)
    mask = ins["Mask"][0] if ins.get("Mask") else None
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    dil = attrs.get("dilations", [1, 1])
    groups = attrs.get("groups", 1) or 1
    dg = attrs.get("deformable_groups", 1) or 1
    n, c, h, ww_ = x.shape
    o, _, kh, kw = w.shape
    oh = (h + 2 * pads[0] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    ow = (ww_ + 2 * pads[1] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    k = kh * kw
    dev = x.device

    # base sampling positions per (kernel tap, output pixel)
    oy = torch.arange(oh, device=dev) * strides[0] - pads[0]
    ox = torch.arange(ow, device=dev) * strides[1] - pads[1]
    ky = torch.arange(kh, device=dev) * dil[0]
    kx = torch.arange(kw, device=dev) * dil[1]
    base_y = (oy[None, None, :, None] + ky[:, None, None, None]) \
        .expand(kh, kw, oh, ow).reshape(k, oh, ow)
    base_x = (ox[None, None, None, :] + kx[None, :, None, None]) \
        .expand(kh, kw, oh, ow).reshape(k, oh, ow)

    off = offset.reshape(n, dg, k, 2, oh, ow)
    gy = base_y[None, None] + off[:, :, :, 0]     # (N, dg, K, OH, OW)
    gx = base_x[None, None] + off[:, :, :, 1]
    cd = c // dg
    # each deformable group's channels as rows of an (N*dg*H*W, C/dg)
    # table, sampled at that group's offsets
    table = x.reshape(n, dg, cd, h, ww_).permute(0, 1, 3, 4, 2) \
        .reshape(n * dg * h * ww_, cd)
    base = (torch.arange(n * dg, device=dev) * (h * ww_)) \
        .reshape(n, dg, 1, 1, 1)
    cols = _bilinear(table, base, gy, gx, h, ww_)  # (N,dg,K,OH,OW,C/dg)
    if mask is not None:
        cols = cols * mask.reshape(n, dg, k, oh, ow)[..., None]
    cols = cols.permute(0, 1, 5, 2, 3, 4).reshape(n, c, k, oh, ow)
    cg = c // groups
    cols = cols.reshape(n, groups, cg * k, oh * ow)
    wg = w.reshape(groups, o // groups, cg * k)
    out = torch.matmul(wg[None], cols)            # (N, g, O/g, OH*OW)
    return {"Output": out.reshape(n, o, oh, ow)}


# ---------------------------------------------------------------------------
# position-sensitive / precise RoI pooling: each bin averages an sr x sr
# grid of bilinear samples (paddle_tpu's _roi_sample_bins)
# ---------------------------------------------------------------------------

def _roi_batch_index(rois_num, num_rois, n):
    """RoisNum (N,) per-image counts -> (num_rois,) image index (a copy
    of paddle_tpu/ops/detection_ops.py's ``_roi_batch_index``), held in
    [0, n - 1] as a JAX gather clamps it."""
    ends = torch.cumsum(rois_num.reshape(-1).long(), 0)
    idx = (torch.arange(num_rois, device=rois_num.device)[:, None] >=
           ends[None, :]).sum(dim=1)
    return torch.clamp(idx, max=n - 1)


def _batch_index(ins, slot, r, n, device):
    if ins.get(slot):
        return _roi_batch_index(ins[slot][0], r, n)
    return torch.zeros((r,), dtype=torch.long, device=device)


def _sample_grid(rois, ph, pw, sr, h, w, spatial_scale):
    """Per RoI the bins' sample rows and columns, clipped to the map:
    (y0, y1, fy) of shape (R, PH*sr) and (x0, x1, fx) of (R, PW*sr)."""
    r = rois.shape[0]
    dev = rois.device
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    rw = torch.clamp(rois[:, 2] * spatial_scale - x1, min=0.1)
    rh = torch.clamp(rois[:, 3] * spatial_scale - y1, min=0.1)
    iy = (torch.arange(sr, device=dev, dtype=rois.dtype) + 0.5) / sr
    gy = y1[:, None, None] + (
        torch.arange(ph, device=dev, dtype=rois.dtype)[None, :, None] +
        iy[None, None, :]) * (rh / ph)[:, None, None]
    gx = x1[:, None, None] + (
        torch.arange(pw, device=dev, dtype=rois.dtype)[None, :, None] +
        iy[None, None, :]) * (rw / pw)[:, None, None]
    gy = torch.clamp(gy.reshape(r, ph * sr), 0.0, h - 1.0)
    gx = torch.clamp(gx.reshape(r, pw * sr), 0.0, w - 1.0)
    y0 = torch.floor(gy).long()
    x0 = torch.floor(gx).long()
    return ((y0, torch.clamp(y0 + 1, max=h - 1), gy - y0),
            (x0, torch.clamp(x0 + 1, max=w - 1), gx - x0))


@register_op("psroi_pool", nondiff=("ROIs", "RoisNum"))
def _psroi_pool(ctx, ins, attrs):
    """Position-sensitive RoI pooling (ref psroi_pool_op.h): bin (i, j)
    of output channel o averages input channel o*ph*pw + i*pw + j over a
    2 x 2 grid of bilinear samples (the JAX package's static-shape
    estimator). Only the channel each bin reads is gathered (the JAX
    package samples every channel at every bin, then keeps the
    diagonal: the same values)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    n, c, h, w = x.shape
    r = rois.shape[0]
    oc = int(attrs["output_channels"])
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    sr = 2
    scale = float(attrs.get("spatial_scale", 1.0))
    bidx = _batch_index(ins, "RoisNum", r, n, x.device)
    (y0, y1, fy), (x0, x1, fx) = _sample_grid(rois, ph, pw, sr, h, w, scale)
    dev = x.device
    # index grid (R, OC, PH, S, PW, S); channel (o, i, j)
    chan = (torch.arange(oc, device=dev)[:, None, None, None, None] *
            (ph * pw) +
            torch.arange(ph, device=dev)[None, :, None, None, None] * pw +
            torch.arange(pw, device=dev)[None, None, None, :, None])
    plane = ((bidx.reshape(r, 1, 1, 1, 1, 1) * c + chan[None]) * h)

    def rows_of(yy):
        return yy.reshape(r, 1, ph, sr, 1, 1)

    def cols_of(xx):
        return xx.reshape(r, 1, 1, 1, pw, sr)

    flat = x.reshape(-1)

    def read(yy, xx):
        return flat[(plane + rows_of(yy)) * w + cols_of(xx)]

    fyb = rows_of(fy)
    fxb = cols_of(fx)
    vals = (read(y0, x0) * (1 - fyb) * (1 - fxb) +
            read(y0, x1) * (1 - fyb) * fxb +
            read(y1, x0) * fyb * (1 - fxb) +
            read(y1, x1) * fyb * fxb)
    return {"Out": vals.mean(dim=(3, 5))}


def _bin_weights(lo, hi, frac, size, bins, sr):
    """(R, bins, size) weights of one axis: each bin's mean over its sr
    samples of the two bilinear taps' weights."""
    r = lo.shape[0]
    wts = (F.one_hot(lo, size).to(frac.dtype) * (1 - frac)[..., None] +
           F.one_hot(hi, size).to(frac.dtype) * frac[..., None])
    return wts.reshape(r, bins, sr, size).mean(dim=2)


@register_op("prroi_pool", nondiff=("ROIs", "BatchRoINums"))
def _prroi_pool(ctx, ins, attrs):
    """Precise RoI pooling (ref prroi_pool_op.h) as the JAX package
    computes it: each bin the mean of a 4 x 4 grid of bilinear samples of
    every channel. The grid is separable, so the mean is two products
    with per-RoI weights (rows, then columns) and no RoI's copy of the
    map is gathered; the image of each RoI is a one-hot factor of the
    row weights. (A non-finite value anywhere in an image then reaches
    every RoI of it, where the gathers would read only the taps.)"""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    n, c, h, w = x.shape
    r = rois.shape[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    sr = 4
    scale = float(attrs.get("spatial_scale", 1.0))
    bidx = _batch_index(ins, "BatchRoINums", r, n, x.device)
    (y0, y1, fy), (x0, x1, fx) = _sample_grid(rois, ph, pw, sr, h, w, scale)
    wy = _bin_weights(y0, y1, fy, h, ph, sr).to(x.dtype)    # (R, PH, H)
    wx = _bin_weights(x0, x1, fx, w, pw, sr).to(x.dtype)    # (R, PW, W)
    img = F.one_hot(bidx, n).to(x.dtype)                    # (R, N)
    wyn = (wy[:, :, None, :] * img[:, None, :, None]).reshape(r * ph, n * h)
    t = torch.matmul(wyn, x.permute(0, 2, 1, 3).reshape(n * h, c * w))
    t = t.reshape(r, ph * c, w)
    out = torch.matmul(t, wx.transpose(1, 2))               # (R, PH*C, PW)
    return {"Out": out.reshape(r, ph, c, pw).permute(0, 2, 1, 3)}
