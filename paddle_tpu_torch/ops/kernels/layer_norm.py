"""LayerNorm, forward and backward: the CUDA kernels' wrappers, their plain
versions and the autograd Function that pairs them.

Replaces paddle_tpu/ops/pallas/layer_norm.py: ``_ln_call_fwd`` (kernel
``_ln_fwd_kernel``; ``csrc/layer_norm_fwd.cu``) and ``_ln_bwd`` (kernel
``_ln_bwd_kernel``; ``csrc/layer_norm_bwd.cu``). Each source's header says
what bounds it on the H100 (the bytes: a few flops per element) and how
its design meets that.

``layer_norm`` and ``layer_norm_bwd`` run their kernel for a CUDA tensor
and the plain version for a CPU tensor; they never fall back from one to
the other. ``launches`` and ``bwd_launches`` count the kernels' launches
(the backward's two passes count as one launch of one kernel).
``LayerNorm`` (a ``torch.autograd.Function``) pairs them; its mean and
rstd outputs are not differentiable.

x is (rows, cols) f32 or bf16, normalised over cols; scale and bias are
optional (cols,). The forward returns (y like x, mean (rows,) f32,
rstd (rows,) f32); the backward (dx like x, dscale (cols,) f32,
dbias (cols,) f32).
"""
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
# blocks of the backward's first pass: four 256-thread blocks per SM of
# the H100's 132 (the partial column sums grow with the count)
_BWD_BLOCKS = 4 * 132


def layer_norm_plain(x, scale=None, bias=None, eps=1e-5):
    """The same function in plain PyTorch: f32 mean first, then the
    variance of the centred values (the CPU path and the kernel's
    oracle)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def _vec(t, cols, device, what):
    if t is None:
        return None
    if t.numel() != cols:
        raise ValueError("layer_norm %s has %d elements for %d cols"
                         % (what, t.numel(), cols))
    return t.to(device=device, dtype=torch.float32).reshape(cols).contiguous()


def layer_norm(x, scale=None, bias=None, eps=1e-5):
    """LayerNorm forward over the last axis of 2-D x; see the module
    docstring."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % x.device.type)
    if x.dim() != 2:
        raise ValueError("layer_norm kernel wants 2-D (rows, cols) x, got "
                         "%s" % (tuple(x.shape),))
    if x.dtype not in _DTYPES:
        raise ValueError("layer_norm kernel takes float32 or bfloat16, got "
                         "%s" % x.dtype)
    rows, cols = x.shape
    lib = build.load()
    max_cols = lib.ptt_layer_norm_max_cols()
    if not 1 <= cols <= max_cols:
        raise ValueError("layer_norm kernel takes 1..%d cols, got %d"
                         % (max_cols, cols))
    x = x.contiguous()
    s = _vec(scale, cols, x.device, "scale")
    b = _vec(bias, cols, x.device, "bias")
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        rc = lib.ptt_layer_norm_fwd(
            x.data_ptr(), None if s is None else s.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, cols, _DTYPES[x.dtype],
            float(eps), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "layer_norm_fwd")
    launches += 1
    return y, mean, rstd


def layer_norm_bwd_plain(x, g, scale, mean, rstd):
    """The backward in plain PyTorch, f32 sums (the CPU path and the
    kernel's oracle): dx = rstd * (gs - mean(gs) - x_hat * mean(gs * x_hat))
    with gs = g * scale; dscale = sum_rows g * x_hat; dbias = sum_rows g."""
    xf, gf = x.float(), g.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    gs = gf * scale.float() if scale is not None else gf
    mg = gs.mean(dim=-1, keepdim=True)
    mgx = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (gs - mg - xhat * mgx)
    return dx.to(x.dtype), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def layer_norm_bwd(x, g, scale, mean, rstd):
    """LayerNorm backward over the last axis of 2-D x, from the forward's
    mean and rstd; see the module docstring."""
    global bwd_launches
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, g, scale, mean, rstd)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_bwd runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % x.device.type)
    if x.dim() != 2 or g.shape != x.shape:
        raise ValueError("layer_norm_bwd wants 2-D x and g of one shape, got "
                         "%s and %s" % (tuple(x.shape), tuple(g.shape)))
    if x.dtype not in _DTYPES:
        raise ValueError("layer_norm_bwd kernel takes float32 or bfloat16, "
                         "got %s" % x.dtype)
    rows, cols = x.shape
    lib = build.load()
    max_cols = lib.ptt_layer_norm_max_cols()
    if not 1 <= cols <= max_cols:
        raise ValueError("layer_norm_bwd kernel takes 1..%d cols, got %d"
                         % (max_cols, cols))
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError("layer_norm_bwd: %s must be float32 (%d,), got "
                             "%s %s" % (name, rows, t.dtype, tuple(t.shape)))
    x, mean, rstd = x.contiguous(), mean.contiguous(), rstd.contiguous()
    g = g.to(x.dtype).contiguous()
    s = _vec(scale, cols, x.device, "scale")
    dx = torch.empty_like(x)
    dscale = torch.empty(cols, dtype=torch.float32, device=x.device)
    dbias = torch.empty(cols, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_(), dbias.zero_()
    rows_per_block = -(-rows // min(rows, _BWD_BLOCKS))
    blocks = -(-rows // rows_per_block)
    ds_part = torch.empty((blocks, cols), dtype=torch.float32,
                          device=x.device)
    db_part = torch.empty_like(ds_part)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.ptt_layer_norm_bwd(
            x.data_ptr(), g.data_ptr(), None if s is None else s.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            ds_part.data_ptr(), db_part.data_ptr(), rows, cols,
            _DTYPES[x.dtype], rows_per_block, stream)
        build.check(rc, "layer_norm_bwd")
        rc = lib.ptt_layer_norm_bwd_reduce(
            ds_part.data_ptr(), db_part.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), blocks, cols, stream)
    build.check(rc, "layer_norm_bwd_reduce")
    bwd_launches += 1
    return dx, dscale, dbias


class LayerNorm(torch.autograd.Function):
    """``LayerNorm.apply(x, scale, bias, eps) -> (y, mean, rstd)`` over
    the last axis of 2-D x: the forward kernel, and in backward the
    backward kernel. mean and rstd carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        if bias is not None:
            ctx.bias_shape, ctx.bias_dtype = bias.shape, bias.dtype
        return y, mean, rstd

    @staticmethod
    def backward(ctx, gy, gmean, grstd):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, gy, scale, mean, rstd)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dscale.reshape(scale.shape).to(scale.dtype)
                if need[1] else None,
                dbias.reshape(ctx.bias_shape).to(ctx.bias_dtype)
                if need[2] else None,
                None)
