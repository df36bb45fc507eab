"""LayerNorm, forward and backward: the CUDA kernels' wrappers, their plain
versions and the autograd Function that pairs them.

Replaces paddle_tpu/ops/pallas/layer_norm.py: ``_ln_call_fwd`` (kernel
``_ln_fwd_kernel``; ``csrc/layer_norm_fwd.cu``) and ``_ln_bwd`` (kernel
``_ln_bwd_kernel``; ``csrc/layer_norm_bwd.cu``). Each source's header says
what bounds it on the H100 (the bytes: a few flops per element) and how
its design meets that; ``_ln_plan`` picks the kernels' launch.

``layer_norm`` and ``layer_norm_bwd`` run their kernel for a CUDA tensor
and the plain version for a CPU tensor; they never fall back from one to
the other. ``launches`` and ``bwd_launches`` count the kernels' launches
(the backward's row pass and column sum count as one launch of one
kernel). ``LayerNorm`` (a ``torch.autograd.Function``) pairs them; its
mean and rstd outputs are not differentiable. The forward is also the
operator ``paddle_tpu_torch::layer_norm_fwd`` (``layer_norm_fwd``; ``eps``
a float), which ``LayerNorm`` calls, so that ``torch.export`` records it
in the graph (see flash_attention.py).

x is (rows, cols) f32 or bf16, normalised over cols; scale and bias are
optional (cols,). The forward returns (y like x, mean (rows,) f32,
rstd (rows,) f32); the backward (dx like x, dscale (cols,) f32,
dbias (cols,) f32).
"""
import collections

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PACK = {torch.float32: 4, torch.bfloat16: 8}     # values in 16 bytes

launches = 0
bwd_launches = 0

# The kernels' launch plan (csrc/layer_norm.cuh). A row's team, one warp
# (warp tier) or a block of 2-16 warps (block tier), holds the row in
# registers: each thread ``k`` packs of ``vec`` values, at most
# _MAX_PER_LANE values. ``vec`` is 16 bytes of x's type when every pointer
# is 16-byte aligned and cols a multiple of it, else 1. ``k`` is the
# smallest rung of _K_LADDER (the instances the C entries hold) that covers
# the row. The grid is persistent: the blocks that fit on the card at once
# (``per_sm`` a multiprocessor), never more than the rows need. The
# backward writes one partial row of dscale and dbias per block.
_K_LADDER = (1, 2, 3, 4, 6, 8, 16, 32)
_MAX_PER_LANE = 32
_ROW_WARPS = 8                      # warp tier: rows a block walks at once
_MAX_TEAM_WARPS = 16
_H100_SMS = 132

LnPlan = collections.namedtuple(
    "LnPlan", "tier vec k values_per_lane team_warps threads grid "
    "partial_rows")


def _ln_plan(rows, cols, dtype, aligned, backward=False, sms=_H100_SMS):
    """The launch of the forward (or, with ``backward``, the backward)
    kernel for x (rows, cols) of ``dtype``; ``aligned``: x, the outputs,
    scale and bias all start on 16 bytes."""
    vec = _PACK[dtype] if aligned and cols % _PACK[dtype] == 0 else 1
    team = 1
    while 32 * team * _MAX_PER_LANE < cols:
        team *= 2
    if team > _MAX_TEAM_WARPS:
        raise ValueError("layer_norm takes up to %d cols, got %d"
                         % (32 * _MAX_TEAM_WARPS * _MAX_PER_LANE, cols))
    need = -(-cols // (32 * team * vec))
    k = next(r for r in _K_LADDER if r >= need)
    if team == 1:
        threads = 32 * _ROW_WARPS
        blocks = -(-rows // _ROW_WARPS)
        # registers (the kernels' __launch_bounds__): two blocks an SM
        # while a lane holds up to 24 values of the forward (x, the next
        # row, scale, bias); one for the backward and above
        per_sm = 1 if backward or k * vec > 24 else 2
    else:
        threads = 32 * team
        blocks = rows
        per_sm = max(1, 256 // threads)     # up to 255 registers a thread
    grid = max(1, min(blocks, per_sm * sms))
    return LnPlan("warp" if team == 1 else "block", vec, k, k * vec, team,
                  threads, grid, grid if backward else 0)


_max_cols = None
_sms = {}


def _limits(device):
    """(max cols, SM count of ``device``), each read once."""
    global _max_cols
    if _max_cols is None:
        _max_cols = build.load().ptt_layer_norm_max_cols()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _max_cols, _sms[index]


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


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


def _check(what, x, max_cols):
    if x.dim() != 2:
        raise ValueError("%s kernel wants 2-D (rows, cols) x, got %s"
                         % (what, tuple(x.shape)))
    if x.dtype not in _DTYPES:
        raise ValueError("%s kernel takes float32 or bfloat16, got %s"
                         % (what, x.dtype))
    if not 1 <= x.shape[1] <= max_cols:
        raise ValueError("%s kernel takes 1..%d cols, got %d"
                         % (what, max_cols, x.shape[1]))


def layer_norm(x, scale=None, bias=None, eps=1e-5):
    """LayerNorm forward over the last axis of 2-D x; see the module
    docstring."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % x.device.type)
    max_cols, sms = _limits(x.device)
    _check("layer_norm", x, max_cols)
    rows, cols = x.shape
    x = x.contiguous()
    s = _vec(scale, cols, x.device, "scale")
    b = _vec(bias, cols, x.device, "bias")
    y = torch.empty_like(x)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rstd
    plan = _ln_plan(rows, cols, x.dtype, _aligned(x, y, s, b), sms=sms)
    with torch.cuda.device(x.device):
        rc = build.load().ptt_layer_norm_fwd(
            x.data_ptr(), None if s is None else s.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, cols, _DTYPES[x.dtype],
            float(eps), plan.vec, plan.k, plan.team_warps, plan.grid,
            torch.cuda.current_stream().cuda_stream)
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
    if g.shape != x.shape:
        raise ValueError("layer_norm_bwd wants x and g of one shape, got "
                         "%s and %s" % (tuple(x.shape), tuple(g.shape)))
    max_cols, sms = _limits(x.device)
    _check("layer_norm_bwd", x, max_cols)
    rows, cols = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError("layer_norm_bwd: %s must be float32 (%d,), got "
                             "%s %s" % (name, rows, t.dtype, tuple(t.shape)))
    x, mean, rstd = x.contiguous(), mean.contiguous(), rstd.contiguous()
    g = g.to(x.dtype).contiguous()
    s = _vec(scale, cols, x.device, "scale")
    dx = torch.empty_like(x)
    if rows == 0:
        zeros = torch.zeros(cols, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    plan = _ln_plan(rows, cols, x.dtype, _aligned(x, g, dx, s),
                    backward=True, sms=sms)
    part = torch.empty((2, plan.partial_rows, cols), dtype=torch.float32,
                       device=x.device)
    dscale, dbias = torch.empty((2, cols), dtype=torch.float32,
                                device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load().ptt_layer_norm_bwd(
            x.data_ptr(), g.data_ptr(), None if s is None else s.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), rows, cols,
            _DTYPES[x.dtype], plan.vec, plan.k, plan.team_warps, plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "layer_norm_bwd")
    bwd_launches += 1
    return dx, dscale, dbias


# the op's schema, kernels and fake implementation (see flash_attention.py)
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("layer_norm_fwd(Tensor x, Tensor? scale, Tensor? bias, "
            "float eps) -> (Tensor, Tensor, Tensor)")
for _key in ("CPU", "CUDA"):
    _LIB.impl("layer_norm_fwd", layer_norm, _key)


@torch.library.register_fake("paddle_tpu_torch::layer_norm_fwd", lib=_LIB)
def _layer_norm_fwd_fake(x, scale, bias, eps):
    rows = x.shape[0]
    return (torch.empty_like(x),
            x.new_empty((rows,), dtype=torch.float32),
            x.new_empty((rows,), dtype=torch.float32))


layer_norm_fwd = torch.ops.paddle_tpu_torch.layer_norm_fwd.default


class LayerNorm(torch.autograd.Function):
    """``LayerNorm.apply(x, scale, bias, eps) -> (y, mean, rstd)`` over
    the last axis of 2-D x: the forward kernel, and in backward the
    backward kernel. mean and rstd carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, scale, bias, float(eps))
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
