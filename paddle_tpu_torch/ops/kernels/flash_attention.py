"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd Function that pairs them.

Replaces paddle_tpu/ops/pallas/flash_attention.py: ``_pallas_forward``
(kernel ``_fwd_kernel``; ``csrc/flash_attention_fwd.cu``) and
``_pallas_backward`` (kernels ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``;
``csrc/flash_attention_bwd.cu``). Each source's header says what bounds
it on the H100 (the f32 operations at BERT-base shapes) and how its
design meets that.

``flash_attention`` and ``flash_attention_bwd_dkv`` / ``_dq`` run their
kernel for a CUDA tensor and the plain version for a CPU tensor; they
never fall back from one to the other. ``launches``, ``dkv_launches`` and
``dq_launches`` count the three kernels' launches; ``f16_launches``,
``f16_dkv_launches`` and ``f16_dq_launches`` count those of them that ran
the fp16 instantiation. ``FlashAttention``
(a ``torch.autograd.Function``) runs the forward kernel and, in backward,
both backward kernels from the forward's lse; the mask's cotangent is
the plain ``flash_attention_dmask`` and is computed only when asked for.

The forward is also the operator ``paddle_tpu_torch::flash_attention_fwd``
(``flash_attention_fwd``, ``torch.ops.paddle_tpu_torch.flash_attention_fwd``;
``scale`` a float), which ``FlashAttention`` calls: its fake
implementation gives the output shapes, so ``torch.export`` records the
op in the graph in place of tracing into the launch, and the dispatcher
picks the kernel (CUDA) or the plain version (CPU) by the tensors'
device when the exported program runs.

Layout (the JAX package's): q (B, H, Tq, D), k/v (B, H, Tk, D), f32,
bf16 or fp16 (the kernels compute fp16 as the JAX kernel does, in f32 from
the fp16 values; each source's header says how); additive mask broadcastable as (B, 1, 1, Tk) or (B, 1, Tq, Tk);
causal is bottom-right aligned (query i sees keys j <= i + Tk - Tq).
Returns (out like q, lse (B, H, Tq) f32). A causal row that sees no key
(Tq > Tk) comes out uniform over all keys, and its gradient is the one
the JAX package's XLA reference gives it: dq = 0, no dk, dv += dO / Tk.
"""
import torch

from . import build

NEG_INF = -1e30          # the masked-logit fill of the TPU kernel
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0
dkv_launches = 0
dq_launches = 0
f16_launches = 0
f16_dkv_launches = 0
f16_dq_launches = 0


def flash_attention_plain(q, k, v, mask=None, scale=None, causal=False):
    """The same function in plain PyTorch, f32 throughout (the CPU path
    and the kernel's oracle)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tq, tk = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        s = s.masked_fill(~_causal_keep(tq, tk, q.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


def _causal_keep(tq, tk, device):
    """(Tq, Tk) bool: query i sees keys j <= i + Tk - Tq."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril(tk - tq)


def flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout, scale=None,
                              causal=False):
    """(dq, dk, dv) in plain PyTorch, f32 throughout, by the kernels'
    recipe: p = exp(s - lse), ds = p * (dO v^T - delta) with
    delta = rowsum(dO * O); a causal row that sees no key gets p = 1/Tk
    and ds = 0 (the CPU path and the kernels' oracle)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tq, tk = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.float()
    if causal:
        s = s.masked_fill(~_causal_keep(tq, tk, q.device), NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    if causal and tq > tk:
        no_key = torch.arange(tq, device=q.device) + (tk - tq) < 0
        p = p.masked_fill(no_key[:, None], 1.0 / tk)
        ds = ds.masked_fill(no_key[:, None], 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dmask(q, k, v, mask, out, lse, dout, scale, causal):
    """The mask's cotangent, by the JAX package's plain formula
    (``_xla_dmask``): ds summed over the axes the mask broadcasts. It
    builds a (B, H, Tq, Tk) tensor, so callers compute it only when the
    mask's gradient is asked for."""
    tq, tk = q.shape[-2], k.shape[-2]
    dof = dout.float()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s + mask.float() - lse[..., None])
    if causal:
        p = torch.where(_causal_keep(tq, tk, q.device), p,
                        torch.zeros((), device=q.device))
    delta = (dof * out.float()).sum(-1)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) -
              delta[..., None])
    axes = tuple(ax for ax in range(4)
                 if mask.shape[ax] == 1 and ds.shape[ax] > 1)
    return (ds.sum(dim=axes, keepdim=True) if axes else ds).to(mask.dtype)


def _mask_operand(mask, b, tq, tk):
    """(f32 contiguous mask, stride_b, stride_q) for the kernel."""
    if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[3] != tk \
            or mask.shape[0] not in (1, b) or mask.shape[2] not in (1, tq):
        raise ValueError(
            "flash_attention mask must be (B|1, 1, 1|Tq, Tk) = "
            "(%d|1, 1, 1|%d, %d), got %s" % (b, tq, tk, tuple(mask.shape)))
    m = mask.to(torch.float32).contiguous()
    mq = m.shape[2]
    stride_b = mq * tk if m.shape[0] == b else 0
    stride_q = tk if mq == tq and tq > 1 else 0
    return m, stride_b, stride_q


def _check_kernel_operands(q, k, v):
    """Raise on what the kernels do not take; returns (b, h, tq, tk, d)."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention runs on CUDA (kernel) or CPU "
                         "(plain version), got a %s tensor" % q.device.type)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants (B, H, T, D) q/k/v")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError("flash_attention shapes disagree: q %s k %s v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if d not in HEAD_DIMS:
        raise ValueError("flash_attention kernel takes head dim %s, got %d"
                         % (HEAD_DIMS, d))
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes float32, bfloat16 or "
                         "float16 q/k/v of one dtype, got %s/%s/%s"
                         % (q.dtype, k.dtype, v.dtype))
    if b * h > 65535:
        raise ValueError("flash_attention kernel: B*H=%d exceeds the grid's "
                         "65535" % (b * h))
    if tk == 0:
        raise ValueError("flash_attention needs at least one key")
    return b, h, tq, tk, d


def flash_attention(q, k, v, mask=None, scale=None, causal=False):
    """Flash-attention forward; see the module docstring."""
    global launches, f16_launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale, causal)
    b, h, tq, tk, d = _check_kernel_operands(q, k, v)
    if scale is None:
        scale = d ** -0.5
    # transpose2 hands over strided views: copy them to the dense layout
    # the kernel indexes, never read strided memory by accident
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0:
        return out, lse
    m, stride_b, stride_q = None, 0, 0
    if mask is not None:
        m, stride_b, stride_q = _mask_operand(mask.to(q.device), b, tq, tk)
    lib = build.load()
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, d, _DTYPES[q.dtype], stride_b,
            stride_q, float(scale), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_fwd")
    launches += 1
    f16_launches += q.dtype == torch.float16
    return out, lse


def _bwd_operands(q, k, v, mask, lse, delta, dout):
    """Dense operands of a backward kernel, checked; mask as the forward
    takes it."""
    b, h, tq, tk, d = _check_kernel_operands(q, k, v)
    if dout.shape != q.shape:
        raise ValueError("flash_attention backward: dout %s is not q's shape "
                         "%s" % (tuple(dout.shape), tuple(q.shape)))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError("flash_attention backward: %s must be float32 "
                             "(B, H, Tq) = %s, got %s %s"
                             % (name, (b, h, tq), t.dtype, tuple(t.shape)))
    m, stride_b, stride_q = None, 0, 0
    if mask is not None:
        m, stride_b, stride_q = _mask_operand(mask.to(q.device), b, tq, tk)
    dense = [t.contiguous() for t in (q, k, v, dout.to(q.dtype), lse, delta)]
    return dense, m, stride_b, stride_q, (b, h, tq, tk, d)


def flash_attention_bwd_dkv(q, k, v, mask, lse, delta, dout, scale=None,
                            causal=False):
    """(dk, dv) by the dK/dV kernel, from the forward's lse and
    delta = rowsum(dO * O) (both f32 (B, H, Tq))."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         scale, causal)[1:]
    return _launch_dkv(_bwd_operands(q, k, v, mask, lse, delta, dout),
                       scale, causal)


def _launch_dkv(operands, scale, causal):
    global dkv_launches, f16_dkv_launches
    (q, k, v, dout, lse, delta), m, sb, sq, (b, h, tq, tk, d) = operands
    if scale is None:
        scale = d ** -0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if tk == 0 or tq == 0:
        return dk.zero_(), dv.zero_()
    lib = build.load()
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if m is None else m.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, tq, tk, d, _DTYPES[q.dtype], sb, sq,
            float(scale), int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_bwd_dkv")
    dkv_launches += 1
    f16_dkv_launches += q.dtype == torch.float16
    return dk, dv


def flash_attention_bwd_dq(q, k, v, mask, lse, delta, dout, scale=None,
                           causal=False):
    """dq by the dQ kernel (see flash_attention_bwd_dkv)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         scale, causal)[0]
    return _launch_dq(_bwd_operands(q, k, v, mask, lse, delta, dout), scale,
                      causal)


def _launch_dq(operands, scale, causal):
    global dq_launches, f16_dq_launches
    (q, k, v, dout, lse, delta), m, sb, sq, (b, h, tq, tk, d) = operands
    if scale is None:
        scale = d ** -0.5
    dq = torch.empty_like(q)
    if tq == 0:
        return dq
    lib = build.load()
    with torch.cuda.device(q.device):
        rc = lib.ptt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if m is None else m.data_ptr(), dq.data_ptr(), b, h, tq,
            tk, d, _DTYPES[q.dtype], sb, sq, float(scale),
            int(bool(causal)), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_bwd_dq")
    dq_launches += 1
    f16_dq_launches += q.dtype == torch.float16
    return dq


def flash_attention_bwd(q, k, v, mask, out, lse, dout, scale=None,
                        causal=False):
    """(dq, dk, dv): both backward kernels for a CUDA tensor, the plain
    backward for a CPU tensor. delta = rowsum(dO * O) is a torch
    expression, as in the JAX package. The dense operands (a strided dout
    copied once) are made once for both kernels."""
    delta = (dout.float() * out.float()).sum(-1)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, lse, delta, dout,
                                         scale, causal)
    operands = _bwd_operands(q, k, v, mask, lse, delta, dout)
    dk, dv = _launch_dkv(operands, scale, causal)
    return _launch_dq(operands, scale, causal), dk, dv


# the op's schema, its kernels by dispatch key and its fake implementation
# (torch.library.Library: unlike torch.library.custom_op, a call does not
# go through torch._dynamo, whose import on the first call costs seconds
# and its dispatch tens of microseconds)
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, "
            "float scale, bool causal) -> (Tensor, Tensor)")
for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention_fwd", flash_attention, _key)


@torch.library.register_fake("paddle_tpu_torch::flash_attention_fwd",
                             lib=_LIB)
def _flash_attention_fwd_fake(q, k, v, mask, scale, causal):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


flash_attention_fwd = torch.ops.paddle_tpu_torch.flash_attention_fwd.default


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, mask, scale, causal) -> out``: the
    forward kernel, and in backward the two backward kernels from the
    saved lse. The mask gets a cotangent only when autograd asks for one
    (a learned bias); a padding mask from the data asks for none."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if scale is None:
            scale = q.shape[-1] ** -0.5
        out, lse = flash_attention_fwd(q, k, v, mask, float(scale),
                                       bool(causal))
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout,
                                         ctx.scale, ctx.causal)
        dmask = None
        if mask is not None and ctx.needs_input_grad[3]:
            dmask = flash_attention_dmask(q, k, v, mask, out, lse, dout,
                                          ctx.scale, ctx.causal)
        return dq, dk, dv, dmask, None, None
