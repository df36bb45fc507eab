"""Blockwise softmax cross-entropy and the fused LM/MLM head: the CUDA
kernels' wrappers, their plain versions and the autograd Functions that
pair them.

Replaces paddle_tpu/ops/pallas/blockwise_ce.py: ``_ce_call_fwd`` (kernel
``_ce_fwd_kernel``) and ``_ce_bwd`` (``_ce_bwd_kernel``), both in
``csrc/blockwise_ce.cu``; ``_head_call_fwd`` (``_head_fwd_kernel``;
``csrc/fused_head_fwd.cu``) and ``_head_bwd`` (``_head_dh_kernel`` and
``_head_dwb_kernel``; ``csrc/fused_head_bwd.cu``). Their shared device code
(online logsumexp, label hit, ds, finalisation) is
``csrc/blockwise_ce.cuh``; the head's forward kernel forms its scores
with ``wgmma`` (``csrc/wgmma_sm90.cuh``), its backward kernels with
``mma.sync`` (``csrc/mma_sm90.cuh``). The forward kernel takes a scratch
buffer the wrapper allocates (its operand planes and its vocabulary
splits' partials). Each source's header says what bounds it on the H100
and how its design meets that.

Every wrapper runs its kernel for a CUDA tensor and the plain version for
a CPU tensor; none falls back from one to the other. The plain versions
build the (T, V) logits: they are the CPU path and the kernels' oracle.
Launch counters: ``head_launches``, ``head_dh_launches``,
``head_dw_launches``, ``ce_launches``, ``ce_bwd_launches``.

Layout: ``hidden (T, D)``, ``weight (V, D)`` (the tied embedding table as
stored, never transposed), ``bias (V,)`` f32 or None, ``logits (T, V)``,
``labels (T,)`` int. hidden/weight/logits are f32 or bf16; sums are f32.
A label outside [0, V) (an ignore_index) hits no column: its loss is the
lse and its ds has no -1; callers zero such rows afterwards. Losses and
lse are f32 (T,); gradients come back in their input's dtype.
"""
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

head_launches = 0
head_dh_launches = 0
head_dw_launches = 0
ce_launches = 0
ce_bwd_launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _loss_from_logits(logits, labels):
    """(loss, lse) of f32 (T, V) logits: lse - logits[label], the label's
    term 0 where it lies outside [0, V)."""
    v = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    ok = (lab >= 0) & (lab < v)
    picked = torch.take_along_dim(logits, lab.clamp(0, v - 1)[:, None],
                                  dim=-1)[:, 0]
    return lse - torch.where(ok, picked, torch.zeros_like(picked)), lse


def _ds(logits, labels, lse, dloss):
    """(exp(s - lse) - onehot(label)) * dloss, f32 (T, V)."""
    v = logits.shape[-1]
    p = torch.exp(logits - lse[:, None])
    lab = labels.long()
    hit = torch.arange(v, device=logits.device)[None, :] == lab[:, None]
    return (p - hit.to(p.dtype)) * dloss.float()[:, None]


def _head_logits(hidden, weight, bias):
    s = torch.matmul(hidden.float(), weight.float().t())
    return s + bias.float() if bias is not None else s


def fused_head_loss_plain(hidden, weight, labels, bias=None):
    """(loss, lse) of the head in plain PyTorch, f32 logits."""
    return _loss_from_logits(_head_logits(hidden, weight, bias), labels)


def fused_head_bwd_plain(hidden, weight, labels, bias, lse, dloss):
    """(dhidden like hidden, dweight like weight, dbias f32 (V,))."""
    ds = _ds(_head_logits(hidden, weight, bias), labels, lse, dloss)
    dh = torch.matmul(ds, weight.float())
    dw = torch.matmul(ds.t(), hidden.float())
    return dh.to(hidden.dtype), dw.to(weight.dtype), ds.sum(dim=0)


def softmax_ce_plain(logits, labels):
    """(loss, lse) of existing logits in plain PyTorch, f32."""
    return _loss_from_logits(logits.float(), labels)


def softmax_ce_bwd_plain(logits, labels, lse, dloss):
    """dlogits like logits."""
    return _ds(logits.float(), labels, lse, dloss).to(logits.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_cuda(what, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError("%s runs on CUDA (kernel) or CPU (plain version), "
                             "got a %s tensor" % (what, t.device.type))


def _labels(labels, t, device):
    if labels.shape != (t,) or labels.is_floating_point():
        raise ValueError("labels must be integer (%d,), got %s %s"
                         % (t, labels.dtype, tuple(labels.shape)))
    return labels.to(device=device, dtype=torch.int64).contiguous()


def _row_vec(x, t, device, what):
    if x.numel() != t:
        raise ValueError("%s must have %d elements, got %s"
                         % (what, t, tuple(x.shape)))
    return x.to(device=device, dtype=torch.float32).reshape(t).contiguous()


def _head_operands(what, hidden, weight, labels, bias):
    """Checked dense operands of a head kernel: (h, w, labels, bias, t, v,
    d)."""
    _check_cuda(what, hidden, weight)
    if hidden.dim() != 2 or weight.dim() != 2 or \
            hidden.shape[1] != weight.shape[1]:
        raise ValueError("%s wants hidden (T, D) and weight (V, D), got %s "
                         "and %s" % (what, tuple(hidden.shape),
                                     tuple(weight.shape)))
    if hidden.dtype not in _DTYPES or weight.dtype != hidden.dtype:
        raise ValueError("%s kernel takes float32 or bfloat16 hidden and "
                         "weight of one dtype, got %s/%s"
                         % (what, hidden.dtype, weight.dtype))
    t, d = hidden.shape
    v = weight.shape[0]
    lib = build.load()
    max_d = lib.ptt_fused_head_max_d()
    if not 1 <= d <= max_d or t < 1 or v < 1:
        raise ValueError("%s kernel takes 1..%d hidden columns and non-empty "
                         "T and V, got (T, D, V) = (%d, %d, %d)"
                         % (what, max_d, t, d, v))
    b = None
    if bias is not None:
        b = _row_vec(bias, v, hidden.device, "bias")
    return (hidden.contiguous(), weight.contiguous(),
            _labels(labels, t, hidden.device), b, t, v, d, lib)


def fused_head_loss(hidden, weight, labels, bias=None):
    """(loss, lse), both f32 (T,), of softmax(hidden @ weight^T + bias)
    at labels: the head forward kernel for a CUDA tensor."""
    global head_launches
    if hidden.device.type == "cpu":
        return fused_head_loss_plain(hidden, weight, labels, bias)
    h, w, lab, b, t, v, d, lib = _head_operands(
        "fused_head_loss", hidden, weight, labels, bias)
    loss = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(h.device):
        # the kernel's operand planes and its vocabulary splits' partials
        scratch = torch.empty(
            lib.ptt_fused_head_fwd_scratch_bytes(t, v, d, _DTYPES[h.dtype]),
            dtype=torch.uint8, device=h.device)
        rc = lib.ptt_fused_head_fwd(
            h.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            lab.data_ptr(), loss.data_ptr(), lse.data_ptr(), t, v, d,
            _DTYPES[h.dtype], scratch.data_ptr(), _stream())
    build.check(rc, "fused_head_fwd")
    head_launches += 1
    return loss, lse


def _head_bwd_operands(what, hidden, weight, labels, bias, lse, dloss):
    """Checked dense operands of the head's backward kernels, made once
    for both."""
    h, w, lab, b, t, v, d, lib = _head_operands(what, hidden, weight, labels,
                                                bias)
    return (h, w, lab, b, _row_vec(lse, t, h.device, "lse"),
            _row_vec(dloss, t, h.device, "dloss"), t, v, d, lib)


def _launch_dh(operands):
    global head_dh_launches
    h, w, lab, b, lse, dl, t, v, d, lib = operands
    dh = torch.empty_like(h)
    with torch.cuda.device(h.device):
        rc = lib.ptt_fused_head_dh(
            h.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            lab.data_ptr(), lse.data_ptr(), dl.data_ptr(), dh.data_ptr(), t,
            v, d, _DTYPES[h.dtype], _stream())
    build.check(rc, "fused_head_dh")
    head_dh_launches += 1
    return dh


def _launch_dw(operands):
    global head_dw_launches
    h, w, lab, b, lse, dl, t, v, d, lib = operands
    dw = torch.empty_like(w)
    db = torch.empty(v, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.ptt_fused_head_dw(
            h.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            lab.data_ptr(), lse.data_ptr(), dl.data_ptr(), dw.data_ptr(),
            db.data_ptr(), t, v, d, _DTYPES[h.dtype], _stream())
    build.check(rc, "fused_head_dw")
    head_dw_launches += 1
    return dw, db


def fused_head_dhidden(hidden, weight, labels, bias, lse, dloss):
    """dhidden (T, D) like hidden, by the dhidden kernel, from the
    forward's lse and the loss cotangent."""
    if hidden.device.type == "cpu":
        return fused_head_bwd_plain(hidden, weight, labels, bias, lse,
                                    dloss)[0]
    return _launch_dh(_head_bwd_operands(
        "fused_head_dhidden", hidden, weight, labels, bias, lse, dloss))


def fused_head_dweight(hidden, weight, labels, bias, lse, dloss):
    """(dweight (V, D) like weight, dbias f32 (V,)) by the dweight
    kernel."""
    if hidden.device.type == "cpu":
        return fused_head_bwd_plain(hidden, weight, labels, bias, lse,
                                    dloss)[1:]
    return _launch_dw(_head_bwd_operands(
        "fused_head_dweight", hidden, weight, labels, bias, lse, dloss))


def fused_head_bwd(hidden, weight, labels, bias, lse, dloss, need_dh=True,
                   need_dw=True):
    """(dhidden, dweight, dbias): both backward kernels for a CUDA
    tensor, on operands prepared once; the plain backward for a CPU
    tensor. A gradient not needed (``need_dh``, ``need_dw``: dweight and
    dbias come from one kernel) is None and its kernel is not launched."""
    if hidden.device.type == "cpu":
        dh, dw, db = fused_head_bwd_plain(hidden, weight, labels, bias, lse,
                                          dloss)
        return (dh if need_dh else None,) + \
            ((dw, db) if need_dw else (None, None))
    operands = _head_bwd_operands("fused_head_bwd", hidden, weight, labels,
                                  bias, lse, dloss)
    dh = _launch_dh(operands) if need_dh else None
    dw, db = _launch_dw(operands) if need_dw else (None, None)
    return dh, dw, db


def _ce_operands(what, logits, labels):
    _check_cuda(what, logits)
    if logits.dim() != 2 or logits.dtype not in _DTYPES:
        raise ValueError("%s kernel takes float32 or bfloat16 (T, V) logits, "
                         "got %s %s" % (what, logits.dtype,
                                        tuple(logits.shape)))
    t, v = logits.shape
    if t < 1 or v < 1:
        raise ValueError("%s kernel needs non-empty (T, V), got (%d, %d)"
                         % (what, t, v))
    return logits.contiguous(), _labels(labels, t, logits.device), t, v


def softmax_ce(logits, labels):
    """(loss, lse), both f32 (T,), of existing (T, V) logits: the CE
    forward kernel for a CUDA tensor."""
    global ce_launches
    if logits.device.type == "cpu":
        return softmax_ce_plain(logits, labels)
    x, lab, t, v = _ce_operands("softmax_ce", logits, labels)
    loss = torch.empty(t, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = lib.ptt_ce_fwd(x.data_ptr(), lab.data_ptr(), loss.data_ptr(),
                            lse.data_ptr(), t, v, _DTYPES[x.dtype], _stream())
    build.check(rc, "ce_fwd")
    ce_launches += 1
    return loss, lse


def softmax_ce_bwd(logits, labels, lse, dloss):
    """dlogits like logits, by the CE backward kernel."""
    global ce_bwd_launches
    if logits.device.type == "cpu":
        return softmax_ce_bwd_plain(logits, labels, lse, dloss)
    x, lab, t, v = _ce_operands("softmax_ce_bwd", logits, labels)
    lse = _row_vec(lse, t, x.device, "lse")
    dl = _row_vec(dloss, t, x.device, "dloss")
    dx = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        rc = lib.ptt_ce_bwd(x.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                            dl.data_ptr(), dx.data_ptr(), t, v,
                            _DTYPES[x.dtype], _stream())
    build.check(rc, "ce_bwd")
    ce_bwd_launches += 1
    return dx


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class FusedHeadLoss(torch.autograd.Function):
    """``FusedHeadLoss.apply(hidden, weight, bias, labels) -> loss (T,)``
    f32: the head forward kernel, and in backward the dhidden and dweight
    kernels from the saved lse. bias may be None; labels get no
    gradient."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels):
        loss, lse = fused_head_loss(hidden, weight, labels, bias)
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        dh, dw, db = fused_head_bwd(hidden, weight, labels, bias, lse, dloss,
                                    need_dh=need[0],
                                    need_dw=need[1] or need[2])
        return (dh, dw if need[1] else None,
                db.to(bias.dtype) if need[2] else None, None)


class BlockwiseCE(torch.autograd.Function):
    """``BlockwiseCE.apply(logits, labels) -> (loss, lse)``, both f32
    (T,): the CE forward kernel, and in backward the CE backward kernel.
    lse is differentiable (d lse / d logits = softmax), so a softmax a
    caller builds as exp(logits - lse) gets its true gradient; that term
    is one elementwise expression beside the kernel, added only when the
    lse receives a cotangent."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.set_materialize_grads(False)
        loss, lse = softmax_ce(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss, lse

    @staticmethod
    def backward(ctx, dloss, dlse):
        logits, labels, lse = ctx.saved_tensors
        if dloss is None:
            dloss = torch.zeros_like(lse)
        dx = softmax_ce_bwd(logits, labels, lse, dloss)
        if dlse is not None:
            dx = dx + (torch.exp(logits.float() - lse[:, None]) *
                       dlse.float()[:, None]).to(dx.dtype)
        return dx, None
