"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_forward (kernel
``_fwd_kernel``). The kernel is ``csrc/flash_attention_fwd.cu``; its
header says what bounds it on the H100 (the f32 operations at BERT-base
shapes) and how its design meets that (a query tile per block, key tiles
staged in shared memory, f32 online-softmax state in registers).

``flash_attention`` runs the kernel for a CUDA tensor and the plain
version for a CPU tensor; it never falls back from one to the other.
``launches`` counts the kernel's launches.

Layout (the JAX package's): q (B, H, Tq, D), k/v (B, H, Tk, D), f32 or
bf16; additive mask broadcastable as (B, 1, 1, Tk) or (B, 1, Tq, Tk);
causal is bottom-right aligned (query i sees keys j <= i + Tk - Tq).
Returns (out like q, lse (B, H, Tq) f32).
"""
import torch

from . import build

NEG_INF = -1e30          # the masked-logit fill of the TPU kernel
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


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


def flash_attention(q, k, v, mask=None, scale=None, causal=False):
    """Flash-attention forward; see the module docstring."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale, causal)
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
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         "q/k/v of one dtype, got %s/%s/%s"
                         % (q.dtype, k.dtype, v.dtype))
    if b * h > 65535:
        raise ValueError("flash_attention kernel: B*H=%d exceeds the grid's "
                         "65535" % (b * h))
    if tk == 0:
        raise ValueError("flash_attention needs at least one key")
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
    return out, lse
