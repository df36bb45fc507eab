"""Fused Adam / AdamW: the CUDA kernel's wrapper and its plain version.

Replaces paddle_tpu/ops/pallas/fused_adam.py:fused_adam (kernel
``_adam_kernel``), which the JAX package's ``adam`` and ``adamw`` ops
reach. The kernel is ``csrc/fused_adam.cu``; its header says what bounds
it on the H100 (the bytes: 28 per f32 element, AdamW's decay included)
and how its design meets that (one elementwise pass, the bias-corrected
learning rate computed on the device).

``coeff`` is AdamW's decoupled weight decay (0: Adam): after the Adam
step, rounded to p's dtype, ``p' = p' - (lr * coeff) * p`` from the
parameter before the step and the raw learning rate, rounded again, as
the JAX package's ``adamw`` does (paddle_tpu/ops/optimizer_ops.py:116).

``fused_adam`` runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; it never falls back from one to the other. ``launches``
counts the kernel's launches.

p is f32 or bf16 (updated through f32), g any float dtype (taken as f32),
m1/m2 f32; lr, beta1_pow and beta2_pow are one-element f32 tensors on
p's device (the optimizer's LearningRate, Beta1Pow and Beta2Pow), read by
the kernel, never by the host. Returns (p', m1', m2'). The kernel updates
p, m1 and m2 in place and returns them; the plain version returns new
tensors.
"""
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def fused_adam_plain(p, g, m1, m2, lr, beta1_pow, beta2_pow, beta1=0.9,
                     beta2=0.999, eps=1e-8, coeff=0.0):
    """The same update in plain PyTorch, f32 (the CPU path and the
    kernel's oracle)."""
    gf = g.float()
    m1n = beta1 * m1 + (1 - beta1) * gf
    m2n = beta2 * m2 + (1 - beta2) * gf * gf
    lr = lr.float().reshape(())
    lr_t = lr * torch.sqrt(1 - beta2_pow.float().reshape(())) / (
        1 - beta1_pow.float().reshape(()))
    p_new = (p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    if coeff:
        p_new = (p_new.float() - lr * coeff * p.float()).to(p.dtype)
    return p_new, m1n, m2n


def _scalar(t, device, what):
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError("fused_adam: %s must be one float32 element on %s, "
                         "got %s %s on %s" % (what, device, t.dtype,
                                              tuple(t.shape), t.device))
    return t.contiguous()


def fused_adam(p, g, m1, m2, lr, beta1_pow, beta2_pow, beta1=0.9,
               beta2=0.999, eps=1e-8, coeff=0.0):
    """One Adam (``coeff`` 0) or AdamW step of one parameter; see the
    module docstring."""
    global launches
    if p.device.type == "cpu":
        return fused_adam_plain(p, g, m1, m2, lr, beta1_pow, beta2_pow,
                                beta1, beta2, eps, coeff)
    if p.device.type != "cuda":
        raise ValueError("fused_adam runs on CUDA (kernel) or CPU (plain "
                         "version), got a %s tensor" % p.device.type)
    if p.dtype not in _DTYPES:
        raise ValueError("fused_adam kernel takes a float32 or bfloat16 "
                         "parameter, got %s" % p.dtype)
    for name, t in (("grad", g), ("moment1", m1), ("moment2", m2)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError("fused_adam: %s %s on %s does not match the "
                             "parameter %s on %s" % (name, tuple(t.shape),
                                                     t.device,
                                                     tuple(p.shape),
                                                     p.device))
    # the kernel updates in place: it needs the caller's own dense buffers
    for name, t in (("param", p), ("moment1", m1), ("moment2", m2)):
        if not t.is_contiguous():
            raise ValueError("fused_adam updates %s in place and needs it "
                             "contiguous" % name)
    if m1.dtype != torch.float32 or m2.dtype != torch.float32:
        raise ValueError("fused_adam kernel takes float32 moments, got %s/%s"
                         % (m1.dtype, m2.dtype))
    lr = _scalar(lr, p.device, "LearningRate")
    beta1_pow = _scalar(beta1_pow, p.device, "Beta1Pow")
    beta2_pow = _scalar(beta2_pow, p.device, "Beta2Pow")
    g = g.to(torch.float32).contiguous()
    n = p.numel()
    if n == 0:
        return p, m1, m2
    lib = build.load()
    with torch.cuda.device(p.device):
        rc = lib.ptt_fused_adam(
            p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            lr.data_ptr(), beta1_pow.data_ptr(), beta2_pow.data_ptr(), n,
            _DTYPES[p.dtype], float(beta1), float(beta2), float(1 - beta1),
            float(1 - beta2), float(eps), float(coeff),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "fused_adam")
    launches += 1
    return p, m1, m2
