"""LayerNorm forward: the CUDA kernel's wrapper and its plain version.

Replaces paddle_tpu/ops/pallas/layer_norm.py:_ln_call_fwd (kernel
``_ln_fwd_kernel``). The kernel is ``csrc/layer_norm_fwd.cu``; its header
says what bounds it on the H100 (the bytes: a few flops per element) and
how its design meets that (one block per row, the row read once into
shared memory, two reductions there, one write).

``layer_norm`` runs the kernel for a CUDA tensor and the plain version for
a CPU tensor; it never falls back from one to the other. ``launches``
counts the kernel's launches.

x is (rows, cols) f32 or bf16, normalised over cols; scale and bias are
optional (cols,). Returns (y like x, mean (rows,) f32, rstd (rows,) f32).
"""
import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
