"""Op kernels the dygraph layers run: bilinear_tensor_product and
spectral_norm (counterparts in paddle_tpu/ops/misc_ops.py; the rest of
that module waits for the op library). Plain jnp in the JAX package,
plain torch here.
"""
import torch

from .registry import register_op


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, i] = x[b] @ W[i] @ y[b] (+ bias), one einsum
    (paddle_tpu's :52)."""
    x, w, y = ins["X"][0], ins["Weight"][0], ins["Y"][0]
    out = torch.einsum("bm,imn,bn->bi", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": out}


@register_op("spectral_norm", nondiff=("U", "V"))
def _spectral_norm(ctx, ins, attrs):
    """Power iteration on W reshaped to (h, w) with ``dim`` moved first;
    Out = W / sigma (paddle_tpu's :257, ref spectral_norm_op.h). The U/V
    iterates are constants to the gradient, as in the reference."""
    w = ins["Weight"][0]
    u = ins["U"][0]                        # (h,)
    v = ins["V"][0]                        # (w,)
    dim = int(attrs.get("dim", 0))
    power_iters = int(attrs.get("power_iters", 1))
    eps = float(attrs.get("eps", 1e-12))
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    wm = w.permute(perm)
    wmat = wm.reshape(wm.shape[0], -1)

    def l2n(a):
        return a / torch.clamp(torch.linalg.vector_norm(a), min=eps)

    for _ in range(power_iters):
        v = l2n(wmat.t() @ u)
        u = l2n(wmat @ v)
    u, v = u.detach(), v.detach()
    sigma = u @ (wmat @ v)
    out = (wmat / sigma).reshape(wm.shape)
    inv = [perm.index(i) for i in range(w.dim())]
    return {"Out": out.permute(inv), "UOut": u, "VOut": v}
