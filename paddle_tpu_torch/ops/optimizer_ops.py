"""Optimizer update op kernels (counterpart of
paddle_tpu/ops/optimizer_ops.py), with the same slot names.

``adam`` runs the fused-Adam kernel wrapper: on a CUDA tensor the
hand-written kernel updates Param, Moment1 and Moment2 in place, with the
bias-corrected learning rate computed on the card. ``lazy_mode`` keeps
the JAX package's routing: it never reaches the fused kernel there and
takes the plain elementwise chain here too. Beta1PowOut/Beta2PowOut are
plain tensor expressions, as in the JAX package.
"""
import torch

from .kernels import fused_adam as _adam_kernel
from .registry import register_op


def _p(ins, slot):
    return ins[slot][0]


@register_op("adam")
def _adam(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m1, m2 = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_in, b2p_in = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p, b2p = b1p_in.float(), b2p_in.float()
    lr = _p(ins, "LearningRate").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    pows = {"Beta1PowOut": (b1p * b1).reshape(b1p_in.shape),
            "Beta2PowOut": (b2p * b2).reshape(b2p_in.shape)}
    if not attrs.get("lazy_mode"):
        p_new, m1n, m2n = _adam_kernel.fused_adam(p, g, m1, m2, lr, b1p, b2p,
                                                  b1, b2, eps)
        return dict(pows, ParamOut=p_new, Moment1Out=m1n, Moment2Out=m2n)
    p_new, m1n, m2n = _adam_kernel.fused_adam_plain(p, g, m1, m2, lr, b1p,
                                                    b2p, b1, b2, eps)
    if g.dim() >= 2:
        # reference lazy-mode adam: rows absent from the batch (all-zero
        # grad rows of an embedding) keep their param and moments
        touched = (g != 0).any(dim=tuple(range(1, g.dim())), keepdim=True)
        m1n = torch.where(touched, m1n, m1)
        m2n = torch.where(touched, m2n, m2)
        p_new = torch.where(touched, p_new, p)
    return dict(pows, ParamOut=p_new, Moment1Out=m1n, Moment2Out=m2n)
