"""Optimizer update op kernels (counterpart of
paddle_tpu/ops/optimizer_ops.py), with the same slot names and attrs.

``adam`` and ``adamw`` run the fused-Adam kernel wrapper: on a CUDA
tensor the hand-written kernel updates Param, Moment1 and Moment2 in
place, the bias-corrected learning rate computed on the card from the
LearningRate tensor (a schedule's output stays on the device), and
``adamw``'s decoupled decay ``coeff`` taken in the same pass from the
parameter before its update. ``lazy_mode`` keeps the JAX package's
routing: it never reaches the fused kernel there and takes the plain
elementwise chain here too. Beta1PowOut/Beta2PowOut are plain tensor
expressions, as in the JAX package.

The other rules are plain ``jnp`` in the JAX package and plain torch ops
here, as ``mul`` and ``matmul`` are; LAMB's and LARS's norms and selects
and DP-SGD's clip stay tensors on the device (no value is read back to
the host). Their result dtypes are JAX's: the learning rate, cast to the
parameter's dtype, enters as a tensor with as many dims as the parameter
(``_lr``), so torch promotes it with the parameter and gradient as JAX
promotes its 0-d array (a bf16 parameter with an f32 gradient gives an
f32 result in both). ``average_accumulates`` (ModelAverage's window
sums) is plain torch too, its counters and branches on the device.
"""
import torch

from . import kernel_dispatch as _kd
from .kernels import fused_adam as _adam_kernel
from .registry import register_op


def _p(ins, slot):
    return ins[slot][0]


def _lr(ins, like):
    """LearningRate in ``like``'s dtype, shaped to broadcast against
    ``like`` with JAX's promotion (see the module docstring)."""
    return _p(ins, "LearningRate").to(like.dtype).reshape((1,) * like.dim())


def _f32_scalar(ins, slot):
    return _p(ins, slot).reshape(()).float()


def _pows(ins, b1p, b2p, attrs):
    return {"Beta1PowOut": (b1p * attrs.get("beta1", 0.9)).reshape(
                ins["Beta1Pow"][0].shape),
            "Beta2PowOut": (b2p * attrs.get("beta2", 0.999)).reshape(
                ins["Beta2Pow"][0].shape)}


def _touched(g):
    """Rows of an embedding-shaped gradient that the batch reached (the
    reference's lazy mode updates those only); None below 2 dims."""
    if g.dim() < 2:
        return None
    return (g != 0).any(dim=tuple(range(1, g.dim())), keepdim=True)


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    return {"ParamOut": p - _lr(ins, p) * g}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _lr(ins, p)
    mu = attrs["mu"]
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _lr(ins, p)
    mu = attrs["mu"]
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 1e-9)
    dims = (1,) * p.dim()               # promote as JAX's 0-d norms
    pn = torch.sqrt(torch.square(p).sum()).reshape(dims)
    gn = torch.sqrt(torch.square(g).sum()).reshape(dims)
    local_lr = torch.where(pn > 0,
                           lr * coeff * pn / (gn + decay * pn + eps), lr)
    v_new = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": p - v_new, "VelocityOut": v_new}


def _adam_update(ctx, ins, attrs, coeff):
    """(ParamOut, Moment1Out, Moment2Out, Beta1Pow, Beta2Pow as f32
    scalars) of Adam, with AdamW's decoupled decay ``coeff`` (0: Adam);
    the fused kernel under the call site's launch config (keyed on the
    flattened size, as the JAX package's ``_pallas_adam``)."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m1, m2 = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p_in, b2p_in = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    b1p, b2p = b1p_in.float(), b2p_in.float()
    lr = _p(ins, "LearningRate").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    if not attrs.get("lazy_mode"):
        config = _kd.decide("adam", (p.numel(),), p.dtype, ctx).config
        return _adam_kernel.fused_adam(p, g, m1, m2, lr, b1p, b2p, b1, b2,
                                       eps, coeff, config) + (b1p, b2p)
    # reference lazy mode: rows absent from the batch (all-zero gradient
    # rows of an embedding) keep their param and moments, with no decay
    p_new, m1n, m2n = _adam_kernel.fused_adam_plain(p, g, m1, m2, lr, b1p,
                                                    b2p, b1, b2, eps, coeff)
    touched = _touched(g)
    if touched is not None:
        m1n = torch.where(touched, m1n, m1)
        m2n = torch.where(touched, m2n, m2)
        p_new = torch.where(touched, p_new, p)
    return p_new, m1n, m2n, b1p, b2p


def _adam_outs(ctx, ins, attrs, coeff):
    p_new, m1n, m2n, b1p, b2p = _adam_update(ctx, ins, attrs, coeff)
    return dict(_pows(ins, b1p, b2p, attrs), ParamOut=p_new,
                Moment1Out=m1n, Moment2Out=m2n)


_ADAM_INPLACE = ("Param", "Moment1", "Moment2")


@register_op("adam", inplace=_ADAM_INPLACE)
def _adam(ctx, ins, attrs):
    return _adam_outs(ctx, ins, attrs, 0.0)


@register_op("adamw", inplace=_ADAM_INPLACE)
def _adamw(ctx, ins, attrs):
    """Adam, then ``p' = p' - lr * coeff * p`` from the parameter before
    the step and the raw learning rate, each result rounded to the
    parameter's dtype (paddle_tpu/ops/optimizer_ops.py:116-132)."""
    return _adam_outs(ctx, ins, attrs, float(attrs.get("coeff", 0.01)))


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, m = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    return {"ParamOut": p - _lr(ins, p) * g / (torch.sqrt(m_new) + eps),
            "MomentOut": m_new}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, m = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": p - _lr(ins, p) * g / (torch.sqrt(m_new) + eps),
            "MomentOut": m_new}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    lr = _lr(ins, p)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mg = _p(ins, "MeanGrad")
        mg_new = rho * mg + (1 - rho) * g
        mom_new = momentum * mom + lr * g / torch.sqrt(
            ms_new - mg_new * mg_new + eps)
        return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
                "MomentOut": mom_new, "MeanGradOut": mg_new}
    mom_new = momentum * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
            "MomentOut": mom_new}


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m, inf = _p(ins, "Moment"), _p(ins, "InfNorm")
    b1p = _p(ins, "Beta1Pow").float().reshape((1,) * p.dim())
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = _lr(ins, p) / (1 - b1p)
    return {"ParamOut": p - lr_t * m_new / (inf_new + eps),
            "MomentOut": m_new, "InfNormOut": inf_new}


@register_op("lamb")
def _lamb(ctx, ins, attrs):
    """Layer-wise trust ratio ||p|| / ||r|| (1 where either is 0) on the
    bias-corrected Adam direction plus weight decay; both norms and the
    select are device tensors."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m1, m2 = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p, b2p = _f32_scalar(ins, "Beta1Pow"), _f32_scalar(ins, "Beta2Pow")
    lr = _f32_scalar(ins, "LearningRate")
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    gf, pf = g.float(), p.float()
    m1n = b1 * m1 + (1 - b1) * gf
    m2n = b2 * m2 + (1 - b2) * gf * gf
    r = (m1n / (1 - b1p)) / (torch.sqrt(m2n / (1 - b2p)) + eps) + wd * pf
    pn = torch.sqrt((pf * pf).sum())
    rn = torch.sqrt((r * r).sum())
    ratio = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    p_new = pf - lr * ratio * r
    return dict(_pows(ins, b1p, b2p, attrs), ParamOut=p_new.to(p.dtype),
                Moment1Out=m1n, Moment2Out=m2n)


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    sq, lin = _p(ins, "SquaredAccumulator"), _p(ins, "LinearAccumulator")
    lr = _lr(ins, p)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    sq_new = sq + g * g
    sigma = (torch.pow(sq_new, -power) - torch.pow(sq, -power)) / lr
    lin_new = lin + g - sigma * p
    quad = torch.pow(sq_new, -power) / lr + 2 * l2
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, pre / quad,
                        torch.zeros((), dtype=pre.dtype, device=pre.device))
    return {"ParamOut": p_new, "SquaredAccumOut": sq_new,
            "LinearAccumOut": lin_new}


@register_op("dpsgd", uses_rng=True)
def _dpsgd(ctx, ins, attrs):
    """The gradient clipped to an L2 norm of ``clip``, plus Gaussian noise
    of std ``sigma * clip`` from the run's keyed generator."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    gn = torch.sqrt(torch.square(g).sum())
    g = g * torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)
    noise = sigma * clip * torch.randn(g.shape, dtype=g.dtype,
                                       device=g.device,
                                       generator=ctx.generator(attrs))
    return {"ParamOut": p - _lr(ins, p) * (g + noise)}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    """Decayed squared gradients and squared updates;
    step = -sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g (no learning
    rate, as in the reference)."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    eg = _p(ins, "AvgSquaredGrad")
    ex = _p(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    eg_new = rho * eg + (1 - rho) * g * g
    update = -torch.sqrt(ex + eps) / torch.sqrt(eg_new + eps) * g
    ex_new = rho * ex + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": eg_new,
            "AvgSquaredUpdateOut": ex_new}


# average_accumulates moves sum_1 into sum_2 every K_MAX updates, to bound
# the error of summing into one buffer (reference average_accumulates_op.h)
AVERAGE_K_MAX = 16384


@register_op("average_accumulates", differentiable=False)
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's sliding-window sums of a parameter: sum_1 gathers
    the parameter each update, spills into sum_2 every AVERAGE_K_MAX
    updates, and both move into sum_3 once the window has
    max(min_average_window, min(max_average_window,
    int(num_updates * average_window))) accumulations. The int32 counters
    and every branch stay tensors (``torch.where`` on 0-d masks), so the
    op replays in a graph with no host read."""
    p = _p(ins, "param")
    s1, s2, s3 = _p(ins, "in_sum_1"), _p(ins, "in_sum_2"), _p(ins, "in_sum_3")
    num_acc = _p(ins, "in_num_accumulates") + 1
    old_acc = _p(ins, "in_old_num_accumulates")
    num_upd = _p(ins, "in_num_updates") + 1
    s1 = s1 + p.to(s1.dtype)
    spill = (num_upd % AVERAGE_K_MAX == 0).reshape(())
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)
    # the window truncates num_updates * rate to an integer, as the
    # reference does (std::min<int64_t>)
    window = torch.clamp((num_upd.float() * attrs["average_window"]).to(
        num_upd.dtype), max=attrs["max_average_window"])
    trigger = ((num_acc >= attrs["min_average_window"]) &
               (num_acc >= window)).reshape(())
    s3 = torch.where(trigger, s1 + s2, s3)
    s1 = torch.where(trigger, torch.zeros_like(s1), s1)
    s2 = torch.where(trigger, torch.zeros_like(s2), s2)
    old_acc = torch.where(trigger, num_acc, old_acc)
    num_acc = torch.where(trigger, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": num_acc,
            "out_old_num_accumulates": old_acc,
            "out_num_updates": num_upd}
