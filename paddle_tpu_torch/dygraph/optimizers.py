"""Dygraph optimizers: SGD, Momentum and Adam over Layer parameter grads.

Counterpart of paddle_tpu/dygraph/optimizers.py (reference: fluid
optimizers used under dygraph.guard, minimize on a loss Variable with
tape grads). The update runs the SAME registered op as graph mode
(``ops/optimizer_ops.py``): ``adam`` is the fused-Adam kernel on a CUDA
tensor, which writes the parameter and its moments in place.

Every update lands in the parameter's own tensor on both devices: where
the op returns a new tensor (SGD, Momentum, the CPU's plain Adam) it is
copied in, and where it wrote in place (the fused-Adam kernel, through a
raw pointer) the tensor's autograd version is bumped. Either way a graph
kept by ``backward(retain_graph=True)`` that saved the old value refuses
its backward (dygraph/base.py ``InplaceUpdateError``), and a captured
``TracedLayer`` replays with the new weights.

A callable learning rate (a dygraph.learning_rate_scheduler object) is
called once for each parameter updated, as in the JAX package (its
``_inputs`` calls ``_lr_value`` per parameter), so a schedule advances
by the number of parameters in each minimize.
"""
import torch

from . import base
from ..ops.registry import get_op


class _Ctx(object):
    """The update ops read nothing of their ctx but its device."""

    def __init__(self, device):
        self.device = device


def _write(dst, src):
    """Land ``src`` in ``dst``'s storage: copy it in, or, where the op
    already wrote ``dst`` itself, bump its autograd version."""
    if src is dst:
        torch.autograd.graph.increment_version(dst)
    else:
        dst.copy_(src)


class DygraphOptimizer(object):
    _op = None

    def __init__(self, learning_rate=0.01, parameter_list=None, **attrs):
        self._lr = learning_rate
        self._params = parameter_list
        self._attrs = attrs
        self._state = {}

    def _lr_value(self, like):
        lr = self._lr
        if callable(lr):
            lr = lr()
        return torch.full((1,), float(lr), dtype=torch.float32,
                          device=like.device)

    def _slots(self, p):
        raise NotImplementedError

    def _inputs(self, p, g, slots):
        raise NotImplementedError

    def _apply_outs(self, p, slots, outs):
        raise NotImplementedError

    def minimize(self, layer_or_loss=None, startup_program=None,
                 parameter_list=None, no_grad_set=None, grads=None,
                 grad_clip=None):
        """Positional layout follows fluid's dygraph signature
        minimize(loss, startup_program, parameter_list, no_grad_set):
        minimize(loss_var) after loss.backward() with parameter_list from
        the constructor or this call; minimize(layer) after
        layer.loss_and_grad(...); or minimize(params, grads=grads_dict).
        grad_clip: a dygraph.grad_clip.GradClipBase strategy applied to all
        (param, grad) pairs before the update (ref optimizer.py minimize's
        grad_clip argument in dygraph mode)."""
        if isinstance(startup_program, dict):
            # Old dygraph signature took grads positionally here; silently
            # reading p._grad instead would skip updates without erroring.
            raise TypeError(
                "minimize() got a dict for startup_program — pass eager "
                "gradients via the grads= keyword")
        if hasattr(layer_or_loss, "parameters"):
            params = layer_or_loss.parameters()
        elif isinstance(layer_or_loss, base.EagerVariable) or \
                layer_or_loss is None:
            params = parameter_list or self._params
            if params is None:
                raise ValueError(
                    "minimize(loss) needs parameter_list — pass it to the "
                    "optimizer constructor (fluid dygraph idiom) or to "
                    "minimize()")
        else:
            params = layer_or_loss
        kernel = get_op(self._op).fn
        pairs = [(p, p._grad if grads is None else grads.get(id(p)))
                 for p in params]
        if grad_clip is not None:
            pairs = grad_clip(pairs)
        with torch.no_grad():
            for p, g in pairs:
                if g is None:
                    continue
                if not isinstance(g, torch.Tensor):
                    g = base._as_tensor(g)
                slots = self._state.get(id(p))
                if slots is None:
                    slots = self._state[id(p)] = self._slots(p)
                ins = self._inputs(p, g, slots)
                outs = kernel(_Ctx(p._value.device), ins, self._attrs)
                self._apply_outs(p, slots, outs)
                p.clear_gradient()


class SGD(DygraphOptimizer):
    _op = "sgd"

    def _slots(self, p):
        return {}

    def _inputs(self, p, g, slots):
        return {"Param": [p._value], "Grad": [g],
                "LearningRate": [self._lr_value(p._value)]}

    def _apply_outs(self, p, slots, outs):
        _write(p._value, outs["ParamOut"])


class Momentum(DygraphOptimizer):
    _op = "momentum"

    def __init__(self, learning_rate=0.01, momentum=0.9, **kw):
        super(Momentum, self).__init__(learning_rate, mu=momentum, **kw)

    def _slots(self, p):
        return {"v": torch.zeros_like(p._value)}

    def _inputs(self, p, g, slots):
        return {"Param": [p._value], "Grad": [g], "Velocity": [slots["v"]],
                "LearningRate": [self._lr_value(p._value)]}

    def _apply_outs(self, p, slots, outs):
        _write(p._value, outs["ParamOut"])
        slots["v"] = outs["VelocityOut"]


class Adam(DygraphOptimizer):
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super(Adam, self).__init__(learning_rate, beta1=beta1, beta2=beta2,
                                   epsilon=epsilon, **kw)
        self._b1, self._b2 = beta1, beta2

    def _slots(self, p):
        dev = p._value.device
        return {"m1": torch.zeros(p._value.shape, dtype=torch.float32,
                                  device=dev),
                "m2": torch.zeros(p._value.shape, dtype=torch.float32,
                                  device=dev),
                "b1p": torch.full((1,), self._b1, dtype=torch.float32,
                                  device=dev),
                "b2p": torch.full((1,), self._b2, dtype=torch.float32,
                                  device=dev)}

    def _inputs(self, p, g, slots):
        return {"Param": [p._value], "Grad": [g],
                "Moment1": [slots["m1"]], "Moment2": [slots["m2"]],
                "Beta1Pow": [slots["b1p"]], "Beta2Pow": [slots["b2p"]],
                "LearningRate": [self._lr_value(p._value)]}

    def _apply_outs(self, p, slots, outs):
        _write(p._value, outs["ParamOut"])
        slots["m1"] = outs["Moment1Out"]
        slots["m2"] = outs["Moment2Out"]
        slots["b1p"] = outs["Beta1PowOut"]
        slots["b2p"] = outs["Beta2PowOut"]


AdamOptimizer = Adam
SGDOptimizer = SGD
MomentumOptimizer = Momentum
