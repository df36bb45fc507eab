"""Dygraph Layer base.

Counterpart of paddle_tpu/dygraph/layers.py (reference: dygraph/layers.py
Layer). Parameters are EagerVariables over tensors on the guard's device.
``create_parameter`` draws its default values exactly as the JAX package
does (numpy's ``RandomState(len(self._parameters) + 1)``), so a fresh
layer equals the JAX package's bit for bit; an initializer given through
``attr`` runs as a startup program through the port's Executor on the
guard's place. ``loss_and_grad`` is the JAX package's
``jax.value_and_grad`` over the parameters, here
``torch.autograd.grad``. ``set_dict`` writes into each parameter's own
tensor, so a captured ``TracedLayer`` follows the loaded weights.
"""
import collections

import numpy as np
import torch

from . import base
from .base import EagerVariable, to_variable


class Layer(object):
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = name_scope or self.__class__.__name__.lower()
        self._dtype = dtype
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self.training = True

    # ---- naming / registration ------------------------------------------
    def full_name(self):
        return self._full_name

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if params is not None and isinstance(value, EagerVariable) \
                and getattr(value, "_is_param", False):
            params[name] = value
        elif subs is not None and isinstance(value, Layer):
            subs[name] = value
        object.__setattr__(self, name, value)

    def create_parameter(self, shape, dtype=None, initializer=None,
                         attr=None, is_bias=False):
        dtype = dtype or self._dtype
        init = initializer
        if attr is not None and getattr(attr, "initializer", None):
            init = attr.initializer
        key = np.random.RandomState(len(self._parameters) + 1)
        shape = tuple(int(s) for s in shape)
        if init is None:
            if is_bias:
                value = np.zeros(shape, dtype=np.float32)
            else:
                fan_in = shape[0] if shape else 1
                fan_out = shape[-1] if shape else 1
                limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
                value = key.uniform(-limit, limit, shape).astype(np.float32)
        else:
            value = _materialize_init(init, shape)
        p = EagerVariable(value)
        p._is_param = True
        return p

    def add_parameter(self, name, param):
        param._is_param = True
        self._parameters[name] = param
        object.__setattr__(self, name, param)
        return param

    def add_sublayer(self, name, layer):
        self._sub_layers[name] = layer
        object.__setattr__(self, name, layer)
        return layer

    # ---- traversal -------------------------------------------------------
    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def named_parameters(self, prefix=""):
        for n, p in self._parameters.items():
            yield (prefix + n, p)
        for ln, l in self._sub_layers.items():
            for n, p in l.named_parameters(prefix + ln + "."):
                yield (n, p)

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.sublayers())
        return out

    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False

    # ---- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   prefix=""):
        dest = destination if destination is not None else \
            collections.OrderedDict()
        for name, p in self.named_parameters(prefix):
            dest[name] = p.numpy()
        return dest

    def set_dict(self, state, include_sublayers=True):
        """Load ``state`` (name -> array or tensor): a parameter of the
        same shape is written in place (its autograd version bumped), any
        other rebound (a TracedLayer over the layer then captures its
        forward again)."""
        named = dict(self.named_parameters())
        for name, value in state.items():
            if name not in named:
                continue
            p = named[name]
            src = base._as_tensor(value)
            if p._value is not None and p._value.shape == src.shape:
                with torch.no_grad():
                    p._value.copy_(src)
            else:
                p._value = src.float() if src.is_floating_point() else src

    load_dict = set_dict

    # ---- calling / autodiff ---------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def loss_and_grad(self, loss_fn, *inputs):
        """loss_fn(outputs...) -> scalar EagerVariable. Returns (loss,
        {id(param): gradient tensor}), each parameter's ``_grad`` set to
        its gradient (zeros for a parameter the loss does not reach, as
        ``jax.value_and_grad`` gives)."""
        params = self.parameters()
        for p in params:
            p._wants_grad()
        raw = [x._value if isinstance(x, EagerVariable) else x
               for x in inputs]
        with base.force_record():
            outs = self.forward(*[EagerVariable(x, stop_gradient=True)
                                  for x in raw])
            loss = loss_fn(outs) if loss_fn is not None else outs
        value = loss._value.reshape(())
        grads = torch.autograd.grad(value, [p._value for p in params],
                                    allow_unused=True)
        grads = [torch.zeros_like(p._value) if g is None else g
                 for p, g in zip(params, grads)]
        for p, g in zip(params, grads):
            p._grad = g
        return EagerVariable(value.detach()), dict(zip(
            [id(p) for p in params], grads))

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()


def _materialize_init(init, shape):
    """Run a graph-mode Initializer as a startup program on the guard's
    place; returns the initialised tensor."""
    from ..framework.executor import Executor
    from ..framework.program import Program, program_guard
    from ..framework.scope import Scope
    prog = Program()
    with program_guard(prog, prog):
        blk = prog.global_block()
        var = blk.create_var(name="init_target", shape=shape,
                             dtype="float32", persistable=True)
        init(var, blk)
    scope = Scope()
    Executor(base.current_place()).run(prog, feed={}, fetch_list=[],
                                        scope=scope)
    return scope.find_var("init_target")


__all__ = ["Layer", "to_variable"]
