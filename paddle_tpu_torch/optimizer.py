"""Optimizers — graph-building API.

Counterpart of paddle_tpu/optimizer.py:20-128 and 293-345 (``Optimizer``,
``_AdamLike``, ``AdamOptimizer`` and the ``Adam`` alias).
``minimize(loss)`` appends the backward ops (framework/backward.py) and
one update op per parameter to the main program, and the accumulators'
initializers to the startup program, with the same names and attrs as
the JAX package: an accumulator is
``unique_name.generate("%s_%s" % (param.name, name))``, so weights and
optimizer state carry across packages by name.

Regularization and gradient clipping belong to a later slice: a
``regularization``, ``grad_clip``, per-parameter regularizer or clip
attribute raises NotPortedError.
"""
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .ops.registry import NotPortedError

_LATER = ("arrives with a later slice of paddle_tpu_torch (the BERT "
          "training slice ports Adam without it)")


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        if regularization is not None:
            raise NotPortedError("optimizer regularization " + _LATER)
        if grad_clip is not None:
            raise NotPortedError("optimizer grad_clip " + _LATER)
        self._learning_rate = learning_rate
        self._accumulators = {}       # (name, param name) -> var
        self._learning_rate_map = {}  # id(program) -> lr var

    # ---- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        if id(program) in self._learning_rate_map:
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            name=unique_name.generate("learning_rate"), dtype="float32",
            shape=(1,), persistable=True)
        helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[id(program)] = lr

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(id(program))

    def _create_param_lr(self, param):
        lr = self._global_learning_rate()
        param_lr = getattr(param, "optimize_attr",
                           {"learning_rate": 1.0}).get("learning_rate", 1.0)
        if param_lr == 1.0:
            return lr
        from .layers import scale as scale_layer
        return scale_layer(lr, scale=float(param_lr))

    # ---- accumulators -----------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(name)
        shape = list(shape if shape is not None else param.shape)
        var = helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            dtype=dtype or "float32", shape=tuple(shape), persistable=True)
        # moments follow the param's sharding metadata, as in the JAX
        # package, so the two programs serialize the same
        var.sharding = param.sharding if shape == list(param.shape) else None
        helper.set_variable_initializer(var,
                                        ConstantInitializer(fill_value))
        self._accumulators[key] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    # ---- hooks ------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # ---- main entry points ------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        for p, g in params_grads:
            if getattr(p, "regularizer", None) is not None:
                raise NotPortedError("parameter regularizer " + _LATER)
            if getattr(p, "gradient_clip_attr", None) is not None:
                raise NotPortedError("parameter gradient clip " + _LATER)
        block = default_main_program().global_block()
        self._create_global_learning_rate()
        self._create_accumulators(block,
                                  [p for p, g in params_grads
                                   if getattr(p, "trainable", True)])
        for param_and_grad in params_grads:
            if param_and_grad[1] is None:
                continue
            self._append_optimize_op(block, param_and_grad)
        return []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if grad_clip is not None:
            raise NotPortedError("minimize(grad_clip=...) " + _LATER)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class _AdamLike(Optimizer):
    _update_op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super(_AdamLike, self).__init__(learning_rate, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        lr = self._create_param_lr(param)
        # reference lazy mode applies only to embedding tables
        lazy = self._lazy_mode and any(
            op.type in ("lookup_table", "lookup_table_v2") and
            param.name in op.input("W") for op in block.ops)
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon, "op_role": "optimize",
                 "lazy_mode": lazy}
        block.append_op(
            self._update_op,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs=attrs)


class AdamOptimizer(_AdamLike):
    _update_op = "adam"


Adam = AdamOptimizer

__all__ = ["Optimizer", "AdamOptimizer", "Adam"]
