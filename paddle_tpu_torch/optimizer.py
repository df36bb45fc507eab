"""Optimizers — graph-building API.

Counterpart of paddle_tpu/optimizer.py:20-495 and its aliases
(:748-762): ``SGD``, ``Momentum``, ``LarsMomentum``, ``Adagrad``,
``Adadelta``, ``DGCMomentumOptimizer``, ``DecayedAdagrad``, ``Adam``,
``AdamW``, ``Lamb``, ``Adamax``, ``RMSProp``, ``Ftrl`` and ``Dpsgd``.
``minimize(loss)`` appends the backward ops (framework/backward.py), then,
in the reference's order, the regularization ops (regularizer.py), the
gradient clip (the optimizer's ``grad_clip``, else the global or
per-parameter clip of clip.py), the accumulators and one update op per
parameter to the main program, and the accumulators' initializers to the
startup program, with the same names and attrs as the JAX package: an
accumulator is ``unique_name.generate("%s_%s" % (param.name, name))``, so
weights and optimizer state carry across packages by name. The learning
rate is a float or a schedule's Variable
(layers/learning_rate_scheduler.py).
"""
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from . import clip as clip_mod


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
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
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        if self._grad_clip is not None:
            params_grads = self._grad_clip._process(params_grads)
        else:
            params_grads = clip_mod.append_gradient_clip_ops(params_grads)
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
            self._grad_clip = grad_clip
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def _update_op(block, op_type, param, grad, lr, accs, attrs):
    """Append ``op_type`` updating ``param`` from ``grad`` at rate ``lr``
    (None: the op takes no LearningRate); ``accs`` is [(input slot,
    output slot or None, var)] of the accumulators it reads and writes."""
    inputs = {"Param": [param.name], "Grad": [grad.name]}
    outputs = {"ParamOut": [param.name]}
    for in_slot, out_slot, var in accs:
        inputs[in_slot] = [var.name]
        if out_slot:
            outputs[out_slot] = [var.name]
    if lr is not None:
        inputs["LearningRate"] = [lr.name]
    block.append_op(op_type, inputs=inputs, outputs=outputs,
                    attrs=dict(attrs, op_role="optimize"))


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        _update_op(block, "sgd", param, grad, self._create_param_lr(param),
                   [], {})


class MomentumOptimizer(Optimizer):
    _op_type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super(MomentumOptimizer, self).__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _attrs(self):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        _update_op(block, self._op_type, param, grad,
                   self._create_param_lr(param),
                   [("Velocity", "VelocityOut", velocity)], self._attrs())


class LarsMomentumOptimizer(MomentumOptimizer):
    _op_type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super(LarsMomentumOptimizer, self).__init__(learning_rate, momentum,
                                                    **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay}


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super(AdagradOptimizer, self).__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        _update_op(block, "adagrad", param, grad,
                   self._create_param_lr(param),
                   [("Moment", "MomentOut", moment)],
                   {"epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta: rho-decayed averages of squared gradients and squared
    updates; ``learning_rate`` is kept for the API, the update does not
    read it (as in the reference)."""

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        _update_op(block, "adadelta", param, grad, None, [
            ("AvgSquaredGrad", "AvgSquaredGradOut",
             self._get_accumulator("avg_squared_grad", param)),
            ("AvgSquaredUpdate", "AvgSquaredUpdateOut",
             self._get_accumulator("avg_squared_update", param))],
            {"epsilon": self._epsilon, "rho": self._rho})


class DGCMomentumOptimizer(MomentumOptimizer):
    """Momentum under DGCMomentum's signature. The reference's Deep
    Gradient Compression (top-k sparsified allreduce) is not applied, as
    in the JAX package: the update is exact momentum, and the compression
    arguments are accepted and recorded only."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None, **kw):
        super(DGCMomentumOptimizer, self).__init__(
            learning_rate, momentum, use_nesterov=use_nesterov, **kw)
        self._dgc_ignored = {"rampup_begin_step": rampup_begin_step,
                             "rampup_step": rampup_step,
                             "sparsity": tuple(sparsity)}


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate, **kw)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        _update_op(block, "decayed_adagrad", param, grad,
                   self._create_param_lr(param),
                   [("Moment", "MomentOut", moment)],
                   {"decay": self._decay, "epsilon": self._epsilon})


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

    def _extra_attrs(self, param):
        return {}

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
                 "epsilon": self._epsilon, "lazy_mode": lazy}
        attrs.update(self._extra_attrs(param))
        block.append_op(
            self._update_op,
            inputs={"Param": [param.name], "Grad": [grad.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
                    "LearningRate": [lr.name]},
            outputs={"ParamOut": [param.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs=dict(attrs, op_role="optimize"))


class AdamOptimizer(_AdamLike):
    _update_op = "adam"


class AdamWOptimizer(_AdamLike):
    """Adam with decoupled weight decay: the ``adamw`` op, on the card the
    fused-Adam kernel with ``coeff = weight_decay``."""
    _update_op = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super(AdamWOptimizer, self).__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _extra_attrs(self, param):
        return {"coeff": self._coeff}


class LambOptimizer(_AdamLike):
    """LAMB: Adam's direction plus weight decay, scaled per parameter by
    the trust ratio ||p|| / ||r||; ``exclude_from_weight_decay_fn(param)``
    true gives that parameter no decay."""
    _update_op = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super(LambOptimizer, self).__init__(learning_rate, beta1, beta2,
                                            epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _extra_attrs(self, param):
        excluded = self._exclude_fn is not None and self._exclude_fn(param)
        return {"weight_decay": 0.0 if excluded else self._weight_decay}


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        b1p = self._get_accumulator("beta1_pow_acc", param)
        _update_op(block, "adamax", param, grad,
                   self._create_param_lr(param), [
                       ("Moment", "MomentOut",
                        self._get_accumulator("moment", param)),
                       ("InfNorm", "InfNormOut",
                        self._get_accumulator("inf_norm", param)),
                       ("Beta1Pow", None, b1p)],
                   {"beta1": self._beta1, "beta2": self._beta2,
                    "epsilon": self._epsilon})
        # the beta1 power advances by its own op
        block.append_op("scale", inputs={"X": [b1p.name]},
                        outputs={"Out": [b1p.name]},
                        attrs={"scale": self._beta1, "op_role": "optimize"})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        accs = [("MeanSquare", "MeanSquareOut",
                 self._get_accumulator("mean_square", param)),
                ("Moment", "MomentOut",
                 self._get_accumulator("momentum", param))]
        if self._centered:
            accs.append(("MeanGrad", "MeanGradOut",
                         self._get_accumulator("mean_grad", param)))
        _update_op(block, "rmsprop", param, grad,
                   self._create_param_lr(param), accs,
                   {"decay": self._rho, "epsilon": self._epsilon,
                    "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super(FtrlOptimizer, self).__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        _update_op(block, "ftrl", param, grad, self._create_param_lr(param),
                   [("SquaredAccumulator", "SquaredAccumOut",
                     self._get_accumulator("squared", param)),
                    ("LinearAccumulator", "LinearAccumOut",
                     self._get_accumulator("linear", param))],
                   {"l1": self._l1, "l2": self._l2,
                    "lr_power": self._lr_power})


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD: each gradient clipped to L2 norm
    ``clip``, plus Gaussian noise of std ``sigma * clip``."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super(DpsgdOptimizer, self).__init__(learning_rate, **kw)
        self._clip, self._sigma = clip, sigma

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        _update_op(block, "dpsgd", param, grad, self._create_param_lr(param),
                   [], {"clip": self._clip, "sigma": self._sigma})


# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Lamb = LambOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Dpsgd = DpsgdOptimizer

__all__ = ["Optimizer", "SGDOptimizer", "MomentumOptimizer",
           "LarsMomentumOptimizer", "AdagradOptimizer", "AdadeltaOptimizer",
           "DGCMomentumOptimizer", "DecayedAdagradOptimizer",
           "AdamOptimizer", "AdamWOptimizer", "LambOptimizer",
           "AdamaxOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
           "DpsgdOptimizer", "SGD", "Momentum", "LarsMomentum", "Adagrad",
           "Adadelta", "DecayedAdagrad", "Adam", "AdamW",
           "Lamb", "Adamax", "RMSProp", "Ftrl", "Dpsgd"]
