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

The wrappers of :497-745: ``ExponentialMovingAverage``,
``LookaheadOptimizer``, ``ModelAverage`` (its ``average_accumulates``
op) and ``RecomputeOptimizer``; their in-graph ops replay in a captured
step like the update ops.
"""
import contextlib

import torch

from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import Variable, default_main_program
from .framework.scope import global_scope
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


class ExponentialMovingAverage(object):
    """EMA of the trainable parameters (paddle_tpu/optimizer.py:497-563):
    ``update()`` appends, for each trainable parameter of the default main
    program, a persistable ``<param>.ema_N`` (0 at startup) and the ops
    ema = decay * ema + (1 - decay) * param (``scale``, ``scale``,
    ``sum``; role ``optimize``); ``apply()`` puts the averages in the
    parameters' place until ``restore()``.

    The JAX package swaps array identities in the scope
    (``scope.set_var(param, ema)``, later ``set_var(param, backup)``),
    which its immutable arrays make safe. Here the scope's tensors are
    the captured steps' static inputs, updated in place, so ``apply`` and
    ``restore`` move values, never tensors: ``apply`` clones each
    parameter as its backup and copies the average into the parameter's
    own tensor; ``restore`` copies the backup back. No tensor is ever
    bound under a second name, so a step captured or replayed under
    ``apply`` reads the averages through the parameters' own static
    inputs and writes neither the accumulators nor the backups. The
    values are the reference's."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._ema_vars = {}
        self._backup = {}

    def update(self):
        program = default_main_program()
        block = program.global_block()
        helper = LayerHelper(self._name)
        for param in program.all_parameters():
            if not getattr(param, "trainable", True):
                continue
            ema = helper.create_global_variable(
                name=unique_name.generate(param.name + ".ema"),
                dtype=param.dtype, shape=param.shape, persistable=True)
            helper.set_variable_initializer(ema, ConstantInitializer(0.0))
            self._ema_vars[param.name] = ema
            decayed = _scaled(helper, block, ema, self._decay)
            fresh = _scaled(helper, block, param, 1.0 - self._decay)
            block.append_op("sum", inputs={"X": [decayed.name, fresh.name]},
                            outputs={"Out": [ema.name]},
                            attrs={"op_role": "optimize"})

    def apply(self, executor=None, need_restore=True):
        """Copy each parameter's average into it (a context manager that
        restores on exit when ``need_restore``)."""
        _swap_in(self, {pname: [ema.name]
                        for pname, ema in self._ema_vars.items()},
                 lambda values, param: values[0])
        return _restoring(self, executor, need_restore)

    def restore(self, executor=None):
        _restore(self)


def _swap_in(wrapper, sources, average):
    """For each {param name: [state names]} of ``sources`` whose values are
    all in the global scope: a clone of the parameter into
    ``wrapper._backup``, then ``average([state tensors], param)`` copied
    into the parameter's own tensor."""
    scope = global_scope()
    wrapper._backup = {}
    for pname, names in sources.items():
        param = scope.find_var(pname)
        values = [scope.find_var(n) for n in names]
        if param is None or any(v is None for v in values):
            continue
        wrapper._backup[pname] = param.clone()
        with torch.no_grad():
            param.copy_(average(values, param))


def _scaled(helper, block, var, factor):
    out = helper.create_variable_for_type_inference(var.dtype, var.shape)
    block.append_op("scale", inputs={"X": [var.name]},
                    outputs={"Out": [out.name]},
                    attrs={"scale": factor, "op_role": "optimize"})
    return out


@contextlib.contextmanager
def _restoring(wrapper, executor, need_restore):
    try:
        yield
    finally:
        if need_restore:
            wrapper.restore(executor)


def _restore(wrapper):
    """Copy each backed-up parameter value back into the scope's tensor
    of that name (whichever tensor the scope holds now)."""
    scope = global_scope()
    for pname, val in wrapper._backup.items():
        with torch.no_grad():
            scope.find_var(pname).copy_(val)
    wrapper._backup = {}


class LookaheadOptimizer(object):
    """Lookahead (paddle_tpu/optimizer.py:566-619): the inner optimizer
    takes the fast steps; every ``k`` runs (a step counter
    ``@LOOKAHEAD_STEP@`` from 1) each parameter and its persistable slow
    copy ``<param>.slow_N`` become alpha * param + (1 - alpha) * slow. The
    k-step choice is a ``where`` on the device."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from . import layers as L
        ops, pgs = self.inner_optimizer.minimize(loss, startup_program)
        block = default_main_program().global_block()
        helper = LayerHelper("lookahead")
        step = L.autoincreased_step_counter(counter_name="@LOOKAHEAD_STEP@",
                                            begin=1)
        stepf = L.cast(step, "float32")
        k = L.fill_constant([1], "float32", float(self.k))
        rem = L.elementwise_sub(
            stepf, L.elementwise_mul(L.floor(L.elementwise_div(stepf, k)), k))
        is_sync = L.equal(rem, 0.0)
        for param, _ in pgs:
            slow = helper.create_global_variable(
                name=unique_name.generate(param.name + ".slow"),
                dtype=param.dtype, shape=param.shape, persistable=True)
            helper.set_variable_initializer(slow, ConstantInitializer(0.0))
            mixed = helper.create_variable_for_type_inference(param.dtype,
                                                              param.shape)
            block.append_op(
                "sum", inputs={"X": [
                    _scaled(helper, block, param, self.alpha).name,
                    _scaled(helper, block, slow, 1.0 - self.alpha).name]},
                outputs={"Out": [mixed.name]}, attrs={"op_role": "optimize"})
            new_p = L.where(is_sync, mixed, param)
            new_slow = L.where(is_sync, mixed, slow)
            for src, dst in ((new_p, param), (new_slow, slow)):
                block.append_op("assign", inputs={"X": [src.name]},
                                outputs={"Out": [dst.name]},
                                attrs={"op_role": "optimize"})
        return ops, pgs


class ModelAverage(object):
    """Sliding-window parameter averaging (paddle_tpu/optimizer.py:622-721):
    made after ``minimize``, it appends one ``average_accumulates`` op per
    trainable parameter of the default main program, with its persistable
    sums (``sum_1``-``sum_3``, the parameter's dtype) and int32 counters
    (``num_accumulates``, ``old_num_accumulates``, ``num_updates``), all 0
    at startup. ``apply()`` puts (sum_1 + sum_2 + sum_3) / max(1,
    num_accumulates + old_num_accumulates) in each parameter's place until
    ``restore()``, moving values as ExponentialMovingAverage does."""

    _SUMS = ("sum_1", "sum_2", "sum_3")
    _COUNTS = ("num_accumulates", "old_num_accumulates", "num_updates")

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._name = name or "model_average"
        self._accs = {}
        self._backup = {}
        program = default_main_program()
        block = program.global_block()
        helper = LayerHelper(self._name)
        for param in program.all_parameters():
            if not getattr(param, "trainable", True):
                continue
            accs = {}
            for slot in self._SUMS + self._COUNTS:
                counter = slot in self._COUNTS
                v = helper.create_global_variable(
                    name=unique_name.generate(param.name + "." + slot),
                    dtype="int32" if counter else param.dtype,
                    shape=[1] if counter else param.shape, persistable=True)
                helper.set_variable_initializer(
                    v, ConstantInitializer(0 if counter else 0.0))
                accs[slot] = v
            self._accs[param.name] = accs
            inputs = {"param": [param.name]}
            outputs = {}
            for slot, v in accs.items():
                inputs["in_" + slot] = [v.name]
                outputs["out_" + slot] = [v.name]
            block.append_op(
                "average_accumulates", inputs=inputs, outputs=outputs,
                attrs={"average_window": self._rate,
                       "min_average_window": self._min_w,
                       "max_average_window": self._max_w,
                       "op_role": "optimize"})

    def apply(self, executor=None, need_restore=True):
        """Copy each parameter's window average into it (a context
        manager that restores on exit when ``need_restore``)."""
        _swap_in(self, {pname: [accs[s].name
                                for s in self._SUMS + self._COUNTS[:2]]
                        for pname, accs in self._accs.items()},
                 _window_average)
        return _restoring(self, executor, need_restore)

    def restore(self, executor=None):
        _restore(self)


def _window_average(values, param):
    s1, s2, s3, na, no = values
    total = torch.clamp((na + no).float(), min=1.0)
    return ((s1.float() + s2 + s3) / total.reshape(())).to(param.dtype)


class RecomputeOptimizer(object):
    """paddle_tpu/optimizer.py:724-745: records the checkpoint vars set by
    ``_set_checkpoints`` as ``program._recompute_checkpoints`` and
    delegates ``minimize`` to the inner optimizer. The port's Executor
    does nothing with the record, as the JAX package's does nothing with
    it: recompute in the port is ``layers.recompute_segment`` (a
    ``remat_block`` op per segment; ``recompute=True`` of the BERT and
    GPT configs)."""

    def __init__(self, optimizer):
        self.inner_optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.block.program._recompute_checkpoints = [
            v.name if hasattr(v, "name") else v
            for v in (self._checkpoints or [])]
        return self.inner_optimizer.minimize(loss, startup_program,
                                             parameter_list, no_grad_set)


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
           "Lamb", "Adamax", "RMSProp", "Ftrl", "Dpsgd",
           "ExponentialMovingAverage", "LookaheadOptimizer", "ModelAverage",
           "RecomputeOptimizer"]
