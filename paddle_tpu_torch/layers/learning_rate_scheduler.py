"""Learning-rate schedules, computed by ops inside the step.

Counterpart of paddle_tpu/layers/learning_rate_scheduler.py: noam,
exponential, natural_exp, inverse_time, polynomial, piecewise, cosine and
linear_lr_warmup. Each reads the persistable ``@LR_DECAY_COUNTER@``
(``autoincreased_step_counter``, incremented by an op of the step) and
computes its rate with ops, so the rate stays on the device: the Adam
kernel reads it from device memory, and no run waits on the host for it.
The ops, attrs and var names are the JAX package's, so a program
serializes alike (the ``(1.0 - frac) ** power`` that
``polynomial_decay`` builds and leaves unread included).
"""
import math

from ..framework.program import Variable
from . import ops
from . import tensor
from .control_flow import less_than, piecewise_select
from .nn import (autoincreased_step_counter, elementwise_div,
                 elementwise_max, elementwise_min, scale, where)


def _decay_step_counter(begin=0):
    counter = autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return tensor.cast(counter, "float32")


def elementwise_min_var(a, b):
    return elementwise_min(a, b)


def scale_lr(lr, factor):
    if factor == 1.0:
        return lr
    return scale(lr, scale=float(factor))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _decay_step_counter(begin=1)
    a = ops.pow(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    lr = (d_model ** -0.5) * elementwise_min_var(a, b)
    return scale_lr(lr, learning_rate)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return scale_lr(ops.exp(div * math.log(decay_rate)), learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return scale_lr(ops.exp(div * (-decay_rate)), learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = div * decay_rate + 1.0
    one = tensor.fill_constant([1], "float32", 1.0)
    return scale_lr(elementwise_div(one, denom), learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        div = ops.ceil(step / float(decay_steps))
        one = tensor.fill_constant([1], "float32", 1.0)
        div = elementwise_max(div, one)
        decay_steps_var = div * float(decay_steps)
        frac = step / decay_steps_var
    else:
        cap = tensor.fill_constant([1], "float32", float(decay_steps))
        step = elementwise_min(step, cap)
        frac = step / float(decay_steps)
    if power == 1.0:
        (1.0 - frac) ** power      # unread: kept so programs serialize alike
    one = tensor.fill_constant([1], "float32", 1.0)
    pw = ops.pow(one - frac, factor=power)
    return pw * (learning_rate - end_learning_rate) + end_learning_rate


def piecewise_decay(boundaries, values):
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries)+1")
    step = autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@",
                                      begin=0, step=1)
    return piecewise_select(tensor.cast(step, "float32"),
                            [float(b) for b in boundaries],
                            [float(v) for v in values])


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = ops.floor(step / float(step_each_epoch))
    return learning_rate * 0.5 * (ops.cos(epoch * (math.pi / epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """``start_lr`` rising linearly to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a float or a schedule's Variable)."""
    step = _decay_step_counter()
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    warm = float(start_lr) + (float(end_lr) - float(start_lr)) * \
        (step / float(warmup_steps))
    return where(less_than(step, float(warmup_steps)), warm, learning_rate)


__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup", "elementwise_min_var",
           "scale_lr"]
