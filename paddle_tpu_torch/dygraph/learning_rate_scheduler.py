"""Dygraph LR schedules (counterpart of
paddle_tpu/dygraph/learning_rate_scheduler.py; ref
python/paddle/fluid/dygraph/learning_rate_scheduler.py).

Callable decay objects: each call returns the current LR and advances
the step counter. Pass one as the ``learning_rate`` of a
paddle_tpu_torch.dygraph.optimizers optimizer (it is called once per
parameter updated, as in the JAX package). Pure Python: the formulas
mirror the static-graph layers/learning_rate_scheduler.py family.
"""
import math

__all__ = ['PiecewiseDecay', 'NaturalExpDecay', 'ExponentialDecay',
           'InverseTimeDecay', 'PolynomialDecay', 'CosineDecay',
           'NoamDecay', 'LinearLrWarmup']


class LearningRateDecay(object):
    """Base (ref :27): __call__ -> current lr, then advance."""

    def __init__(self, begin=0, step=1, dtype='float32'):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return float(lr)

    def step(self):
        raise NotImplementedError()


class PiecewiseDecay(LearningRateDecay):
    """boundaries/values staircase (ref :70)."""

    def __init__(self, boundaries, values, begin, step=1, dtype='float32'):
        super(PiecewiseDecay, self).__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    """lr * e^(-rate * floor_or_frac(step/decay_steps)) (ref :129)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype='float32'):
        super(NaturalExpDecay, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / float(self.decay_steps)
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class ExponentialDecay(LearningRateDecay):
    """lr * rate^(step/decay_steps) (ref :208)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype='float32'):
        super(ExponentialDecay, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / float(self.decay_steps)
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * self.decay_rate ** div


class InverseTimeDecay(LearningRateDecay):
    """lr / (1 + rate * step/decay_steps) (ref :288)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype='float32'):
        super(InverseTimeDecay, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / float(self.decay_steps)
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    """Polynomial ramp to end_learning_rate (ref :364)."""

    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1, dtype='float32'):
        super(PolynomialDecay, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        n = self.step_num
        d = self.decay_steps
        if self.cycle:
            mult = max(1.0, math.ceil(n / float(d))) if n else 1.0
            d = d * mult
        else:
            n = min(n, d)
        frac = (1.0 - n / float(d)) ** self.power
        return (self.learning_rate - self.end_learning_rate) * frac + \
            self.end_learning_rate


class CosineDecay(LearningRateDecay):
    """Half-cosine over epochs (ref :456)."""

    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype='float32'):
        super(CosineDecay, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        cur_epoch = math.floor(self.step_num / float(self.step_each_epoch))
        return self.learning_rate * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    """d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (ref :512)."""

    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype='float32'):
        super(NoamDecay, self).__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        a = n ** -0.5
        b = n * self.warmup_steps ** -1.5
        return self.d_model ** -0.5 * min(a, b)


class LinearLrWarmup(LearningRateDecay):
    """Linear warmup wrapping a base lr or another decay (ref :566)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 begin=1, step=1, dtype='float32'):
        super(LinearLrWarmup, self).__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr

    def step(self):
        base = self.learning_rate
        # a wrapped decay advances EVERY step — including warmup — so the
        # post-warmup schedule resumes at the right step_num (reference
        # calls base_lr() unconditionally each iteration)
        inner = base() if isinstance(base, LearningRateDecay) else base
        if self.step_num < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                (self.step_num / float(self.warmup_steps))
        return inner
