"""Probability distributions (counterpart of
paddle_tpu/layers/distributions.py: Uniform, Normal, Categorical,
MultivariateNormalDiag, built from layers; their samples come from the
port's random ops, so they agree with the JAX package's in distribution
only)."""
import math

from . import tensor as T
from . import ops
from .nn import elementwise_add, elementwise_sub, elementwise_mul, \
    elementwise_div, reduce_sum, softmax
from ..framework.program import Variable


def _as_var(v, like=None, dtype="float32"):
    if isinstance(v, Variable):
        return v
    return T.fill_constant([1], dtype, float(v))


class Distribution(object):
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low = _as_var(low)
        self.high = _as_var(high)

    def sample(self, shape, seed=0):
        u = ops.uniform_random(shape, min=0.0, max=1.0, seed=seed)
        return elementwise_add(
            elementwise_mul(u, elementwise_sub(self.high, self.low)),
            self.low)

    def log_prob(self, value):
        rng = elementwise_sub(self.high, self.low)
        return ops.log(elementwise_div(T.ones([1]), rng)) + (value * 0.0)

    def entropy(self):
        return ops.log(elementwise_sub(self.high, self.low))


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc = _as_var(loc)
        self.scale = _as_var(scale)

    def sample(self, shape, seed=0):
        z = ops.gaussian_random(shape, mean=0.0, std=1.0, seed=seed)
        return elementwise_add(elementwise_mul(z, self.scale), self.loc)

    def log_prob(self, value):
        var = elementwise_mul(self.scale, self.scale)
        d = elementwise_sub(value, self.loc)
        return (elementwise_div(elementwise_mul(d, d), var) * (-0.5)) \
            - math.log(math.sqrt(2.0 * math.pi)) - ops.log(self.scale)

    def entropy(self):
        return ops.log(self.scale) + 0.5 * math.log(2.0 * math.pi * math.e)

    def kl_divergence(self, other):
        var_ratio = elementwise_div(self.scale, other.scale)
        var_ratio = elementwise_mul(var_ratio, var_ratio)
        t1 = elementwise_div(elementwise_sub(self.loc, other.loc),
                             other.scale)
        t1 = elementwise_mul(t1, t1)
        return (var_ratio + t1 - 1.0 - ops.log(var_ratio)) * 0.5


class Categorical(Distribution):
    def __init__(self, logits):
        self.logits = logits

    def sample(self, shape=None, seed=0):
        probs = softmax(self.logits)
        return ops.sampling_id(probs, seed=seed)

    def log_prob(self, value):
        """log P(value) for integer class labels: one-hot select on the
        log-softmax (reference distributions.py Categorical.log_prob)."""
        from .nn import log_softmax, one_hot
        logp = log_softmax(self.logits)
        depth = int(self.logits.shape[-1])
        sel = one_hot(value, depth)
        return reduce_sum(elementwise_mul(logp, sel), dim=-1)

    def entropy(self):
        from .nn import log_softmax
        p = softmax(self.logits)
        logp = log_softmax(self.logits)
        return reduce_sum(elementwise_mul(p, logp), dim=-1) * (-1.0)


class MultivariateNormalDiag(Distribution):
    """Multivariate normal with diagonal covariance (ref
    distributions.py MultivariateNormalDiag: loc (D,), scale diag (D, D);
    entropy and kl_divergence follow the reference formulas, which read
    `scale` as the covariance matrix)."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale          # (D, D) diagonal matrix

    def _diag(self):
        from .nn import reduce_sum, elementwise_mul
        from . import tensor as TT
        import numpy as np
        d = int(self.scale.shape[-1])
        eye = TT.assign(np.eye(d, dtype=np.float32))
        return reduce_sum(elementwise_mul(self.scale, eye), dim=-1)

    def entropy(self):
        """0.5 (D (1 + log 2pi) + log|Sigma|)."""
        from .nn import reduce_sum, scale as _sc
        from .ops import log
        d = int(self.scale.shape[-1])
        logdet = reduce_sum(log(self._diag()), dim=-1)
        half = float(0.5 * d * (1.0 + math.log(2.0 * math.pi)))
        return _sc(logdet, scale=0.5, bias=half)

    def kl_divergence(self, other):
        """KL(self || other): the reference treats `scale` as the
        COVARIANCE matrix — 0.5*(tr(S2^-1 S1) + (m2-m1)^T S2^-1 (m2-m1)
        - k + ln det S2/det S1) on the diagonals."""
        from .nn import (reduce_sum, elementwise_div, elementwise_sub,
                         scale as _sc)
        from .ops import log, square
        d1 = self._diag()
        d2 = other._diag()
        k = int(self.scale.shape[-1])
        tr = reduce_sum(elementwise_div(d1, d2), dim=-1)
        quad = reduce_sum(elementwise_div(
            square(elementwise_sub(other.loc, self.loc)), d2), dim=-1)
        ln_cov = elementwise_sub(reduce_sum(log(d2), dim=-1),
                                 reduce_sum(log(d1), dim=-1))
        inner = elementwise_add(elementwise_add(tr, quad), ln_cov)
        return _sc(inner, scale=0.5, bias=-0.5 * k)

