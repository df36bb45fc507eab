"""The activation table: every activation op of the JAX package
(paddle_tpu/ops/math_ops.py:70-126), the port against it, value and
gradient, one case each.

Each case builds ``layers.<name>(x, **attrs)`` in both packages, runs it
with each package's ``Executor(CPUPlace())`` and differentiates
sum <out, cot> (the cotangent fed as data). Inputs are drawn from a seed
inside each op's domain (positive for log and sqrt, inside (-1, 1) for
acos and asin) and away from its kinks (the clamps' bounds, relu's 0),
where JAX's and torch's subgradients may differ; relu's gradient at 0 is
held separately, since max pooling after a relu depends on it.

Tolerance: one f32 elementwise formula each, libm's functions against
XLA's: rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

from paddle_tpu.ops import math_ops as jmath
from paddle_tpu_torch.ops import math_ops as tmath
from test_torch_ops import _cots, _grad_data, _with_grads
from test_torch_resnet import run_pair

SHAPE = (4, 6)

# inputs inside the domain: name -> (low, high); default (-3, 3)
_DOMAIN = {"log": (0.1, 4.0), "sqrt": (0.1, 4.0), "rsqrt": (0.1, 4.0),
           "reciprocal": (0.5, 3.0), "acos": (-0.9, 0.9),
           "asin": (-0.9, 0.9), "log1p": (-0.5, 3.0)}
# attrs other than the defaults, to show they reach the op
_ATTRS = {"leaky_relu": {"alpha": 0.1}, "elu": {"alpha": 0.5},
          "relu6": {"threshold": 2.0}, "swish": {"beta": 1.5},
          "brelu": {"t_min": -1.0, "t_max": 2.0},
          "stanh": {"scale_a": 0.5, "scale_b": 2.0},
          "hard_shrink": {"threshold": 0.7}}
# kinks to keep the inputs away from (a subgradient there may differ)
_KINKS = {"relu": [0.0], "relu6": [0.0, 2.0], "leaky_relu": [0.0],
          "elu": [0.0], "selu": [0.0], "hard_sigmoid": [-2.5, 2.5],
          "hard_swish": [-3.0, 3.0], "hard_shrink": [-0.7, 0.7],
          "softshrink": [-0.5, 0.5], "thresholded_relu": [1.0],
          "brelu": [-1.0, 2.0], "abs": [0.0], "sign": [0.0],
          "round": [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
          "ceil": [-2.0, -1.0, 0.0, 1.0, 2.0],
          "floor": [-2.0, -1.0, 0.0, 1.0, 2.0]}


def _input(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    low, high = _DOMAIN.get(name, (-3.0, 3.0))
    x = rng.uniform(low, high, SHAPE).astype(np.float32)
    for k in _KINKS.get(name, ()):
        near = np.abs(x - k) < 0.05
        x[near] = k + np.where(x[near] >= k, 0.05, -0.05)
    return x


def test_the_port_has_the_whole_table():
    assert set(tmath._ACTIVATIONS) >= set(jmath._ACTIVATIONS)


@pytest.mark.parametrize("name", sorted(jmath._ACTIVATIONS))
def test_activation(name):
    attrs = _ATTRS.get(name, {})

    def build(p):
        x = _grad_data(p, "x", SHAPE)
        return _with_grads(p, [getattr(p.layers, name)(x, **attrs)], [x])
    run_pair(build, [dict({"x": _input(name)}, **_cots(int(np.prod(SHAPE))))],
             tol=dict(rtol=1e-5, atol=1e-6))


def test_relu_gradient_at_zero_is_zero():
    """jax.nn.relu's gradient at exactly 0 is 0; so is the port's."""
    x = np.array([[-1.0, 0.0, 0.0, 2.0]], np.float32)

    def build(p):
        xv = _grad_data(p, "x", x.shape)
        return _with_grads(p, [p.layers.relu(xv)], [xv])
    out, _, _ = run_pair(build, [dict({"x": x}, **{
        "cot0": np.ones((4, 1), np.float32)})], exact=True)
    np.testing.assert_array_equal(out[1], [[0.0, 0.0, 0.0, 1.0]])
