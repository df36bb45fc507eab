"""The op library's math and reduction ops, the port against the JAX
package: reduce_max/min/prod/all/any, logsumexp, isfinite, isnan,
isinf, maximum, minimum, dot (paddle_tpu/ops/math_ops.py:286-379), each
registry kernel forward and gradient on the same inputs
(op_library_helpers.compare). Tolerances: f32 rtol 1e-5, atol 1e-5; the
bool outputs exactly. Ties are in the data on purpose: max and min split
a tied gradient evenly in both packages (torch.amax, JAX's reduce_max
rule), maximum and minimum halve it.
"""
import numpy as np
import pytest

from op_library_helpers import compare, f32, registry_flags_match

MATH_OPS = ("reduce_max", "reduce_min", "reduce_prod", "reduce_all",
            "reduce_any", "logsumexp", "isfinite", "isnan", "isinf",
            "maximum", "minimum", "dot")


def _tied(rng, shape):
    """Values on a coarse grid, so reductions meet ties."""
    return (rng.randint(-3, 4, shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("op", ["reduce_max", "reduce_min", "reduce_prod"])
@pytest.mark.parametrize("attrs", [
    {"dim": [1], "keep_dim": False},
    {"dim": [0, 2], "keep_dim": True},
    {"dim": [-1], "keep_dim": False},
    {"dim": [0], "reduce_all": True},
], ids=["one", "two_keep", "negative", "all"])
def test_float_reductions(op, attrs):
    rng = np.random.RandomState(0)
    x = _tied(rng, (3, 4, 5)) if op != "reduce_prod" else \
        rng.uniform(0.5, 1.5, (3, 4, 5)).astype(np.float32)
    if op == "reduce_prod":
        x[0, 1, 2] = 0.0          # one zero factor: its exact gradient
    compare(op, {"X": [x]}, attrs, diff=[("X", 0)])


@pytest.mark.parametrize("op", ["reduce_all", "reduce_any"])
@pytest.mark.parametrize("attrs", [{"dim": [1]}, {"dim": [0, 1],
                                                  "keep_dim": True},
                                   {"reduce_all": True}])
def test_bool_reductions(op, attrs):
    rng = np.random.RandomState(1)
    x = rng.rand(4, 3) > 0.3
    compare(op, {"X": [x]}, attrs, exact=("Out",))
    compare(op, {"X": [np.ones((4, 3), bool)]}, attrs, exact=("Out",))


def test_reduce_max_int_exact():
    x = np.random.RandomState(2).randint(-9, 9, (4, 6)).astype(np.int64)
    compare("reduce_max", {"X": [x]}, {"dim": [1]}, exact=("Out",))
    compare("reduce_prod", {"X": [x % 3]}, {"dim": [0]}, exact=("Out",))


@pytest.mark.parametrize("attrs", [{}, {"dim": [1]},
                                   {"dim": [0, 2], "keep_dim": True}])
def test_logsumexp(attrs):
    x = f32(np.random.RandomState(3), 3, 4, 5) * 4
    compare("logsumexp", {"X": [x]}, attrs, diff=[("X", 0)])


def test_finite_checks():
    x = f32(np.random.RandomState(4), 3, 5)
    x[0, 1], x[2, 3], x[1, 0] = np.nan, np.inf, -np.inf
    for op in ("isnan", "isinf", "isfinite"):
        compare(op, {"X": [x]}, {}, exact=("Out",))
    compare("isfinite", {"X": [np.ones((2, 2), np.float32)]}, {},
            exact=("Out",))


@pytest.mark.parametrize("op", ["maximum", "minimum"])
def test_maximum_minimum(op):
    rng = np.random.RandomState(5)
    x, y = _tied(rng, (4, 6)), _tied(rng, (4, 6))
    x[0, 0] = np.nan
    compare(op, {"X": [x], "Y": [y]}, {},
            diff=[("X", 0), ("Y", 0)])


def test_dot():
    rng = np.random.RandomState(6)
    compare("dot", {"X": [f32(rng, 5, 7)], "Y": [f32(rng, 5, 7)]}, {},
            diff=[("X", 0), ("Y", 0)])


def test_flags_match_the_jax_package():
    registry_flags_match(MATH_OPS)
