"""The op library's index ops, the port against the JAX package:
gather_nd, scatter, scatter_nd_add, index_select, take_along_axis,
argsort, arg_min, unique, unique_with_counts, multiplex, where_index
(paddle_tpu/ops/tensor_ops.py, misc_ops.py), each registry kernel
forward and gradient on the same inputs (op_library_helpers.compare).

What the JAX ops do with an index outside [0, n), each case holding the
port to it: in range, in [-n, 0), at >= n and below -n. ``gather_nd``
and ``multiplex`` index as JAX indexing does (a negative index wraps,
then it clamps, and the gradient of a clamped read is dropped);
``index_select`` and ``take_along_axis`` read as
``jnp.take`` (wrap, then fill: NaN for floats); ``scatter`` and
``scatter_nd_add`` drop an update out of range. Repeated ids under
``scatter(overwrite=True)``: the last update wins in both (XLA's CPU
scatter runs in order). ``argsort`` with ties and NaN (stable, NaN
last either way). Values and indices exact (they only move or choose
data), gradients that add repeated rows within rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest

from op_library_helpers import compare, f32, registry_flags_match

INDEX_OPS = ("gather_nd", "scatter", "scatter_nd_add", "index_select",
             "take_along_axis", "argsort", "arg_min", "unique",
             "unique_with_counts", "multiplex", "where_index")

# in range (with repeats), in [-n, 0), at >= n, below -n
IDS = {"in": [0, 3, 3, 1], "negative": [-1, -4, 2, -1],
       "past": [4, 1, 7, 0], "below": [-5, -9, 2, 1]}


@pytest.mark.parametrize("case", sorted(IDS))
def test_gather_nd(case):
    rng = np.random.RandomState(0)
    x = f32(rng, 4, 5, 3)
    i0 = np.array(IDS[case], np.int64)
    i1 = np.array([1, 4, 4, 0], np.int64)
    idx = np.stack([i0, i1], -1).reshape(2, 2, 2)
    compare("gather_nd", {"X": [x], "Index": [idx]}, {}, diff=[("X", 0)])
    compare("gather_nd", {"X": [x], "Index": [i0.reshape(4, 1)]}, {},
            diff=[("X", 0)])


@pytest.mark.parametrize("case", sorted(IDS))
@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter(case, overwrite):
    """Repeated ids are in the 'in' and 'negative' cases (3 twice; -1
    twice): under overwrite the last one wins, and only its update takes
    a gradient."""
    rng = np.random.RandomState(1)
    x, upd = f32(rng, 4, 3), f32(rng, 4, 3)
    ids = np.array(IDS[case], np.int64)
    compare("scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
            {"overwrite": overwrite}, diff=[("X", 0), ("Updates", 0)])


@pytest.mark.parametrize("case", sorted(IDS))
def test_scatter_nd_add(case):
    rng = np.random.RandomState(2)
    x = f32(rng, 4, 5, 2)
    i0 = np.array(IDS[case], np.int64)
    i1 = np.array([1, 1, -2, 9], np.int64)
    idx = np.stack([i0, i1], -1)
    upd = f32(rng, 4, 2)
    compare("scatter_nd_add", {"X": [x], "Index": [idx], "Updates": [upd]},
            {}, diff=[("X", 0), ("Updates", 0)])
    compare("scatter_nd_add", {"X": [x], "Index": [i0.reshape(4, 1)],
                               "Updates": [f32(rng, 4, 5, 2)]}, {},
            diff=[("X", 0), ("Updates", 0)])


@pytest.mark.parametrize("case", sorted(IDS))
@pytest.mark.parametrize("dim", [0, 1])
def test_index_select(case, dim):
    rng = np.random.RandomState(3)
    x = f32(rng, 4, 4, 3)
    idx = np.array(IDS[case], np.int64)
    compare("index_select", {"X": [x], "Index": [idx]}, {"dim": dim},
            diff=[("X", 0)])
    xi = rng.randint(-5, 5, (4, 4)).astype(np.int64)
    compare("index_select", {"X": [xi], "Index": [idx]}, {"dim": dim},
            exact=("Out",))


@pytest.mark.parametrize("case", sorted(IDS))
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_take_along_axis(case, axis):
    """X's ``axis`` has 4 entries, the others 3 and 2; the index runs
    along it (the same ids on every other position) and, on axis 0, is
    one entry wide on the middle axis (broadcast against X)."""
    rng = np.random.RandomState(4)
    shape = [3, 2, 2]
    shape[axis] = 4
    x = f32(rng, *shape)
    ids = np.array(IDS[case], np.int64)
    idx = np.broadcast_to(
        ids.reshape([4 if a == axis % 3 else 1 for a in range(3)]),
        shape).copy()
    compare("take_along_axis", {"Input": [x], "Index": [idx]},
            {"Axis": axis}, diff=[("Input", 0)])
    if axis == 0:
        compare("take_along_axis", {"Input": [x], "Index": [idx[:, :1]]},
                {"Axis": 0}, diff=[("Input", 0)])


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [0, -1])
def test_argsort_ties_and_nan(descending, axis):
    x = np.array([[1.0, 3.0, 1.0, np.nan, -0.0, 0.0],
                  [2.0, 2.0, np.nan, 2.0, -1.0, 5.0],
                  [0.5, np.inf, -np.inf, 0.5, 0.5, np.nan]], np.float32)
    compare("argsort", {"X": [x]}, {"axis": axis, "descending": descending},
            exact=("Out", "Indices"))
    fin = np.nan_to_num(x, nan=0.25, posinf=9.0, neginf=-9.0)
    compare("argsort", {"X": [fin]}, {"axis": axis,
                                      "descending": descending},
            diff=[("X", 0)], exact=("Indices",))


def test_argsort_int_and_smallest_int():
    """Integers with ties, and int32's smallest value, whose negation
    wraps in the JAX package (int32), so under descending it sorts
    first; the port's int64 tensor holds the JAX package's int32 and
    sorts it alike."""
    x = np.array([[3, 1, 3, -2, 0, -2 ** 31, 1]], np.int64)
    for desc in (False, True):
        compare("argsort", {"X": [x]}, {"axis": -1, "descending": desc},
                exact=("Out", "Indices"))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_arg_min(axis):
    x = np.array([[3.0, 1.0, 1.0, 2.0], [np.nan, 0.0, 5.0, 0.0],
                  [2.0, 2.0, 2.0, 2.0]], np.float32)
    compare("arg_min", {"X": [x]}, {"axis": axis}, exact=("Out",))


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 3.0, 2.0, 1.0, 7.0],
    [5.0, 5.0, 5.0, 5.0],
    [-2.0, 4.0, 0.5, -1.0],
], ids=["repeats", "one_value", "distinct"])
def test_unique(values):
    """The padded static form, against ``jnp.unique(size=len(x),
    fill_value=None)`` itself: the pad slots, the index, the counts."""
    x = np.array(values, np.float32)
    compare("unique", {"X": [x]}, {}, exact=("Out", "Index", "Count"))
    compare("unique", {"X": [x.reshape(2, -1)]}, {},
            exact=("Out", "Index", "Count"))
    compare("unique_with_counts", {"X": [x]}, {},
            exact=("Out", "Index", "Counts", "Count"))
    xi = np.array(values, np.float32).astype(np.int64)
    compare("unique_with_counts", {"X": [xi]}, {},
            exact=("Out", "Index", "Counts", "Count"))


@pytest.mark.parametrize("case", sorted(IDS))
def test_multiplex(case):
    rng = np.random.RandomState(5)
    xs = [f32(rng, 4, 3) for _ in range(4)]
    ids = np.array(IDS[case], np.int64).reshape(4, 1)
    compare("multiplex", {"X": xs, "Ids": [ids]}, {},
            diff=[("X", 0), ("X", 2), ("X", 3)])


def test_where_index():
    cond = np.random.RandomState(6).rand(3, 4, 2) > 0.6
    compare("where_index", {"Condition": [cond]}, {}, exact=("Out",))
    compare("where_index", {"Condition": [np.zeros((2, 3), bool)]}, {},
            exact=("Out",))


def test_flags_match_the_jax_package():
    registry_flags_match(INDEX_OPS)
