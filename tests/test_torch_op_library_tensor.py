"""The op library's tensor and random ops, the port against the JAX
package: shape, flatten2, flatten_contiguous_range, unstack,
strided_slice, expand_as, tile, roll, tril_triu, eye, diag, meshgrid,
coalesce_tensor, range, linspace, load_tensor (paddle_tpu/ops/
tensor_ops.py), each registry kernel forward and gradient on the same
inputs (op_library_helpers.compare; a float ``range`` or ``linspace``
is arithmetic, within rtol 1e-5: XLA's rounding of start * (1 - t) +
stop * t is not a plain f32 product and sum); and randint, randperm, bernoulli,
sampling_id (random_ops.py), whose draws cannot agree value for value
(Philox against threefry): they are held by their statistics, and a
seed repeats a draw. What only moves data is held exactly; gradients
within rtol 1e-5, atol 1e-5. ``range``, ``linspace``, ``load_tensor``
and ``where_index`` read the host (``syncs_host``): the Executor runs a
program holding one op by op on the card, which the last test checks
through ``_host_sync``.
"""
import numpy as np
import pytest
import torch

from op_library_helpers import (TorchCtx, compare, f32,
                                registry_flags_match)
from paddle_tpu_torch.ops.registry import get_op as tget

TENSOR_OPS = ("shape", "flatten2", "flatten_contiguous_range", "unstack",
              "strided_slice", "expand_as", "tile", "roll", "tril_triu",
              "eye", "diag", "meshgrid", "coalesce_tensor", "range",
              "linspace", "load_tensor")
RANDOM_OPS = ("randint", "randperm", "bernoulli", "sampling_id")
EXACT = ("Out", "Y", "Output", "FusedOutput")


def _x(*shape):
    return f32(np.random.RandomState(sum(shape)), *shape)


def test_shape():
    compare("shape", {"Input": [_x(2, 3, 4)]}, {}, exact=("Out",))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_flatten2(axis):
    compare("flatten2", {"X": [_x(2, 3, 4)]}, {"axis": axis},
            diff=[("X", 0)], exact=EXACT)


@pytest.mark.parametrize("start,stop", [(1, -1), (0, 1), (1, 2), (2, 2)])
def test_flatten_contiguous_range(start, stop):
    compare("flatten_contiguous_range", {"X": [_x(2, 3, 4, 5)]},
            {"start_axis": start, "stop_axis": stop}, diff=[("X", 0)],
            exact=EXACT)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_unstack(axis):
    compare("unstack", {"X": [_x(3, 2, 4)]}, {"axis": axis},
            diff=[("X", 0)], exact=EXACT, grad_outs=["Y"])


@pytest.mark.parametrize("axes,starts,ends,strides", [
    ([1], [0], [6], [2]),
    ([0, 1], [1, -1], [3, 0], [1, -2]),
    ([1], [5], [-7], [-1]),
    ([2], [3], [1], [1]),                    # empty
    ([0, 2], [-1, 0], [-4, 3], [-1, 3]),
])
def test_strided_slice(axes, starts, ends, strides):
    compare("strided_slice", {"Input": [_x(3, 6, 4)]},
            {"axes": axes, "starts": starts, "ends": ends,
             "strides": strides}, diff=[("Input", 0)], exact=EXACT)


def test_expand_as():
    compare("expand_as", {"X": [_x(2, 1, 3)],
                          "target_tensor": [_x(4, 5, 3)]}, {},
            diff=[("X", 0)], exact=EXACT)


@pytest.mark.parametrize("times", [[2, 1, 3], [3], [2, 2, 1, 2]])
def test_tile(times):
    compare("tile", {"X": [_x(2, 3, 1)]}, {"repeat_times": times},
            diff=[("X", 0)], exact=EXACT)


@pytest.mark.parametrize("shifts,axis", [([1], [0]), ([-2, 5], [1, 2])])
def test_roll(shifts, axis):
    compare("roll", {"X": [_x(3, 4, 5)]}, {"shifts": shifts, "axis": axis},
            diff=[("X", 0)], exact=EXACT)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("diagonal", [0, 1, -2])
def test_tril_triu(lower, diagonal):
    compare("tril_triu", {"X": [_x(2, 4, 5)]},
            {"lower": lower, "diagonal": diagonal}, diff=[("X", 0)],
            exact=EXACT)


@pytest.mark.parametrize("attrs", [{"num_rows": 3},
                                   {"num_rows": 2, "num_columns": 5,
                                    "dtype": "int64"}])
def test_eye(attrs):
    compare("eye", {}, attrs, exact=EXACT)


@pytest.mark.parametrize("shape", [(4,), (3, 3)])
def test_diag(shape):
    compare("diag", {"Diagonal": [_x(*shape)]}, {}, diff=[("Diagonal", 0)],
            exact=EXACT)


def test_meshgrid():
    compare("meshgrid", {"X": [_x(3), _x(4), _x(2)]}, {},
            diff=[("X", 0), ("X", 1), ("X", 2)], exact=EXACT,
            grad_outs=["Out"])


def test_coalesce_tensor():
    compare("coalesce_tensor", {"Input": [_x(2, 3), _x(4)]}, {},
            diff=[("Input", 0), ("Input", 1)], exact=EXACT,
            grad_outs=["FusedOutput"])


@pytest.mark.parametrize("start,end,step,dtype", [
    (0.0, 5.0, 1.0, np.float32), (1.5, -2.0, -0.7, np.float32),
    (2, 11, 3, np.int64), (3.0, 3.0, 1.0, np.float32)])
def test_range(start, end, step, dtype):
    ins = {"Start": [np.array([start], dtype)], "End": [np.array([end],
                                                                 dtype)],
           "Step": [np.array([step], dtype)]}
    compare("range", ins, {}, exact=("Out",) if dtype == np.int64 else ())


@pytest.mark.parametrize("start,stop,num,dtype", [
    (0.0, 1.0, 5, np.float32), (-3.0, 7.5, 11, np.float32),
    (2.0, 9.0, 1, np.float32), (0, 10, 4, np.int64)])
def test_linspace(start, stop, num, dtype):
    ins = {"Start": [np.array([start], dtype)],
           "Stop": [np.array([stop], dtype)],
           "Num": [np.array([num], np.int32)]}
    compare("linspace", ins, {}, exact=("Out",) if dtype == np.int64 else ())


@pytest.mark.parametrize("fp16", [False, True])
def test_load_tensor(tmp_path, fp16):
    path = str(tmp_path / "t.npy")
    np.save(path, _x(3, 4))
    compare("load_tensor", {}, {"file_path": path, "load_as_fp16": fp16},
            exact=("Out",))


def _run(op, ins, attrs, seed):
    tins = {k: [torch.from_numpy(np.asarray(v)) for v in vs]
            for k, vs in ins.items()}
    return tget(op).fn(TorchCtx(seed), tins, attrs)["Out"]


def test_randint_statistics():
    attrs = {"shape": [1 << 16], "low": -3, "high": 7, "dtype": "int64"}
    out = _run("randint", {}, attrs, 1)
    assert out.dtype == torch.int64
    counts = np.bincount(out.numpy() + 3, minlength=10)
    n, p = 1 << 16, 0.1
    assert counts.size == 10 and out.min() >= -3 and out.max() < 7
    assert np.all(np.abs(counts - n * p) <= 5 * np.sqrt(n * p * (1 - p)))
    assert torch.equal(out, _run("randint", {}, attrs, 1))
    assert not torch.equal(out, _run("randint", {}, attrs, 2))


def test_randperm_statistics():
    """A permutation every draw; each position's value uniform over 2^12
    draws of n = 8 (chi-square of the first position's value)."""
    attrs = {"n": 8, "dtype": "int64"}
    firsts = []
    for s in range(1 << 12):
        p = _run("randperm", {}, attrs, s)
        assert sorted(p.tolist()) == list(range(8))
        firsts.append(int(p[0]))
    counts = np.bincount(firsts, minlength=8)
    expect = (1 << 12) / 8
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 30.0                      # 7 dof: p < 1e-4
    big = _run("randperm", {}, {"n": 100000}, 3)
    assert torch.equal(torch.sort(big).values, torch.arange(100000))


def test_bernoulli_statistics():
    probs = np.repeat(np.array([[0.0, 0.1, 0.5, 0.9, 1.0]], np.float32),
                      1 << 14, axis=0)
    out = _run("bernoulli", {"X": [probs]}, {}, 4)
    assert out.dtype == torch.float32
    mean = out.numpy().mean(0)
    se = np.sqrt(probs[0] * (1 - probs[0]) / (1 << 14))
    assert np.all(np.abs(mean - probs[0]) <= 5 * se + 1e-12)


def test_sampling_id_statistics():
    """Rows of unnormalised probabilities (one class at 0): each class
    drawn in proportion, never the zero one."""
    row = np.array([2.0, 0.0, 1.0, 5.0], np.float32)
    x = np.repeat(row[None], 1 << 15, axis=0)
    out = _run("sampling_id", {"X": [x]}, {}, 5)
    assert out.dtype == torch.int64 and out.shape == (1 << 15,)
    counts = np.bincount(out.numpy(), minlength=4)
    p = row / row.sum()
    n = 1 << 15
    assert counts[1] == 0
    assert np.all(np.abs(counts - n * p) <= 5 * np.sqrt(n * p * (1 - p))
                  + 1e-9)


def test_flags_match_the_jax_package():
    registry_flags_match(TENSOR_OPS + RANDOM_OPS)


def test_host_reading_ops_refuse_capture():
    """A program holding range, linspace, load_tensor, where_index or
    py_func is run op by op on the card: the Executor's ``_host_sync``
    names the op; a program of the other ops of the library is captured
    (None)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.executor import _host_sync
    for op in ("range", "linspace", "load_tensor", "where_index",
               "py_func"):
        assert tget(op).syncs_host, op
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = ptt.layers.data("x", [4, 3], append_batch_size=False)
        ptt.layers.reduce_max(x, dim=1)
    assert _host_sync(main) is None
    with ptt.program_guard(main, start):
        ptt.layers.range(0, 4, 1, "int64")
    assert "range" in _host_sync(main)
