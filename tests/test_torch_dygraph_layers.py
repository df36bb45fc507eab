"""Every dygraph.nn layer and the two rnn_impl units: the port against the
JAX package.

Each layer is built in both packages after numpy's global RNG is seeded
alike, so its fresh weights must be equal bit for bit (both draw them
from numpy; lazily built layers after their first forward). Then one
forward on the same seeded inputs and a backward of the outputs against
a fixed random cotangent: outputs, every parameter's and float input's
gradient and the layer's buffers (BatchNorm's moving statistics,
SpectralNorm's U/V) within rtol 1e-5 and an atol of 1e-5 times the JAX
array's largest magnitude (f32 both sides, only the order of sums
differs). Dropout (random masks: different generators) is checked by its
statistics and in eval mode exactly; NCE (random noise classes) by its
fresh weights and a finite cost and gradient (its cost given the same
samples: tests/test_torch_dygraph_ops.py).
"""
import contextlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.contrib.layers import rnn_impl as jrnn
from paddle_tpu_torch.contrib.layers import rnn_impl as trnn

RTOL, ATOL = 1e-5, 1e-5


@contextlib.contextmanager
def _guard(pkg):
    with (pt.dygraph.guard() if pkg is pt
          else ptt.dygraph.guard(ptt.CPUPlace())):
        yield


def _f(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


_EDGES = np.array([[[0, 1], [0, 2], [1, 3], [-1, -1]]], np.int64)

# name -> (factory(dygraph module, rnn_impl module), inputs)
_CASES = {
    "Linear": (lambda dy, r: dy.Linear(16, 8, act="relu"), [_f(4, 16)]),
    "Conv2D": (lambda dy, r: dy.Conv2D(3, 8, 3, padding=1, act="relu"),
               [_f(2, 3, 8, 8)]),
    "Pool2D_max": (lambda dy, r: dy.Pool2D(pool_size=2, pool_stride=2),
                   [_f(2, 3, 8, 8)]),
    "Pool2D_avg_global": (lambda dy, r: dy.Pool2D(pool_type="avg",
                                                  global_pooling=True),
                          [_f(2, 3, 8, 8)]),
    "BatchNorm": (lambda dy, r: dy.BatchNorm(8, act="relu"),
                  [_f(4, 8, 6, 6)]),
    "Embedding": (lambda dy, r: dy.Embedding([100, 16], padding_idx=3),
                  [np.array([[[1], [3], [7]], [[3], [99], [0]]], np.int64)]),
    "LayerNorm": (lambda dy, r: dy.LayerNorm(32, act="tanh"),
                  [_f(4, 6, 32)]),
    "GRUUnit": (lambda dy, r: dy.GRUUnit(48), [_f(4, 48), _f(4, 16, seed=1)]),
    "FC": (lambda dy, r: dy.FC("fc", 7, num_flatten_dims=2),
           [_f(2, 3, 4, 5)]),
    "Conv2DTranspose": (lambda dy, r: dy.Conv2DTranspose(3, 5, 3, stride=2),
                        [_f(2, 3, 8, 8)]),
    "Conv3D": (lambda dy, r: dy.Conv3D(3, 4, 3, padding=1),
               [_f(2, 3, 4, 6, 6)]),
    "Conv3DTranspose": (lambda dy, r: dy.Conv3DTranspose(3, 4, 2, stride=2),
                        [_f(2, 3, 4, 6, 6)]),
    "GroupNorm": (lambda dy, r: dy.GroupNorm(channels=4, groups=2),
                  [_f(2, 4, 4, 6, 6)]),
    "SpectralNorm": (lambda dy, r: dy.SpectralNorm([6, 4], power_iters=5),
                     [_f(6, 4)]),
    "PRelu_all": (lambda dy, r: dy.PRelu("all"), [_f(2, 3, 8, 8)]),
    "PRelu_channel": (lambda dy, r: dy.PRelu("channel",
                                             input_shape=[2, 3, 8, 8]),
                      [_f(2, 3, 8, 8)]),
    "PRelu_element": (lambda dy, r: dy.PRelu("element",
                                             input_shape=[2, 3, 4]),
                      [_f(2, 3, 4)]),
    "BilinearTensorProduct": (lambda dy, r: dy.BilinearTensorProduct(4, 5,
                                                                     6),
                              [_f(3, 4), _f(3, 5, seed=1)]),
    "RowConv": (lambda dy, r: dy.RowConv("rc", future_context_size=2),
                [_f(2, 7, 5)]),
    "SequenceConv": (lambda dy, r: dy.SequenceConv("sc", num_filters=6,
                                                   filter_size=3),
                     [_f(2, 7, 5)]),
    "TreeConv": (lambda dy, r: dy.TreeConv("tc", output_size=6,
                                           num_filters=2),
                 [_f(1, 5, 4), _EDGES]),
    "BasicGRUUnit": (lambda dy, r: r.BasicGRUUnit("gru", 16),
                     [_f(4, 8), _f(4, 16, seed=1)]),
    "BasicLSTMUnit": (lambda dy, r: r.BasicLSTMUnit("lstm", 16),
                      [_f(4, 8), _f(4, 16, seed=1), _f(4, 16, seed=2)]),
}


def _run(pkg, name):
    make, arrays = _CASES[name]
    np.random.seed(11)
    with _guard(pkg):
        layer = make(pkg.dygraph, jrnn if pkg is pt else trnn)
        ins = [pkg.dygraph.to_variable(a) for a in arrays]
        out = layer(*ins)
        outs = [o for o in (out if isinstance(out, (tuple, list))
                            else [out]) if "float" in str(o.dtype)]
        cots = np.random.RandomState(12)
        total = None
        for o in outs:
            cot = pkg.dygraph.to_variable(
                cots.standard_normal(tuple(o.shape)).astype(np.float32))
            cot.stop_gradient = True
            term = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(o, cot))
            total = term if total is None else \
                pkg.layers.elementwise_add(total, term)
        fresh = layer.state_dict()
        total.backward()
        got = {"out%d" % i: o.numpy() for i, o in enumerate(outs)}
        got.update({"grad:" + n: p.gradient()
                    for n, p in layer.named_parameters()})
        got.update({"dx%d" % i: v.gradient() for i, v in enumerate(ins)
                    if v.gradient() is not None})
        for buf in ("_mean", "_variance", "_u", "_v"):
            if hasattr(layer, buf):
                got[buf] = getattr(layer, buf).numpy()
    return fresh, got


@pytest.mark.parametrize("name", sorted(_CASES))
def test_layer_matches_the_jax_package(name):
    jfresh, want = _run(pt, name)
    tfresh, got = _run(ptt, name)
    assert sorted(tfresh) == sorted(jfresh)
    for k in jfresh:
        np.testing.assert_array_equal(tfresh[k], jfresh[k], err_msg=k)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(
            got[k], w, rtol=RTOL, atol=ATOL * max(1.0, float(
                np.abs(w).max())), err_msg=k)


@pytest.mark.parametrize("mode", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout(mode):
    """Training: the kept share within 5 standard errors of 1 - p, kept
    values x or x / (1 - p), the gradient the mask; eval: the JAX
    package's output exactly."""
    p, n = 0.3, 1 << 16
    x = np.random.RandomState(0).rand(n).astype(np.float32) + 0.5
    with ptt.dygraph.guard(ptt.CPUPlace()):
        layer = ptt.dygraph.Dropout(p, mode)
        xv = ptt.dygraph.to_variable(x)
        y = layer(xv)
        ptt.layers.reduce_sum(y).backward()
        yv, gv = y.numpy(), xv.gradient()
        layer.eval()
        ev = layer(xv).numpy()
    keep = yv != 0
    assert abs(keep.mean() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    scale = 1.0 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(yv[keep], x[keep] * scale, rtol=1e-6)
    np.testing.assert_allclose(gv, keep * scale, rtol=1e-6)
    with pt.dygraph.guard():
        jl = pt.dygraph.Dropout(p, mode)
        jl.eval()
        want = jl(pt.dygraph.to_variable(x)).numpy()
    np.testing.assert_array_equal(ev, want)


def test_nce():
    rng = np.random.RandomState(4)
    feats = rng.standard_normal((4, 8)).astype(np.float32)
    labels = rng.randint(0, 20, (4, 1)).astype(np.int64)

    def build(pkg):
        np.random.seed(5)
        with _guard(pkg):
            return pkg.dygraph.NCE(num_total_classes=20, dim=8,
                                   num_neg_samples=5, sampler="log_uniform")
    jfresh = build(pt).state_dict()
    layer = build(ptt)
    fresh = layer.state_dict()
    with ptt.dygraph.guard(ptt.CPUPlace()):
        cost = layer(ptt.dygraph.to_variable(feats),
                     ptt.dygraph.to_variable(labels))
        ptt.layers.reduce_sum(cost).backward()
        cost, grad = cost.numpy(), layer.weight.gradient()
    for k in jfresh:
        np.testing.assert_array_equal(fresh[k], jfresh[k])
    assert cost.shape == (4, 1) and np.isfinite(cost).all()
    assert np.isfinite(grad).all() and np.abs(grad).sum() > 0
    with pytest.raises(NotImplementedError):
        ptt.dygraph.NCE(20, 8, sampler="custom_dist")
