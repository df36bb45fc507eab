"""The text-matching contrib ops (paddle_tpu/ops/contrib_ops.py:
``match_matrix_tensor``, ``sequence_topk_avg_pooling``, ``var_conv_2d``,
``shuffle_batch``), the eight functions of ``contrib.layers.nn`` and the
``voc2012`` corpus, the port against the JAX package.

Ops: each registry kernel's outputs and input gradients on the same
inputs (op_library_helpers.compare, against ``jax.vjp``): f32 rtol 1e-5,
atol 1e-5. ``var_conv_2d`` at XLA's "SAME" padding with a stride of 2 and
an even kernel (``F.conv2d(padding="same")`` refuses a stride above 1);
``sequence_topk_avg_pooling`` with tied scores (the gradient goes to the
column ``-sort(-x)`` puts first). ``shuffle_batch`` draws (Philox cannot
match threefry): held by its invariants (Out == X[ShuffleIdx], a
permutation, the gradient the inverse permutation of the cotangent,
uniform positions over 2000 draws within 5 standard errors),
``startup_seed`` pinning the draw at every run, and an unpinned draw
changing with the run counter.

Layers: each function built in both packages, started from the JAX
startup's persistables, run on the CPU on the same feeds
(test_torch_resnet.run_pair): outputs and gradients within rtol 1e-5,
atol 1e-5. voc2012: every record of each split equal array for array.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from op_library_helpers import TorchCtx, compare, f32, registry_flags_match
from paddle_tpu_torch.ops.registry import get_op as tget
from test_torch_ops import _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

OPS = ("shuffle_batch", "match_matrix_tensor", "sequence_topk_avg_pooling",
       "var_conv_2d")


def _r(seed=0):
    return np.random.RandomState(seed)


def test_registry_flags_match():
    registry_flags_match(OPS)


def test_match_matrix_tensor():
    rng = _r(1)
    compare("match_matrix_tensor",
            {"X": [f32(rng, 3, 5, 4)], "Y": [f32(rng, 3, 7, 6)],
             "W": [f32(rng, 4, 2, 6)]}, {"dim_t": 2},
            diff=[("X", 0), ("Y", 0), ("W", 0)], jit=True)


@pytest.mark.parametrize("topks", [[1, 3, 5], [2, 9]])
def test_sequence_topk_avg_pooling(topks):
    """Scores on a half grid (ties), a row length of 0 and column lengths
    under and over k."""
    rng = _r(2)
    x = np.round(f32(rng, 3, 2, 5, 8) * 2) / 2
    x[0, 0, 0, :4] = [0.0, -0.0, 0.0, -0.0]
    compare("sequence_topk_avg_pooling",
            {"X": [x], "RowLen": [np.int64([5, 0, 3])],
             "ColLen": [np.int64([8, 2, 5])]},
            {"topks": topks, "channel_num": 2}, diff=[("X", 0)], jit=True)


@pytest.mark.parametrize("stride,ks", [([1, 1], (3, 3)), ([2, 2], (4, 4)),
                                       ([2, 3], (2, 3)), ([3, 1], (5, 2))])
def test_var_conv_2d_same_padding(stride, ks):
    """XLA's "SAME" padding (total max((out - 1) s + k - in, 0), the low
    side total // 2) at strides above 1 and even kernels."""
    rng = _r(3)
    compare("var_conv_2d",
            {"X": [f32(rng, 3, 2, 9, 10)], "W": [f32(rng, 4, 2, *ks)],
             "RowLen": [np.int64([9, 4, 1])],
             "ColLen": [np.int64([10, 7, 3])]},
            {"stride": stride}, diff=[("X", 0), ("W", 0)], jit=True)


def test_shuffle_batch_invariants():
    fn = tget("shuffle_batch").fn
    x = torch.from_numpy(f32(_r(4), 12, 3)).requires_grad_()
    pos = np.zeros((12, 12))
    for seed in range(2000):
        out = fn(TorchCtx(seed), {"X": [x]}, {"startup_seed": -1})
        idx = out["ShuffleIdx"]
        assert idx.dtype == torch.int64
        assert sorted(idx.tolist()) == list(range(12))
        assert torch.equal(out["Out"], x[idx])
        pos[np.arange(12), idx.numpy()] += 1
    cot = torch.randn(12, 3)
    grad, = torch.autograd.grad(out["Out"], x, cot)
    inv = torch.argsort(idx)
    assert torch.equal(grad, cot[inv])
    p = 1 / 12
    se = np.sqrt(2000 * p * (1 - p))
    assert np.all(np.abs(pos - 2000 * p) <= 5 * se)
    from paddle_tpu_torch.framework.executor import RunContext
    pinned = [fn(RunContext(torch.device("cpu"), ptt.Program(), salt),
                 {"X": [x]}, {"startup_seed": 5})["ShuffleIdx"]
              for salt in (0, 1)]
    assert torch.equal(pinned[0], pinned[1])
    free = [fn(RunContext(torch.device("cpu"), ptt.Program(), salt),
               {"X": [x]}, {"startup_seed": -1})["ShuffleIdx"]
            for salt in (0, 1)]
    assert not torch.equal(free[0], free[1])


# ---- contrib.layers.nn -------------------------------------------------------

def _params(p):
    return list(p.default_main_program().global_block().all_parameters())


def test_contrib_layers_exports():
    import paddle_tpu.contrib.layers as jcl
    import paddle_tpu_torch.contrib.layers as tcl
    assert tcl.nn.__all__ == jcl.nn.__all__
    assert set(jcl.__all__) <= set(tcl.__all__)
    for name in jcl.nn.__all__:
        assert callable(getattr(tcl, name))


def test_text_matching_layers():
    """match_matrix_tensor -> var_conv_2d -> sequence_topk_avg_pooling,
    PaddleNLP's MM-DNN match path, with its parameters' gradients."""
    def build(p):
        cl = p.contrib.layers
        x = _grad_data(p, "x", (2, 6, 4))
        y = _grad_data(p, "y", (2, 5, 3))
        rl = _data(p, "rl", (2,), "int64")
        cc = _data(p, "cc", (2,), "int64")
        mm, w = cl.match_matrix_tensor(x, y, 3, act="tanh")
        conv = cl.var_conv_2d(mm, rl, cc, 3, 4, [2, 2], stride=[1, 2],
                              act="relu")
        pooled = cl.sequence_topk_avg_pooling(conv, rl, cc, [1, 2], 4)
        return _with_grads(p, [mm, conv, pooled], [x, y] + _params(p))
    feed = dict({"x": _x((2, 6, 4)), "y": _x((2, 5, 3), 1),
                 "rl": np.int64([6, 3]), "cc": np.int64([5, 2])},
                **_cots(2 * 3 * 6 * 5, 2 * 4 * 6 * 3, 2 * 6 * 8))
    run_pair(build, [feed])


@pytest.mark.parametrize("functors", [["elementwise_add", "relu"],
                                      ["scale", "elementwise_mul"],
                                      ["elementwise_sub", "tanh"]])
def test_fused_elemwise_activation(functors):
    def build(p):
        x = _grad_data(p, "x", (3, 4))
        y = _grad_data(p, "y", (3, 4))
        out, mid = p.contrib.layers.fused_elemwise_activation(
            x, y, functors, scale=0.5)
        return _with_grads(p, [out, mid], [x, y])
    run_pair(build, [dict({"x": _x((3, 4)), "y": _x((3, 4), 1)},
                          **_cots(12, 12))])


def test_tree_conv_and_fused_embedding_seq_pool():
    def build(p):
        cl = p.contrib.layers
        nodes = _grad_data(p, "nodes", (2, 5, 3))
        edges = _data(p, "edges", (2, 4, 2), "int64")
        tc = cl.tree_conv(nodes, edges, 4, num_filters=2, max_depth=3)
        ids = _data(p, "ids", (2, 6, 1), "int64")
        outs = [tc] + [cl.fused_embedding_seq_pool(
            ids, [30, 4], combiner=c, padding_idx=0)
            for c in ("sum", "average", "max")]
        return _with_grads(p, outs, [nodes] + _params(p))
    edges = np.int64([[[0, 1], [0, 2], [1, 3], [1, 4]],
                      [[0, 1], [1, 2], [-1, -1], [-1, -1]]])
    feed = dict({"nodes": _x((2, 5, 3)), "edges": edges,
                 "ids": _r(5).randint(0, 30, (2, 6, 1)).astype(np.int64)},
                **_cots(80, 8, 8, 8))
    run_pair(build, [feed])


def test_multiclass_nms2_and_shuffle_batch_layers():
    def build(p):
        cl = p.contrib.layers
        boxes = _data(p, "boxes", (2, 8, 4))
        scores = _data(p, "scores", (2, 3, 8))
        out, index = cl.multiclass_nms2(boxes, scores, 0.1, 6, 5,
                                        return_index=True)
        return [out, index]
    rng = _r(6)
    b = rng.uniform(0, 0.6, (2, 8, 2))
    feed = {"boxes": np.concatenate([b, b + rng.uniform(0.1, 0.4, (2, 8, 2))],
                                    -1).astype(np.float32),
            "scores": rng.uniform(0, 1, (2, 3, 8)).astype(np.float32)}
    run_pair(build, [feed])
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start):
            x = _data(pkg, "x", (6, 2))
            out = pkg.contrib.layers.shuffle_batch(x, seed=3)
        assert out.shape == (6, 2)
        types = [op.type for op in main.global_block().ops]
        assert types == ["shuffle_batch"]
        assert main.global_block().ops[0].attrs["startup_seed"] == 3


# ---- voc2012 ---------------------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_voc2012_records_equal_the_jax_packages(split):
    from paddle_tpu.dataset import voc2012 as jv
    from paddle_tpu_torch.dataset import voc2012 as tv
    want = list(getattr(jv, split)()())
    got = list(getattr(tv, split)()())
    assert len(got) == len(want) == {"train": 200, "test": 50,
                                     "val": 50}[split]
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert tv.__all__ == jv.__all__
    assert "voc2012" in ptt.dataset.__all__
