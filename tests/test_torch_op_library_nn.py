"""The op library's nn, misc and loss ops, the port against the JAX
package: bpr_loss, huber_loss, instance_norm, kldiv_loss, l2_normalize,
log_loss, lookup_table_v2, margin_rank_loss, mse_loss, pad, pad2d,
smooth_l1_loss, square_error_cost (paddle_tpu/ops/nn_ops.py); cos_sim,
crop, multiplex's neighbours mean_iou, chunk_eval, data_norm, py_func
(misc_ops.py); center_loss, edit_distance, hierarchical_sigmoid,
sampled_softmax_with_cross_entropy, teacher_student_sigmoid_loss
(loss_extra_ops.py). Each registry kernel forward and gradient on the
same inputs (op_library_helpers.compare): f32 rtol 1e-5, atol 1e-5;
counts, chunk statistics, distances and data moved by pad exactly.
``sampled_softmax_with_cross_entropy`` draws its classes (Philox against
threefry): its loss is held given the JAX op's own samples, its sampler
by the log-uniform q(class).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from op_library_helpers import (TorchCtx, check, compare, f32,
                                registry_flags_match)
from paddle_tpu.ops import loss_extra_ops as jlx
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops import loss_extra_ops as tlx
from paddle_tpu_torch.ops.registry import get_op as tget

NN_OPS = ("bpr_loss", "huber_loss", "instance_norm", "kldiv_loss",
          "l2_normalize", "log_loss", "lookup_table_v2", "margin_rank_loss",
          "mse_loss", "pad", "pad2d", "smooth_l1_loss", "square_error_cost",
          "cos_sim", "crop", "mean_iou", "chunk_eval", "data_norm", "py_func",
          "center_loss", "edit_distance", "hierarchical_sigmoid",
          "sampled_softmax_with_cross_entropy",
          "teacher_student_sigmoid_loss")


def _r(seed=0):
    return np.random.RandomState(seed)


def test_square_error_and_mse():
    rng = _r()
    x, y = f32(rng, 5, 3), f32(rng, 5, 3)
    compare("square_error_cost", {"X": [x], "Y": [y]}, {},
            diff=[("X", 0), ("Y", 0)])
    compare("mse_loss", {"Input": [x], "Label": [y]}, {}, diff=[("Input", 0)])


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1(weights, sigma):
    rng = _r(1)
    x, y = f32(rng, 6, 4), f32(rng, 6, 4)
    ins = {"X": [x], "Y": [y]}
    if weights:
        ins["InsideWeight"] = [np.abs(f32(rng, 6, 4))]
        ins["OutsideWeight"] = [np.abs(f32(rng, 6, 4))]
    compare("smooth_l1_loss", ins, {"sigma": sigma}, diff=[("X", 0)],
            grad_outs=["Out", "Diff"])


@pytest.mark.parametrize("delta", [0.5, 2.0])
def test_huber(delta):
    rng = _r(2)
    compare("huber_loss", {"X": [f32(rng, 7, 1)], "Y": [f32(rng, 7, 1)]},
            {"delta": delta}, diff=[("X", 0)], grad_outs=["Out", "Residual"])


def test_log_loss():
    rng = _r(3)
    p = rng.uniform(0.01, 0.99, (6, 1)).astype(np.float32)
    lbl = (rng.rand(6, 1) > 0.5).astype(np.float32)
    compare("log_loss", {"Predicted": [p], "Labels": [lbl]},
            {"epsilon": 1e-4}, diff=[("Predicted", 0)])


@pytest.mark.parametrize("reduction", ["mean", "sum", "batchmean", "none"])
def test_kldiv(reduction):
    rng = _r(4)
    x = f32(rng, 4, 5)
    t = np.abs(f32(rng, 4, 5))
    t[0, 0], t[1, 2] = 0.0, -0.5           # the target <= 0 branch
    compare("kldiv_loss", {"X": [x], "Target": [t]},
            {"reduction": reduction}, diff=[("X", 0)])


@pytest.mark.parametrize("labels", [[0, 3, 2, 3], [1, -1, 4, 0]],
                         ids=["in", "negative_and_past"])
def test_bpr(labels):
    """A label below 0 excludes no column from the negatives and reads
    the wrapped logit; one past the end gives NaN (jnp.take_along_axis's
    fill)."""
    rng = _r(5)
    lbl = np.array(labels, np.int64).reshape(4, 1)
    x = f32(rng, 4, 4)
    out, _ = compare("bpr_loss", {"X": [x], "Label": [lbl]}, {},
                     diff=[("X", 0)] if min(labels) >= 0 else [])
    if max(labels) >= 4:
        assert np.isnan(out["Y"][0][2, 0])


def test_margin_rank():
    rng = _r(6)
    x1, x2 = f32(rng, 6, 1), f32(rng, 6, 1)
    lbl = np.sign(f32(rng, 6, 1)).astype(np.float32)
    compare("margin_rank_loss", {"X1": [x1], "X2": [x2], "Label": [lbl]},
            {"margin": 0.1}, diff=[("X1", 0), ("X2", 0)],
            exact=("Activated",))


@pytest.mark.parametrize("scale_bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 3, 7)])
def test_instance_norm(scale_bias, shape):
    rng = _r(7)
    ins = {"X": [f32(rng, *shape) * 2 + 1]}
    diff = [("X", 0)]
    if scale_bias:
        ins["Scale"] = [f32(rng, shape[1])]
        ins["Bias"] = [f32(rng, shape[1])]
        diff += [("Scale", 0), ("Bias", 0)]
    compare("instance_norm", ins, {"epsilon": 1e-5}, diff=diff)


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_l2_normalize(axis):
    x = f32(_r(8), 3, 4, 5)
    x[0, 0] = 0.0
    compare("l2_normalize", {"X": [x]}, {"axis": axis, "epsilon": 1e-10},
            diff=[("X", 0)], grad_outs=["Out", "Norm"])


def test_lookup_table_v2():
    rng = _r(9)
    w = f32(rng, 6, 3)
    ids = np.array([[0, 5, -1], [2, 6, 2]], np.int64)
    compare("lookup_table_v2", {"W": [w], "Ids": [ids]},
            {"padding_idx": 2}, diff=[("W", 0)])


@pytest.mark.parametrize("paddings,value", [
    ([1, 0, 0, 2, 3, 1], 0.0), ([0, 0, 2, 2, 0, 0], -1.5)])
def test_pad(paddings, value):
    compare("pad", {"X": [f32(_r(10), 2, 3, 4)]},
            {"paddings": paddings, "pad_value": value}, diff=[("X", 0)],
            exact=("Out",))


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
@pytest.mark.parametrize("paddings", [[1, 2, 0, 3], [2, 0, 3, 1]])
def test_pad2d(mode, paddings):
    compare("pad2d", {"X": [f32(_r(11), 2, 3, 4, 5)]},
            {"paddings": paddings, "mode": mode, "pad_value": 0.5},
            diff=[("X", 0)], exact=("Out",))


@pytest.mark.parametrize("ny", [5, 1])
def test_cos_sim(ny):
    rng = _r(12)
    x, y = f32(rng, 5, 6), f32(rng, ny, 6)
    x[1] = 0.0                              # the 1e-12 floor
    compare("cos_sim", {"X": [x], "Y": [y]}, {}, diff=[("X", 0), ("Y", 0)])


@pytest.mark.parametrize("attrs", [{"shape": [2, 3], "offsets": [1, 1]},
                                   {"shape": [3, 2]}])
def test_crop(attrs):
    compare("crop", {"X": [f32(_r(13), 4, 5)]}, attrs, diff=[("X", 0)],
            exact=("Out",))


def test_crop_by_reference():
    compare("crop", {"X": [f32(_r(14), 4, 5)], "Y": [np.zeros((2, 4),
                                                              np.float32)]},
            {"offsets": [2, 0]}, diff=[("X", 0)], exact=("Out",))


def test_mean_iou():
    rng = _r(15)
    pred = rng.randint(0, 5, (40,)).astype(np.int64)
    lbl = rng.randint(0, 5, (40,)).astype(np.int64)
    pred[:3] = 7                            # out of range: no class
    compare("mean_iou", {"Predictions": [pred], "Labels": [lbl]},
            {"num_classes": 6}, exact=("OutWrong", "OutCorrect"))


@pytest.mark.parametrize("scheme,types", [("IOB", 3), ("IOE", 2),
                                          ("IOBES", 2), ("plain", 4)])
@pytest.mark.parametrize("lengths", [False, True])
def test_chunk_eval(scheme, types, lengths):
    rng = _r(16)
    ntt = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    top = types * ntt + 1
    inf = rng.randint(0, top, (4, 12)).astype(np.int64)
    lab = inf.copy()
    lab[rng.rand(4, 12) < 0.3] = rng.randint(0, top)
    ins = {"Inference": [inf], "Label": [lab]}
    if lengths:
        ins["SeqLength"] = [np.array([12, 7, 1, 10], np.int64)]
    compare("chunk_eval", ins, {"chunk_scheme": scheme,
                                "num_chunk_types": types,
                                "excluded_chunk_types": [1]
                                if types > 2 else []},
            exact=("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"))


def test_data_norm():
    rng = _r(17)
    c = 4
    ins = {"X": [f32(rng, 6, c)],
           "BatchSize": [np.full((c,), 1e4, np.float32)],
           "BatchSum": [f32(rng, c)],
           "BatchSquareSum": [np.full((c,), 1e4, np.float32) +
                              np.abs(f32(rng, c))]}
    compare("data_norm", ins, {"epsilon": 1e-5}, diff=[("X", 0)])


@pytest.mark.parametrize("update", [True, False])
def test_center_loss(update):
    """Repeated labels (the centers' sums add in a fixed order) and one
    label out of range (NaN loss, no update)."""
    rng = _r(18)
    x = f32(rng, 6, 3)
    lbl = np.array([0, 2, 2, 4, 0, 7], np.int64).reshape(6, 1)
    centers = f32(rng, 5, 3)
    ins = {"X": [x], "Label": [lbl], "Centers": [centers],
           "CenterUpdateRate": [np.array([0.5], np.float32)]}
    out, _ = compare("center_loss", ins, {"update_center": update},
                     diff=[("X", 0)])
    assert np.isnan(out["Loss"][0][5, 0])


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    rng = _r(19)
    hyps = rng.randint(0, 4, (5, 7)).astype(np.int64)
    refs = rng.randint(0, 4, (5, 6)).astype(np.int64)
    refs[1] = hyps[1, :6]
    ins = {"Hyps": [hyps], "Refs": [refs],
           "HypsLength": [np.array([7, 6, 0, 3, 5], np.int64)],
           "RefsLength": [np.array([6, 6, 4, 0, 2], np.int64)]}
    compare("edit_distance", ins, {"normalized": normalized},
            exact=("Out", "SequenceNum"))
    compare("edit_distance", {"Hyps": [hyps], "Refs": [refs]},
            {"normalized": normalized}, exact=("Out", "SequenceNum"))


@pytest.mark.parametrize("classes", [6, 8, 2])
@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid(classes, bias):
    rng = _r(20)
    x = f32(rng, 5, 4)
    lbl = rng.randint(0, classes, (5, 1)).astype(np.int64)
    ins = {"X": [x], "Label": [lbl], "W": [f32(rng, classes - 1, 4)]}
    diff = [("X", 0), ("W", 0)]
    if bias:
        ins["Bias"] = [f32(rng, classes - 1, 1)]
        diff.append(("Bias", 0))
    compare("hierarchical_sigmoid", ins, {"num_classes": classes},
            diff=diff, grad_outs=["Out", "PreOut"])


def test_teacher_student_sigmoid_loss():
    x = f32(_r(21), 8, 1) * 3
    lbl = np.array([-2.0, -1.5, -0.5, 0.0, 0.3, 1.0, 1.7, 0.99],
                   np.float32).reshape(8, 1)
    compare("teacher_student_sigmoid_loss", {"X": [x], "Label": [lbl]}, {},
            diff=[("X", 0)])


class _KeyCtx(object):
    def __init__(self, key):
        self._key = key

    def rng(self):
        return self._key


def test_sampled_softmax_given_the_same_samples():
    """The port's loss (``sampled_softmax_ce``) on the classes the JAX op
    drew from its key, against the JAX op's loss and gradient; labels
    that the samples hit by accident are masked in both."""
    rng = _r(22)
    n, c, s = 6, 40, 12
    logits = f32(rng, n, c)
    lbl = rng.randint(0, c, (n, 1)).astype(np.int64)
    key = jax.random.PRNGKey(5)
    neg = np.asarray(jlx._sample_classes(key, c, s, "log_uniform"))
    lbl[0, 0] = neg[0]                      # an accidental hit
    attrs = {"num_samples": s}

    def f(lg):
        return jget("sampled_softmax_with_cross_entropy").fn(
            _KeyCtx(key), {"Logits": [lg], "Label": [jnp.asarray(lbl)]},
            attrs)["Loss"]
    want, vjp = jax.vjp(f, jnp.asarray(logits))
    cot = f32(_r(23), n, 1)
    wgrad, = vjp(jnp.asarray(cot))
    tl = torch.from_numpy(logits).requires_grad_()
    got = tlx.sampled_softmax_ce(tl, torch.from_numpy(lbl.reshape(-1)),
                                 torch.from_numpy(neg.astype(np.int64)))
    g, = torch.autograd.grad(got, [tl], torch.from_numpy(cot))
    check(got.detach().numpy(), np.asarray(want))
    check(g.numpy(), np.asarray(wgrad))


def test_sampled_softmax_sampler():
    """The op's draws follow its generator's seed, are in range, and the
    loss is finite and positive."""
    rng = _r(24)
    ins = {"Logits": [torch.from_numpy(f32(rng, 4, 30))],
           "Label": [torch.from_numpy(rng.randint(0, 30, (4, 1)))]}
    op = tget("sampled_softmax_with_cross_entropy")
    a = op.fn(TorchCtx(1), ins, {"num_samples": 8})["Loss"]
    b = op.fn(TorchCtx(1), ins, {"num_samples": 8})["Loss"]
    c = op.fn(TorchCtx(2), ins, {"num_samples": 8})["Loss"]
    assert a.shape == (4, 1) and bool((a > 0).all())
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_py_func_forward_and_backward():
    """A host function and its backward in both packages, through the
    layer (py_func registers the callable in each package's table)."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    from test_torch_ops import _build

    def fwd(x):
        return np.tanh(x) * 2.0

    def bwd(x, y, gy):
        return gy * 2.0 * (1.0 - np.tanh(x) ** 2)

    def build(p):
        x = p.layers.data("x", [3, 4], append_batch_size=False,
                          stop_gradient=False)
        out = p.default_main_program().global_block().create_var(
            name="pyout", dtype="float32", shape=(3, 4))
        p.layers.py_func(fwd, x, out, backward_func=bwd)
        loss = p.layers.reduce_sum(p.layers.square(out))
        return [out] + p.framework.backward.gradients([loss], [x])
    feed = {"x": f32(_r(25), 3, 4)}
    outs = []
    for pkg, place in ((pt, pt.CPUPlace()), (ptt, ptt.CPUPlace())):
        main, start, fetch = _build(pkg, build)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(place)
            exe.run(start)
            outs.append([np.asarray(v) for v in
                         exe.run(main, feed=feed, fetch_list=fetch)])
    for j, t in zip(*outs):
        check(t, j)


def test_flags_match_the_jax_package():
    registry_flags_match(NN_OPS)
