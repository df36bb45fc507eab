"""The static layers over the op library, ``nets`` and the
distributions, the port against the JAX package: each case builds the
same calls through ``layers`` (or ``nets``) in both packages (same op
types, attrs and unique names), starts both from the JAX startup's
persistables and runs each Executor on the CPU on the same feeds
(``run_pair``), comparing every fetch; a list of feeds runs on one
scope, so state an op writes back (``data_norm``'s accumulators,
``center_loss``'s centers, ``spectral_norm``'s U and V) is held across
runs. Gradients are those of sum_i <out_i, cot_i>. f32 rtol 1e-5, atol
1e-5 (a 3-D convolution's filter gradient sums N*D*H*W products: atol
2e-5); ids, counts and moved data exactly. Layers that draw (``nce``,
``sampled_softmax_with_cross_entropy``, the random layers,
``Categorical.sample``) are held by shape and range only: the kernels'
draws are tested by their statistics in test_torch_op_library_*.py.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import _build, _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

CONV_TOL = dict(rtol=1e-5, atol=2e-5)


def _params(p):
    return list(p.default_main_program().global_block().all_parameters())


def _one(build, feed, tol=None):
    return run_pair(build, [feed], **({} if tol is None else {"tol": tol}))


# ---- layers/nn.py -----------------------------------------------------------

@pytest.mark.parametrize("op", ["reduce_max", "reduce_min", "reduce_prod"])
def test_reduce_layers(op):
    def build(p):
        x = _grad_data(p, "x", (3, 4, 5))
        y = getattr(p.layers, op)(x, dim=[1, 2], keep_dim=True)
        z = getattr(p.layers, op)(x)
        return _with_grads(p, [y, z], [x])
    _one(build, dict({"x": _x((3, 4, 5)) * 0.5 + 1}, **_cots(3, 1)))


def test_bool_reduce_layers():
    def build(p):
        x = _data(p, "x", (3, 4), "bool")
        return [p.layers.reduce_all(x, dim=1), p.layers.reduce_any(x)]
    _one(build, {"x": np.random.RandomState(0).rand(3, 4) > 0.4})


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag(mode):
    def build(p):
        ids = _data(p, "ids", (4, 3), "int64")
        y = p.layers.embedding_bag(ids, [10, 6], mode=mode)
        return _with_grads(p, [y], _params(p))
    ids = np.array([[1, 2, 2], [0, 9, 3], [4, 4, 4], [7, 1, 0]], np.int64)
    _one(build, dict({"ids": ids}, **_cots(24)))


def test_shape_flatten_unstack_pad():
    def build(p):
        x = _grad_data(p, "x", (2, 3, 4, 5))
        outs = [p.layers.flatten(x, axis=2),
                p.layers.pad(x, [0, 0, 1, 0, 0, 2, 1, 1], pad_value=0.5),
                p.layers.pad2d(x, [1, 0, 2, 1], mode="reflect"),
                p.layers.pad2d(x, [0, 1, 1, 0], mode="edge"),
                p.layers.pad2d(x, [1, 1, 0, 0], pad_value=-2.0)]
        outs += p.layers.unstack(x, axis=1)
        return _with_grads(p, outs, [x]) + [p.layers.shape(x)]
    sizes = [120, 2 * 4 * 6 * 7, 2 * 3 * 5 * 8, 2 * 3 * 5 * 6, 2 * 3 * 6 * 5,
             40, 40, 40]
    _one(build, dict({"x": _x((2, 3, 4, 5))}, **_cots(*sizes)))


def test_gather_scatter_layers():
    def build(p):
        x = _grad_data(p, "x", (5, 3))
        idx = _data(p, "idx", (4, 1), "int64")
        ids = _data(p, "ids", (3,), "int64")
        upd = _grad_data(p, "upd", (3, 3))
        outs = [p.layers.gather_nd(x, idx),
                p.layers.scatter(x, ids, upd),
                p.layers.scatter(x, ids, upd, overwrite=False),
                p.layers.scatter_nd_add(
                    x, p.layers.slice(idx, [0], [0], [3]), upd)]
        return _with_grads(p, outs, [x, upd])
    feed = dict({"x": _x((5, 3)), "idx": np.array([[4], [0], [-2], [9]]),
                 "ids": np.array([1, 1, 3]), "upd": _x((3, 3), 1)},
                **_cots(12, 15, 15, 15))
    _one(build, feed)


@pytest.mark.parametrize("mode", ["all", "channel", "element"])
def test_prelu(mode):
    def build(p):
        x = _grad_data(p, "x", (2, 3, 4, 4))
        return _with_grads(p, [p.layers.prelu(x, mode)], [x] + _params(p))
    _one(build, dict({"x": _x((2, 3, 4, 4))}, **_cots(96)))


def test_norm_layers():
    """instance_norm, the static group_norm and l2_normalize, with their
    parameters' gradients; maxout."""
    def build(p):
        x = _grad_data(p, "x", (2, 4, 3, 5))
        outs = [p.layers.instance_norm(x), p.layers.group_norm(x, 2),
                p.layers.l2_normalize(x, axis=1), p.layers.maxout(x, 2)]
        return _with_grads(p, outs, [x] + _params(p))
    _one(build, dict({"x": _x((2, 4, 3, 5)) * 2 + 0.5},
                     **_cots(120, 120, 120, 60)))


def test_spectral_norm_state():
    """The static spectral_norm writes its U and V iterates back: two
    runs on one scope."""
    def build(p):
        w = _grad_data(p, "w", (4, 3, 2))
        y = p.layers.spectral_norm(w, dim=1, power_iters=2)
        state = [v for v in p.default_main_program().list_vars()
                 if v.persistable]
        return _with_grads(p, [y], [w]) + state
    feed = dict({"w": _x((4, 3, 2))}, **_cots(24))
    run_pair(build, [feed, dict(feed, w=_x((4, 3, 2), 5))])


# ---- layers/tensor.py, ops.py, learning_rate_scheduler.py -------------------

def test_tensor_layers():
    def build(p):
        x = _data(p, "x", (3, 5))
        srt, idx = p.layers.argsort(x, axis=1, descending=True)
        g = p.layers.create_global_var([2, 2], 1.5, "float32",
                                       persistable=True, name="gv")
        return [p.layers.argmin(x, axis=1), srt, idx, g,
                p.layers.diag(p.layers.reduce_sum(x, dim=0)),
                p.layers.eye(3, 4), p.layers.has_inf(x),
                p.layers.has_nan(x), p.layers.isfinite(x),
                p.layers.ones([2, 3]), p.layers.zeros([3], "int64"),
                p.layers.learning_rate_scheduler.elementwise_min_var(
                    x, p.layers.fill_constant([3, 5], "float32", 0.1)),
                p.layers.learning_rate_scheduler.scale_lr(x, 3.0)]
    x = _x((3, 5))
    x[1, 2] = np.inf
    _one(build, {"x": x}, tol=dict(rtol=1e-5, atol=1e-5))


def test_range_and_linspace_layers():
    """The JAX package runs ``range`` and ``linspace`` only outside its
    jitted step (their lengths come from values), so the port's program
    is held to the JAX kernels called on the same values, and the layers'
    ops and attrs to the JAX package's."""
    from paddle_tpu.ops.registry import get_op as jget
    import jax.numpy as jnp

    def build(p):
        return [p.layers.range(1, 10, 2, "int64"),
                p.layers.range(0.5, 2.0, 0.25, "float32"),
                p.layers.linspace(0.0, 2.0, 5)]
    jmain, _, _ = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    assert [(o.type, o.attrs) for o in jmain.global_block().ops] == \
        [(o.type, o.attrs) for o in tmain.global_block().ops]
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(tstart)
        got = exe.run(tmain, fetch_list=tfetch)
    f = jnp.asarray
    want = [jget("range").fn(None, {"Start": [f([1])], "End": [f([10])],
                                    "Step": [f([2])]}, {})["Out"],
            jget("range").fn(None, {"Start": [f([0.5])], "End": [f([2.0])],
                                    "Step": [f([0.25])]}, {})["Out"],
            jget("linspace").fn(None, {"Start": [f([0.0])],
                                       "Stop": [f([2.0])],
                                       "Num": [f([5])]}, {})["Out"]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_create_tensor_and_assign():
    def build(p):
        t = p.layers.create_tensor("float32", name="made")
        p.layers.assign(_data(p, "x", (2, 2)), t)
        return [t]
    _one(build, {"x": _x((2, 2))})


def test_random_layers_shapes():
    """The random layers' ops and attrs equal the JAX package's; their
    draws (Philox here) only by shape and range."""
    def build(p):
        u = p.layers.uniform_random([64, 8], min=-2.0, max=3.0, seed=5)
        g = p.layers.gaussian_random([64, 8], mean=1.0, std=0.5)
        s = p.layers.sampling_id(p.layers.softmax(_data(p, "x", (6, 4))))
        return [u, g, s]
    jmain, _, _ = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    assert [(o.type, o.attrs) for o in jmain.global_block().ops] == \
        [(o.type, o.attrs) for o in tmain.global_block().ops]
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(tstart)
        u, g, s = exe.run(tmain, feed={"x": _x((6, 4))}, fetch_list=tfetch)
    assert u.shape == (64, 8) and u.min() >= -2.0 and u.max() < 3.0
    assert abs(float(g.mean()) - 1.0) < 0.1 and s.shape == (6,)
    assert s.min() >= 0 and s.max() < 4


# ---- layers/loss.py --------------------------------------------------------

def test_regression_losses():
    def build(p):
        x = _grad_data(p, "x", (6, 1))
        y = _data(p, "y", (6, 1))
        outs = [p.layers.square_error_cost(x, y), p.layers.mse_loss(x, y),
                p.layers.smooth_l1(x, y, sigma=2.0),
                p.layers.huber_loss(x, y, 0.5),
                p.layers.log_loss(p.layers.sigmoid(x),
                                  p.layers.cast(p.layers.greater_than(
                                      y, p.layers.zeros([6, 1])),
                                      "float32")),
                p.layers.margin_rank_loss(p.layers.sign(y), x,
                                          p.layers.scale(x, 0.5)),
                p.layers.rank_loss(p.layers.cast(p.layers.greater_than(
                    y, p.layers.zeros([6, 1])), "float32"), x,
                    p.layers.scale(x, -1.0)),
                p.layers.teacher_student_sigmoid_loss(x, y)]
        return _with_grads(p, outs, [x])
    _one(build, dict({"x": _x((6, 1)), "y": _x((6, 1), 1)},
                     **_cots(*[6] * 8)))


def test_classification_losses():
    def build(p):
        x = _grad_data(p, "x", (5, 4))
        lbl = _data(p, "lbl", (5, 1), "int64")
        t = _data(p, "t", (5, 4))
        outs = [p.layers.bpr_loss(x, lbl),
                p.layers.kldiv_loss(p.layers.log_softmax(x), t,
                                    reduction="batchmean"),
                p.layers.hsigmoid(x, lbl, 6)]
        return _with_grads(p, outs, [x] + _params(p))
    t = np.abs(_x((5, 4), 2))
    t /= t.sum(1, keepdims=True)
    _one(build, dict({"x": _x((5, 4)), "t": t,
                      "lbl": np.array([[0], [3], [1], [2], [3]])},
                     **_cots(5, 1, 5)))


def test_npair_loss():
    def build(p):
        a = _grad_data(p, "a", (4, 6))
        b = _grad_data(p, "b", (4, 6))
        lbl = _data(p, "lbl", (4,), "float32")
        return _with_grads(p, [p.layers.npair_loss(a, b, lbl)], [a, b])
    _one(build, dict({"a": _x((4, 6)), "b": _x((4, 6), 1),
                      "lbl": np.array([1, 2, 1, 3], np.float32)},
                     **_cots(1)))


def test_center_loss_state():
    """Centers written back by the op (not by the optimizer): three runs
    on one scope, repeated labels."""
    def build(p):
        x = _grad_data(p, "x", (5, 3))
        lbl = _data(p, "lbl", (5, 1), "int64")
        loss = p.layers.center_loss(x, lbl, 4, 0.3)
        centers = [v for v in p.default_main_program().list_vars()
                   if v.persistable]
        return _with_grads(p, [loss], [x]) + centers
    lbl = np.array([[0], [2], [2], [1], [0]])
    feeds = [dict({"x": _x((5, 3), s), "lbl": lbl}, **_cots(5))
             for s in range(3)]
    run_pair(build, feeds)


def test_edit_distance_layer():
    def build(p):
        h = _data(p, "h", (3, 5), "int64")
        r = _data(p, "r", (3, 4), "int64")
        hl = _data(p, "hl", (3,), "int64")
        rl = _data(p, "rl", (3,), "int64")
        d, n = p.layers.edit_distance(h, r, input_length=hl, label_length=rl)
        return [d, n]
    rng = np.random.RandomState(3)
    _one(build, {"h": rng.randint(0, 3, (3, 5)), "r": rng.randint(0, 3,
                                                                   (3, 4)),
                 "hl": np.array([5, 2, 0]), "rl": np.array([4, 4, 1])})


def test_sampling_losses_shapes():
    """nce and sampled softmax: same ops and attrs as the JAX package,
    finite positive losses of the right shape (their draws differ)."""
    def build(p):
        x = _data(p, "x", (6, 8))
        lbl = _data(p, "lbl", (6, 1), "int64")
        return [p.layers.nce(x, lbl, 20, num_neg_samples=4),
                p.layers.sampled_softmax_with_cross_entropy(
                    p.layers.fc(x, 20), lbl, 5)]
    jmain, _, _ = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    assert [(o.type, o.attrs) for o in jmain.global_block().ops] == \
        [(o.type, o.attrs) for o in tmain.global_block().ops]
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(ptt.Scope()):
        exe.run(tstart)
        a, b = exe.run(tmain, feed={"x": _x((6, 8)), "lbl": np.arange(
            6).reshape(6, 1)}, fetch_list=tfetch)
    assert a.shape == (6, 1) and b.shape == (6, 1)
    assert np.isfinite(a).all() and (b > 0).all()


# ---- layers/vision.py ------------------------------------------------------

def test_conv3d_layers():
    def build(p):
        x = _grad_data(p, "x", (2, 3, 4, 5, 5))
        y = p.layers.conv3d(x, 4, 3, padding=1, act="relu")
        z = p.layers.conv3d_transpose(y, 2, filter_size=2, stride=2)
        return _with_grads(p, [y, z], [x] + _params(p))
    _one(build, dict({"x": _x((2, 3, 4, 5, 5))},
                     **_cots(2 * 4 * 100, 2 * 2 * 8 * 100)), tol=CONV_TOL)


def test_bilinear_and_row_conv():
    def build(p):
        x = _grad_data(p, "x", (3, 4))
        y = _grad_data(p, "y", (3, 5))
        s = _grad_data(p, "s", (2, 6, 4))
        outs = [p.layers.bilinear_tensor_product(x, y, 6, act="tanh"),
                p.layers.row_conv(s, 2)]
        return _with_grads(p, outs, [x, y, s] + _params(p))
    _one(build, dict({"x": _x((3, 4)), "y": _x((3, 5), 1),
                      "s": _x((2, 6, 4), 2)}, **_cots(18, 48)))


def test_misc_vision_layers():
    def build(p):
        x = _grad_data(p, "x", (4, 6))
        y = _grad_data(p, "y", (4, 6))
        ids = _data(p, "ids", (4, 1), "int64")
        ref = _data(p, "ref", (2, 3))
        outs = [p.layers.cos_sim(x, y), p.layers.crop(x, [2, 3], [1, 2]),
                p.layers.crop_tensor(x, ref, [2, 0]),
                p.layers.multiplex([x, y], ids)]
        return _with_grads(p, outs, [x, y])
    _one(build, dict({"x": _x((4, 6)), "y": _x((4, 6), 1),
                      "ids": np.array([[1], [0], [1], [1]]),
                      "ref": np.zeros((2, 3), np.float32)},
                     **_cots(4, 6, 6, 24)))


def test_data_norm_state():
    """The accumulators written back under their own names: three runs
    on one scope."""
    def build(p):
        x = _grad_data(p, "x", (5, 3))
        y = p.layers.data_norm(x)
        acc = [v for v in p.default_main_program().list_vars()
               if v.persistable]
        return _with_grads(p, [y], [x]) + acc
    feeds = [dict({"x": _x((5, 3), s) * 3}, **_cots(15)) for s in range(3)]
    run_pair(build, feeds)


def test_metric_layers():
    def build(p):
        inf = _data(p, "inf", (3, 8), "int64")
        lab = _data(p, "lab", (3, 8), "int64")
        ln = _data(p, "ln", (3,), "int64")
        pr = _data(p, "pr", (12,), "int64")
        lb = _data(p, "lb", (12,), "int64")
        u = _data(p, "u", (7,), "int64")
        return list(p.layers.chunk_eval(inf, lab, "IOB", 3, seq_length=ln)) \
            + list(p.layers.mean_iou(pr, lb, 4)) \
            + list(p.layers.unique(u)) \
            + list(p.layers.unique_with_counts(u))
    rng = np.random.RandomState(4)
    inf = rng.randint(0, 7, (3, 8))
    lab = inf.copy()
    lab[:, ::3] = 6
    _one(build, {"inf": inf, "lab": lab, "ln": np.array([8, 5, 2]),
                 "pr": rng.randint(0, 4, 12), "lb": rng.randint(0, 4, 12),
                 "u": np.array([4, 1, 4, 0, 1, 9, 4])}, tol=dict(rtol=0,
                                                               atol=0))


# ---- distributions, nets, layers.load -------------------------------------

def test_distributions():
    """log_prob, entropy and KL (deterministic); samples only by shape."""
    def build(p):
        v = _data(p, "v", (4, 3))
        loc = _data(p, "loc", (3,))
        sc = _data(p, "sc", (3,))
        n1, n2 = p.layers.Normal(loc, sc), p.layers.Normal(0.5, 2.0)
        un = p.layers.Uniform(-1.0, 3.0)
        cat = p.layers.Categorical(v)
        cov = p.layers.assign(np.diag([1.0, 2.0, 0.5]).astype(np.float32))
        cov2 = p.layers.assign(np.diag([0.7, 1.0, 3.0]).astype(np.float32))
        m1 = p.layers.MultivariateNormalDiag(loc, cov)
        m2 = p.layers.MultivariateNormalDiag(sc, cov2)
        return [n1.log_prob(v), n1.entropy(), n1.kl_divergence(n2),
                un.log_prob(v), un.entropy(), cat.entropy(),
                cat.log_prob(_data(p, "c", (4, 1), "int64")),
                m1.entropy(), m1.kl_divergence(m2)]
    _one(build, {"v": _x((4, 3)), "loc": _x((3,), 1),
                 "sc": np.abs(_x((3,), 2)) + 0.5,
                 "c": np.array([[0], [2], [1], [2]])})


def test_nets():
    def build(p):
        img = _grad_data(p, "img", (2, 1, 12, 12))
        seq = _grad_data(p, "seq", (2, 7, 4))
        a = p.nets.simple_img_conv_pool(img, 3, 3, 2, 2, act="relu")
        b = p.nets.img_conv_group(img, [2, 3], 2, conv_act="relu",
                                  conv_with_batchnorm=[False, True],
                                  pool_stride=2)
        c = p.nets.sequence_conv_pool(seq, 5, 3, act="tanh")
        d = p.nets.glu(seq, dim=-1)
        e = p.nets.scaled_dot_product_attention(seq, seq, seq, num_heads=2)
        return _with_grads(p, [a, b, c, d, e], [img, seq] + _params(p))
    _one(build, dict({"img": _x((2, 1, 12, 12)), "seq": _x((2, 7, 4), 1)},
                     **_cots(2 * 3 * 25, 2 * 3 * 36, 10, 28, 56)),
         tol=CONV_TOL)


def test_layers_load(tmp_path):
    """``layers.load`` (the ``load_tensor`` op) reads a saved .npy in
    both packages."""
    path = str(tmp_path / "w.npy")
    np.save(path, _x((3, 4)))

    def build(p):
        out = p.default_main_program().global_block().create_var(
            name="loaded", dtype="float32", shape=(3, 4))
        p.layers.load(out, path)
        return [p.layers.scale(out, 2.0)]
    _one(build, {})
