"""ResNet's ops and model: the port against the JAX package.

Each op is built through the public ``layers`` API of both packages
(same calls, same unique names), run with each package's
``Executor(CPUPlace())`` on the same numpy feeds, with the JAX startup's
persistables (and, where a case says so, moving statistics drawn from a
seed) copied into the port by ``set_params_from_numpy``. Values and
gradients (``gradients`` of sum_i <out_i, cot_i>, the cotangents fed as
data) are compared.

Tolerances: one f32 op, so only the order of a sum differs (a
convolution's C*k*k products, a batch statistic's N*H*W terms): rtol
1e-5, atol 1e-5 (atol 2e-5 for the convolution's filter gradient, which
sums N*H*W products of O(1) terms). Pooling and relu move data: exact.
The narrow ResNet's three Momentum steps go through five convolutions
and batch norms a step: losses rtol 1e-5, final parameters, velocities
and moving statistics rtol 1e-4, atol 1e-5 (batch norm divides by a
batch standard deviation, so a 1e-7 difference in a small variance
grows there).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import blockwise_ce as tce
from test_torch_bert_training import _normalized
from test_torch_ops import _build, _cots, _grad_data, _with_grads, _x

TOL = dict(rtol=1e-5, atol=1e-5)


def run_pair(build, feeds, state=None, tol=TOL, exact=False):
    """Build with both packages, start both from the JAX startup's
    persistables (``state`` overriding some), run each feed of ``feeds``
    in turn on one scope per package and compare every fetch of every
    run. Returns (the port's fetches of the last run, the two programs,
    the two scopes)."""
    jmain, jstart, jfetch = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jmain.list_vars() if v.persistable}
    params.update(state or {})
    for name, arr in (state or {}).items():
        jscope.set_var(name, jnp.asarray(arr))
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(params, tmain, tscope, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    for feed in feeds:
        with pt.scope_guard(jscope):
            jout = jexe.run(jmain, feed=feed, fetch_list=jfetch)
        with ptt.scope_guard(tscope):
            tout = texe.run(tmain, feed=feed, fetch_list=tfetch)
        for j, t in zip(jout, tout):
            j = np.asarray(j)
            assert j.shape == t.shape
            if exact:
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, **tol)
    return tout, (jmain, tmain), (jscope, tscope)


def _op(p, op_type):
    """The last op of ``op_type`` in the global block being built."""
    return [o for o in p.default_main_program().global_block().ops
            if o.type == op_type][-1]


def _param(p, op, slot):
    return p.default_main_program().global_block().var(op.input(slot)[0])


@pytest.mark.parametrize("stride,padding,groups,dilation,depthwise", [
    (1, 0, 1, 1, False),          # a bottleneck's 1x1
    (2, 3, 1, 1, False),          # the stem's 7x7 s2 p3
    (2, 1, 1, 1, False),          # a stage's first 3x3 s2 p1
    (1, 2, 2, 2, False),          # groups and dilation
    (1, 1, 4, 1, True),           # depthwise (groups == channels)
])
def test_conv2d(stride, padding, groups, dilation, depthwise):
    """Output and the gradients to the input and the filter."""
    k = 7 if padding == 3 else (1 if padding == 0 else 3)
    shape = (2, 4, 9, 9)

    def build(p):
        x = _grad_data(p, "x", shape)
        y = p.layers.conv2d(x, 4 if depthwise else 6, k, stride=stride,
                            padding=padding, dilation=dilation,
                            groups=groups, bias_attr=False)
        op = _op(p, "conv2d")
        if depthwise:
            op.type = "depthwise_conv2d"
        return _with_grads(p, [y], [x, _param(p, op, "Filter")])
    oh = (9 + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    n_out = 2 * (4 if depthwise else 6) * oh * oh
    run_pair(build, [dict({"x": _x(shape)}, **_cots(n_out))],
             tol=dict(rtol=1e-5, atol=2e-5))


@pytest.mark.parametrize("case", [
    "max_3x3_s2_p1", "global_avg", "global_max", "avg_exclusive_p1",
    "avg_inclusive_p1", "max_wide_pad", "avg_exclusive_wide_pad",
    "adaptive_avg", "relu_then_max"])
def test_pool2d(case):
    """Output and the gradient to the input. ``relu_then_max``: ResNet's
    stem, where whole windows are zeros after the relu; which zero the
    max picks must not matter, since relu's gradient at 0 is 0 in both
    packages. The wide paddings (beyond half the window) take the port's
    explicit padding."""
    shape = (2, 3, 8, 8)
    kwargs = {
        "max_3x3_s2_p1": dict(pool_size=3, pool_type="max", pool_stride=2,
                              pool_padding=1),
        "global_avg": dict(global_pooling=True, pool_type="avg"),
        "global_max": dict(global_pooling=True, pool_type="max"),
        "avg_exclusive_p1": dict(pool_size=3, pool_type="avg",
                                 pool_stride=2, pool_padding=1),
        "avg_inclusive_p1": dict(pool_size=3, pool_type="avg",
                                 pool_stride=2, pool_padding=1,
                                 exclusive=False),
        "max_wide_pad": dict(pool_size=3, pool_type="max", pool_stride=1,
                             pool_padding=2),
        "avg_exclusive_wide_pad": dict(pool_size=3, pool_type="avg",
                                       pool_stride=2, pool_padding=2),
        "relu_then_max": dict(pool_size=3, pool_type="max", pool_stride=2,
                              pool_padding=1),
    }.get(case)
    x = _x(shape)
    if case == "relu_then_max":
        x = x - 1.5                  # most of it below 0

    def build(p):
        xv = _grad_data(p, "x", shape)
        src = p.layers.relu(xv) if case == "relu_then_max" else xv
        if case == "adaptive_avg":
            y = p.layers.adaptive_pool2d(src, 2, pool_type="avg")
        else:
            y = p.layers.pool2d(src, **kwargs)
        return _with_grads(p, [y], [xv])
    exact = case.startswith(("max", "global_max", "relu"))
    out, _, _ = run_pair(build, [dict({"x": x}, **_cots(
        int(np.prod(_build(pt, build)[2][0].shape))))], exact=exact)
    if case == "relu_then_max":
        assert (out[0] == 0).mean() > 0.2 and (out[1] != 0).any()


def test_adaptive_pool_refuses_sizes_that_do_not_divide():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        y = ptt.layers.adaptive_pool2d(
            ptt.layers.data("x", [3, 5, 5]), 2, pool_type="avg")
    with pytest.raises(NotImplementedError, match="divisible"):
        ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"x": _x((1, 3, 5, 5))}, fetch_list=[y],
            scope=ptt.Scope())


@pytest.mark.parametrize("mode", ["train_nchw", "train_nhwc", "test",
                                  "use_global_stats", "train_relu"])
def test_batch_norm(mode):
    """Y, MeanOut, VarianceOut, SavedMean, SavedVariance, and the
    gradients to X, Scale and Bias, from moving statistics drawn from a
    seed (variance positive). Training mode updates the moving stats as
    ``stat * 0.9 + batch * 0.1`` with the biased batch variance."""
    layout = "NHWC" if mode == "train_nhwc" else "NCHW"
    shape = (4, 5, 6, 3) if layout == "NHWC" else (4, 3, 5, 6)
    c = 3
    names = {}

    def build(p):
        x = _grad_data(p, "x", shape)
        y = p.layers.batch_norm(
            x, is_test=mode == "test", data_layout=layout,
            use_global_stats=mode == "use_global_stats",
            act="relu" if mode == "train_relu" else None)
        op = _op(p, "batch_norm")
        names["mean"], names["var"] = op.input("Mean")[0], \
            op.input("Variance")[0]
        outs = [y] + [op.output(s)[0] for s in (
            "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")]
        return _with_grads(p, [y], [x, _param(p, op, "Scale"),
                                    _param(p, op, "Bias")]) + outs[1:]
    _build(pt, build)
    rng = np.random.RandomState(3)
    state = {names["mean"]: rng.randn(c).astype(np.float32),
             names["var"]: (rng.rand(c) + 0.5).astype(np.float32)}
    x = _x(shape) * 2 + 0.5
    out, _, _ = run_pair(build, [dict({"x": x}, **_cots(x.size))],
                         state=state)
    if mode in ("test", "use_global_stats"):
        np.testing.assert_array_equal(out[4], state[names["mean"]])
    else:
        axes = (0, 1, 2) if layout == "NHWC" else (0, 2, 3)
        np.testing.assert_allclose(out[7], x.var(axis=axes), rtol=1e-5)
        np.testing.assert_allclose(
            out[5], state[names["var"]] * 0.9 + x.var(axis=axes) * 0.1,
            rtol=1e-5)


def test_batch_norm_moving_stats_accumulate_over_runs():
    """Two runs on one scope: the second reads the moving stats the first
    wrote back into the persistables."""
    shape = (2, 3, 4, 4)

    def build(p):
        y = p.layers.batch_norm(p.layers.data(
            "x", list(shape), append_batch_size=False))
        op = _op(p, "batch_norm")
        return [y, op.output("MeanOut")[0], op.output("VarianceOut")[0]]
    out, _, _ = run_pair(build, [{"x": _x(shape)}, {"x": _x(shape, 1)}])
    axes = (0, 2, 3)
    want = (0.0 * 0.9 + _x(shape).mean(axis=axes) * 0.1) * 0.9 + \
        _x(shape, 1).mean(axis=axes) * 0.1
    np.testing.assert_allclose(out[1], want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    shape = (3, 4, 5)

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.softmax(x, axis=axis)], [x])
    run_pair(build, [dict({"x": _x(shape) * 3}, **_cots(60))])


def test_resnet_loss_takes_the_plain_lowering(monkeypatch):
    """ResNet's 1000-class loss: the JAX package's blockwise-CE rule
    declines V = 1000 (the 512 block halves to 128, which does not divide
    1000, and on down), so the op never reaches the CE kernels."""
    assert tnn.fit_blocks(128, 1000, 128, 512) is None
    assert not tnn.blockwise_kernel_would_tile(128, 1000)

    def refuse(*args):
        raise AssertionError("the CE kernels' Function was called")
    monkeypatch.setattr(tce.BlockwiseCE, "apply", refuse)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        logits = ptt.layers.data("logits", [128, 1000],
                                 append_batch_size=False)
        label = ptt.layers.data("label", [128, 1], dtype="int64",
                                append_batch_size=False)
        loss = ptt.layers.softmax_with_cross_entropy(logits, label)
    lbl = np.random.RandomState(0).randint(0, 1000, (128, 1))
    out, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"logits": _x((128, 1000)), "label": lbl},
        fetch_list=[loss], scope=ptt.Scope())
    assert out.shape == (128, 1) and np.isfinite(out).all()


def _train_program(pkg, resnet_mod, is_test=False):
    return resnet_mod.resnet_train_program(
        depth=50, optimizer_fn=None if is_test else
        lambda loss: pkg.optimizer.Momentum(0.1, 0.9).minimize(loss),
        is_test=is_test)


@pytest.mark.parametrize("is_test", [False, True])
def test_resnet50_programs_are_the_jax_packages(is_test):
    """resnet_train_program(depth=50) (bench.py's, with Momentum(0.1,
    0.9)) builds the same program in both packages: op types and order,
    attrs, vars and their shapes, persistables; so does its startup.
    Nothing runs."""
    progs = []
    for pkg, mod in ((pt, jresnet), (ptt, tresnet)):
        with pkg.unique_name.guard():
            progs.append(_train_program(pkg, mod, is_test))
    (jmain, jstart, jfeeds, _), (tmain, tstart, tfeeds, _) = progs
    assert jfeeds == tfeeds
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    persist = [{(v.name, tuple(v.shape), v.dtype) for v in m.list_vars()
                if v.persistable} for m in (jmain, tmain)]
    assert persist[0] == persist[1]
    assert _normalized(jmain) == _normalized(tmain)
    assert _normalized(jstart) == _normalized(tstart)
    if not is_test:
        ops = [op.type for op in tmain.global_block().ops]
        assert ops.count("conv2d") == 53 and ops.count("batch_norm") == 53
        assert ops.count("momentum") == 161


def test_clone_for_test_turns_batch_norm_to_test_mode():
    main, _, _, _ = _train_program(ptt, tresnet)
    test = main.clone(for_test=True)
    bns = [op for op in test.global_block().ops if op.type == "batch_norm"]
    assert len(bns) == 53 and all(op.attrs["is_test"] for op in bns)
    assert not any(op.attrs["is_test"] for op in main.global_block().ops
                   if op.type == "batch_norm")
    assert "momentum" not in {op.type for op in test.global_block().ops}


NARROW_SHAPE, NARROW_BATCH, NARROW_CLASSES, NARROW_STEPS = (3, 16, 16), 4, \
    10, 3


def narrow_resnet(pkg, mod, is_test=False):
    """The narrow ResNet: the stem's conv_bn_layer (8 filters, 3x3 s2),
    the max pool, two bottleneck_blocks of 8 filters (the first with a
    projection shortcut, the second with stride 2), global average pool,
    an fc head; fetches [loss, top-1 accuracy] of the softmax CE with
    Momentum(0.1, 0.9), or [softmax of the logits] with ``is_test``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        image = pkg.layers.data("image", list(NARROW_SHAPE))
        label = pkg.layers.data("label", [1], dtype="int64")
        x = mod.conv_bn_layer(image, 8, 3, stride=2, act="relu",
                              name="conv1", is_test=is_test)
        x = pkg.layers.pool2d(x, 3, "max", 2, 1)
        x = mod.bottleneck_block(x, 8, 1, "res2a", is_test=is_test)
        x = mod.bottleneck_block(x, 8, 2, "res2b", is_test=is_test)
        pool = pkg.layers.pool2d(x, global_pooling=True, pool_type="avg")
        pool = pkg.layers.reshape(pool, [0, pool.shape[1]])
        logits = pkg.layers.fc(pool, NARROW_CLASSES,
                               param_attr=pkg.ParamAttr(name="fc_0.w_0"),
                               bias_attr=pkg.ParamAttr(name="fc_0.b_0"))
        if is_test:
            return main, startup, [pkg.layers.softmax(logits)]
        loss, softmax = pkg.layers.softmax_with_cross_entropy(
            logits, label, return_softmax=True)
        loss = pkg.layers.mean(loss)
        acc = pkg.layers.accuracy(softmax, label, k=1)
        pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, [loss, acc]


def narrow_feed():
    """One batch from a seed; the three steps train on it."""
    rng = np.random.RandomState(7)
    return {"image": rng.rand(NARROW_BATCH, *NARROW_SHAPE).astype(
                np.float32),
            "label": rng.randint(0, NARROW_CLASSES, (NARROW_BATCH, 1))
            .astype(np.int64)}


def test_narrow_resnet_trains_like_jax():
    """Three Momentum steps from the JAX startup's weights: losses and
    accuracies every step, then every persistable (parameters,
    velocities, batch-norm moving stats) against the JAX scope."""
    jmain, jstart, jfetch = narrow_resnet(pt, jresnet)
    tmain, tstart, tfetch = narrow_resnet(ptt, tresnet)
    assert _normalized(jmain) == _normalized(tmain)
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    ptt.set_params_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persist}, tmain, tscope,
        ptt.CPUPlace())
    losses = []
    feed = narrow_feed()
    for _ in range(NARROW_STEPS):
        with pt.scope_guard(jscope):
            jl, ja = jexe.run(jmain, feed=feed, fetch_list=jfetch)
        with ptt.scope_guard(tscope):
            tl, ta = texe.run(tmain, feed=feed, fetch_list=tfetch)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_array_equal(ta, ja)
        losses.append(float(tl.reshape(())))
    assert losses[-1] < losses[0]
    kinds = {"velocity": 0, "_bn_mean": 0, "_bn_variance": 0}
    for n in persist:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
        for k in kinds:
            kinds[k] += k in n
    assert kinds == {"velocity": 29, "_bn_mean": 9, "_bn_variance": 9}


def test_narrow_resnet_serves_like_jax(tmp_path):
    """The narrow ResNet with ``is_test=True``, its softmax saved with
    ``save_inference_model`` from the port and served through
    ``create_predictor`` on the CPU, against the JAX Executor on the same
    weights and moving stats (drawn from a seed)."""
    jmain, jstart, jfetch = narrow_resnet(pt, jresnet, is_test=True)
    tmain, tstart, tfetch = narrow_resnet(ptt, tresnet, is_test=True)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        pt.Executor(pt.CPUPlace()).run(jstart)
    rng = np.random.RandomState(11)
    arrays = {}
    for v in jmain.list_vars():
        if v.persistable:
            a = np.asarray(jscope.find_var(v.name))
            if v.name.endswith("_bn_mean"):
                a = rng.randn(*a.shape).astype(np.float32) * 0.1
            elif v.name.endswith("_bn_variance"):
                a = (rng.rand(*a.shape) + 0.5).astype(np.float32)
            arrays[v.name] = a
            jscope.set_var(v.name, jnp.asarray(a))
    image = narrow_feed()["image"]
    with pt.scope_guard(jscope):
        want, = pt.Executor(pt.CPUPlace()).run(
            jmain, feed={"image": image}, fetch_list=jfetch)
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(arrays, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(str(tmp_path), ["image"], tfetch,
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=tmain)
    config = ptt.inference.Config(str(tmp_path))
    config.place = ptt.CPUPlace()
    got, = ptt.inference.create_predictor(config).run({"image": image})
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
