"""Each op the BERT training slice adds, the port against the JAX package:
the forward, and the ``grad_of`` the backward emits for it.

Every test builds the same Program through the public API of both
packages (same calls, same unique names), asks ``gradients`` for the
inputs' gradients of sum_i <out_i, cot_i> with random cotangents cot_i
fed as data (the JAX package's ``gradients(...,
target_gradients=...)`` names a gradient var it never writes, so the
cotangents enter through these products), runs the JAX Program with
``paddle_tpu.Executor(CPUPlace())`` and the port's with
``paddle_tpu_torch.Executor(CPUPlace())`` on the same numpy feeds, and
compares every fetch: outputs and gradients.

Tolerance: f32 on both sides, one op, so only the order of a sum can
differ: rtol/atol 1e-5 (2e-5 for the (16, 300) head, whose logits sum
64 products). Ops that move data (gather, top_k, fill_any_like) and the
accuracy counts must agree exactly. Dropout's mask cannot agree bit for
bit (threefry against Philox) and is held by its statistics.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as jopt

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _data(pkg, name, shape, dtype="float32"):
    """A feed var that takes part in differentiation."""
    return pkg.layers.data(name, list(shape), dtype=dtype,
                           append_batch_size=False, stop_gradient=False)


def _run(pkg, build, feed):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = build(pkg)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        out = exe.run(main, feed=feed, fetch_list=fetch)
    return main, [np.asarray(o) for o in out]


def _run_both(build, feed, exact=False, tol=TOL):
    jmain, jout = _run(pt, build, feed)
    tmain, tout = _run(ptt, build, feed)
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    for j, t in zip(jout, tout):
        assert j.shape == t.shape, (j.shape, t.shape)
        if exact:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **tol)
    return jout, tout


def _with_grads(pkg, outs, ins, cot_shapes):
    """outs + d(outs)/d(ins) under cotangents fed as ``cot<i>``: the
    gradients of sum_i <out_i, cot_i>, each inner product a ``mul`` of
    the flattened pair."""
    total = None
    for i, (o, s) in enumerate(zip(outs, cot_shapes)):
        cot = pkg.layers.data("cot%d" % i, list(s), append_batch_size=False)
        dot = pkg.layers.mul(pkg.layers.reshape(o, [1, -1]),
                             pkg.layers.reshape(cot, [-1, 1]))
        total = dot if total is None else \
            pkg.layers.elementwise_add(total, dot)
    return list(outs) + pkg.framework.backward.gradients([total], ins)


def _cot_feed(shapes, seed=10):
    return {"cot%d" % i: _x(s, seed + i) for i, s in enumerate(shapes)}


def test_sum_forward_and_grad():
    shape = (3, 4)

    def build(p):
        xs = [_data(p, "x%d" % i, shape) for i in range(3)]
        blk = p.default_main_program().global_block()
        out = blk.create_var(name="s", shape=shape, dtype="float32")
        blk.append_op("sum", inputs={"X": [x.name for x in xs]},
                      outputs={"Out": [out.name]})
        return _with_grads(p, [out], xs, [shape])
    feed = dict({"x%d" % i: _x(shape, i) for i in range(3)},
                **_cot_feed([shape]))
    _run_both(build, feed)


def test_mean_forward_and_grad():
    def build(p):
        x = _data(p, "x", (5, 7))
        return _with_grads(p, [p.layers.mean(x)], [x], [(1,)])
    _run_both(build, dict({"x": _x((5, 7))}, **_cot_feed([(1,)])))


def test_fill_any_like():
    def build(p):
        x = _data(p, "x", (2, 3))
        blk = p.default_main_program().global_block()
        outs = []
        for i, attrs in enumerate(({"value": 1.0}, {"value": 2.5},
                                   {"value": 3.0, "dtype": "int64"})):
            o = blk.create_var(name="f%d" % i, shape=(2, 3),
                               dtype=attrs.get("dtype", "float32"))
            blk.append_op("fill_any_like", inputs={"X": [x.name]},
                          outputs={"Out": [o.name]}, attrs=attrs)
            outs.append(o)
        return outs
    _run_both(build, {"x": _x((2, 3))}, exact=True)


def test_gather_forward_and_grad_with_repeated_indices():
    """Index (N, 1) as BERT's mask_pos; repeated indices sum their
    gradients."""
    idx = np.array([[3], [0], [3], [5]], np.int64)

    def build(p):
        x = _data(p, "x", (6, 4))
        i = p.layers.data("idx", [4, 1], dtype="int64",
                          append_batch_size=False)
        return _with_grads(p, [p.layers.gather(x, i)], [x], [(4, 4)])
    _run_both(build, dict({"x": _x((6, 4)), "idx": idx},
                          **_cot_feed([(4, 4)])))


def test_top_k_forward_and_grad():
    def build(p):
        x = _data(p, "x", (4, 9))
        vals, idx = p.layers.topk(x, k=3)
        return _with_grads(p, [vals], [x], [(4, 3)]) + [idx]
    _run_both(build, dict({"x": _x((4, 9))}, **_cot_feed([(4, 3)])))


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy(k):
    """accuracy(top-k) is not differentiable; its counts agree exactly."""
    label = np.array([[0], [2], [1], [2], [0], [1]], np.int64)

    def build(p):
        x = _data(p, "x", (6, 3))
        lbl = p.layers.data("label", [6, 1], dtype="int64",
                            append_batch_size=False)
        acc = p.layers.accuracy(x, lbl, k=k)
        op = p.default_main_program().global_block().ops[-1]
        return [acc, op.output("Correct")[0], op.output("Total")[0]]
    _run_both(build, {"x": _x((6, 3)), "label": label}, exact=True)


@pytest.mark.parametrize("n_class", [2, 7])
def test_softmax_with_cross_entropy_forward_and_grad(n_class):
    """The NSP head's op: Loss and Softmax and the logits' gradient under
    cotangents on both."""
    n = 5
    label = np.random.RandomState(3).randint(0, n_class, (n, 1))

    def build(p):
        logits = _data(p, "logits", (n, n_class))
        lbl = p.layers.data("label", [n, 1], dtype="int64",
                            append_batch_size=False)
        loss, soft = p.layers.softmax_with_cross_entropy(
            logits, lbl, return_softmax=True)
        return _with_grads(p, [loss, soft], [logits],
                           [(n, 1), (n, n_class)])
    feed = dict({"logits": _x((n, n_class), 0, 3.0),
                 "label": label.astype(np.int64)},
                **_cot_feed([(n, 1), (n, n_class)]))
    _run_both(build, feed)


def test_softmax_with_cross_entropy_ignore_index():
    label = np.array([[1], [-100], [0]], np.int64)

    def build(p):
        logits = _data(p, "logits", (3, 4))
        lbl = p.layers.data("label", [3, 1], dtype="int64",
                            append_batch_size=False)
        loss = p.layers.softmax_with_cross_entropy(logits, lbl)
        return _with_grads(p, [loss], [logits], [(3, 1)])
    jout, _ = _run_both(build, dict({"logits": _x((3, 4)), "label": label},
                                    **_cot_feed([(3, 1)])))
    assert jout[0][1, 0] == 0


@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_mlm_head_loss_forward_and_grad(with_bias):
    """BERT's MLM head: hidden (T, D) @ W^T + b, CE per token; gradients
    reach hidden, the (V, D) tied table and the bias."""
    t, d, v = 16, 64, 300
    label = np.random.RandomState(4).randint(0, v, (t, 1)).astype(np.int64)

    def build(p):
        h = _data(p, "h", (t, d))
        w = _data(p, "w", (v, d))
        b = _data(p, "b", (v,)) if with_bias else None
        lbl = p.layers.data("label", [t, 1], dtype="int64",
                            append_batch_size=False)
        loss = p.layers.fused_mlm_head_loss(h, w, lbl, bias=b)
        ins = [h, w] + ([b] if with_bias else [])
        return _with_grads(p, [loss], ins, [(t, 1)])
    feed = dict({"h": _x((t, d), 0), "w": _x((v, d), 1, 0.1),
                 "label": label}, **_cot_feed([(t, 1)]))
    if with_bias:
        feed["b"] = _x((v,), 2, 0.1)
    _run_both(build, feed, tol=dict(rtol=2e-5, atol=2e-5))


def test_softmax_with_cross_entropy_blockwise_route():
    """At a (T, V) the JAX package's blockwise kernel tiles (128 x 256),
    the port's op takes the blockwise-CE Function (its plain versions on
    the CPU): Loss with ignore_index rows zeroed, Softmax as
    exp(logits - lse), and the logits' gradient under cotangents on both
    (the Softmax one flows through the lse)."""
    from paddle_tpu_torch.ops import nn_ops
    n, v = 128, 256
    assert nn_ops.blockwise_kernel_would_tile(n, v)
    label = np.random.RandomState(3).randint(0, v, (n, 1))
    label[::9] = -100

    def build(p):
        logits = _data(p, "logits", (n, v))
        lbl = p.layers.data("label", [n, 1], dtype="int64",
                            append_batch_size=False)
        loss, soft = p.layers.softmax_with_cross_entropy(
            logits, lbl, return_softmax=True)
        return _with_grads(p, [loss, soft], [logits], [(n, 1), (n, v)])
    feed = dict({"logits": _x((n, v), 0, 3.0), "label": label},
                **_cot_feed([(n, 1), (n, v)]))
    _, tout = _run_both(build, feed)
    assert np.all(tout[0][::9] == 0)


@pytest.mark.parametrize("cast_bf16", [False, True])
def test_fused_mlm_head_loss_fused_route(cast_bf16):
    """At a tiling (T, V) = (128, 256) the head op takes the fused-head
    Function (its plain versions on the CPU). f32: the tolerance above;
    cast_bf16: both packages sum bf16 products in f32, but the hidden and
    weight gradients come back through bf16 (8 significant bits): 1e-2."""
    t, d, v = 128, 64, 256
    label = np.random.RandomState(4).randint(0, v, (t, 1)).astype(np.int64)

    def build(p):
        h = _data(p, "h", (t, d))
        w = _data(p, "w", (v, d))
        b = _data(p, "b", (v,))
        lbl = p.layers.data("label", [t, 1], dtype="int64",
                            append_batch_size=False)
        loss = p.layers.fused_mlm_head_loss(h, w, lbl, bias=b,
                                            cast_bf16=cast_bf16)
        return _with_grads(p, [loss], [h, w, b], [(t, 1)])
    feed = dict({"h": _x((t, d), 0), "w": _x((v, d), 1, 0.1),
                 "b": _x((v,), 2, 0.1), "label": label},
                **_cot_feed([(t, 1)]))
    tol = dict(rtol=1e-2, atol=1e-2) if cast_bf16 else \
        dict(rtol=2e-5, atol=2e-5)
    _run_both(build, feed, tol=tol)


def test_labels_outside_the_vocab_read_nothing():
    """A label outside [0, V) that is not the ignore_index: the plain
    lowering of both ops gives the lse there (the label's term 0, as the
    kernels' label hit gives it) and reads no logit out of bounds."""
    from paddle_tpu_torch.ops import nn_ops
    import torch
    h = torch.from_numpy(_x((4, 8)))
    w = torch.from_numpy(_x((10, 8), 1))
    lab = torch.tensor([[1], [-7], [3], [10]])
    logits = h @ w.t()
    lse = torch.logsumexp(logits, -1)
    out = nn_ops._fused_mlm_head_loss(
        None, {"Hidden": [h], "Weight": [w], "Label": [lab]}, {})["Loss"]
    np.testing.assert_allclose(out[[1, 3], 0].numpy(), lse[[1, 3]].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(out[[0, 2], 0].numpy(),
                               (lse - logits[[0, 1, 2, 3], lab[:, 0].clamp(
                                   0, 9)])[[0, 2]].numpy(), rtol=1e-6)
    ce = nn_ops._softmax_with_cross_entropy(
        None, {"Logits": [logits], "Label": [lab]}, {})["Loss"]
    np.testing.assert_allclose(ce[:, 0].numpy(), out[:, 0].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 5), (40, 64)])
def test_adam_op_three_steps(shape):
    """Optimizer.apply_gradients appends the adam op; three updates under
    fed gradients move the parameter, both moments and both beta powers
    the same way (the port's fused kernel's plain version on the CPU,
    the JAX package's XLA chain)."""
    def build(p):
        w = p.layers.create_parameter(
            list(shape), "float32", name="w",
            default_initializer=p.initializer.Constant(0.5))
        g = p.layers.data("g", list(shape), append_batch_size=False)
        opt = (jopt if p is pt else ptt.optimizer).Adam(0.01)
        opt.apply_gradients([(w, g)])
        return sorted(v.name for v in p.default_main_program().list_vars()
                      if v.persistable)
    results = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            names = build(pkg)
        assert [op.type for op in main.global_block().ops] == ["adam"]
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            for step in range(3):
                exe.run(main, feed={"g": _x(shape, step)})
            results.append((names, [np.asarray(scope.find_var(n))
                                    for n in names]))
    (jn, jv), (tn, tv) = results
    assert jn == tn and len(jn) == 6
    for j, t in zip(jv, tv):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_adam_op_lazy_mode_keeps_untouched_rows():
    """An adam op with ``lazy_mode`` (an embedding table's update) takes
    the plain chain in both packages: rows whose gradient is all zero keep
    their parameter and moments; the others move as in plain Adam. Same
    tolerance as above."""
    shape = (8, 5)
    # rows 2, 5 and 7 never get a gradient; 0, 1 and 3 skip one step
    zero_rows = ([1, 2, 5, 7], [2, 3, 5, 7], [0, 2, 5, 7])

    def grad(step):
        g = _x(shape, step)
        g[zero_rows[step]] = 0.0
        return g
    results = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            w = pkg.layers.create_parameter(
                list(shape), "float32", name="w",
                default_initializer=pkg.initializer.Constant(0.5))
            g = pkg.layers.data("g", list(shape), append_batch_size=False)
            (jopt if pkg is pt else ptt.optimizer).Adam(0.01).apply_gradients(
                [(w, g)])
        op, = main.global_block().ops
        op.attrs["lazy_mode"] = True
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            for step in range(3):
                exe.run(main, feed={"g": grad(step)})
            results.append([np.asarray(scope.find_var(n)) for n in names])
    jv, tv = results
    never = np.isin(np.arange(shape[0]), [2, 5, 7])
    w_port = tv[names.index("w")]
    np.testing.assert_array_equal(w_port[never], 0.5)
    assert np.all(w_port[~never] != 0.5)
    for j, t in zip(jv, tv):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def _dropout_prog(p_drop, shape, impl="upscale_in_train"):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = _data(ptt, "x", shape)
        y = ptt.layers.dropout(x, p_drop, dropout_implementation=impl)
        grads = _with_grads(ptt, [y], [x], [shape])
    mask = main.global_block().ops[0].output("Mask")[0]
    return main, grads + [mask]


@pytest.mark.parametrize("p_drop", [0.1, 0.5])
def test_training_dropout_statistics_and_backward(p_drop):
    """The keep rate is 1 - p within 4 standard deviations, kept values
    are exactly x / (1 - p), dropped ones exactly 0, and the backward
    reuses the forward's mask (the gradient is cot / (1 - p) where kept
    and 0 where dropped)."""
    shape = (200, 300)
    main, fetch = _dropout_prog(p_drop, shape)
    x = _x(shape, 0) + 3.0
    cot = _x(shape, 1)
    y, dx, mask = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x, "cot0": cot}, fetch_list=fetch,
        scope=ptt.Scope())
    keep = mask.astype(bool)
    n, q = keep.size, 1.0 - p_drop
    assert abs(keep.mean() - q) < 4 * np.sqrt(q * (1 - q) / n)
    np.testing.assert_array_equal(y[keep], (x / np.float32(q))[keep])
    assert np.all(y[~keep] == 0)
    np.testing.assert_array_equal(dx[keep], (cot / np.float32(q))[keep])
    assert np.all(dx[~keep] == 0)


def test_training_dropout_downgrade_keeps_values_unscaled():
    main, fetch = _dropout_prog(0.3, (50, 40), "downgrade_in_infer")
    x = _x((50, 40), 2) + 3.0
    y, _, mask = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": x, "cot0": _x((50, 40), 3)}, fetch_list=fetch,
        scope=ptt.Scope())
    keep = mask.astype(bool)
    np.testing.assert_array_equal(y[keep], x[keep])
    assert np.all(y[~keep] == 0)


def test_training_dropout_draws_differ_by_run_and_by_op():
    """Each run draws a new mask (the scope's run counter salts the
    generator) and two dropout ops in one run draw different masks."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = _data(ptt, "x", (64, 64))
        a = ptt.layers.dropout(x, 0.5)
        b = ptt.layers.dropout(x, 0.5)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    x = np.ones((64, 64), np.float32)
    a1, b1 = exe.run(main, feed={"x": x}, fetch_list=[a, b], scope=scope)
    a2, = exe.run(main, feed={"x": x}, fetch_list=[a], scope=scope)
    assert not np.array_equal(a1, b1)
    assert not np.array_equal(a1, a2)


def test_layer_norm_mean_gradient_waits_for_a_later_slice():
    """The port's LayerNorm kernels give Mean and Variance no gradient;
    a program that differentiates through them is refused."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = _data(ptt, "x", (4, 8))
        ptt.layers.layer_norm(x)
        mean = main.global_block().ops[-1].output("Mean")[0]
        mean_var = main.global_block().var(mean)
        grads = ptt.framework.backward.gradients([mean_var], [x])
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(ptt.NotPortedError, match="Mean"):
        exe.run(main, feed={"x": _x((4, 8))}, fetch_list=grads, scope=scope)


@pytest.mark.parametrize("t,v", [(256, 1024), (640, 32000)])
def test_head_and_ce_run_plain_on_cpu_where_the_kernel_would_tile(t, v):
    """The guard reads the device: on a CPU tensor the plain lowering is
    the port's CPU path at every shape, so a GPT-sized head runs here."""
    from paddle_tpu_torch.ops import nn_ops
    import torch
    assert nn_ops.blockwise_kernel_would_tile(t, v)
    logits = torch.zeros(t, v)
    label = torch.zeros(t, 1, dtype=torch.int64)
    out = nn_ops._softmax_with_cross_entropy(
        None, {"Logits": [logits], "Label": [label]}, {})
    assert out["Loss"].shape == (t, 1)
    np.testing.assert_allclose(out["Loss"].numpy(), np.log(v), rtol=1e-6)


def test_optimizer_refuses_what_a_later_slice_brings():
    """Regularization and gradient clipping arrived with the optimizer
    slice (tests/test_torch_clip_regularizer.py holds them) and the four
    averaging wrappers with the training-state slice
    (tests/test_torch_averaging.py); ``PipelineOptimizer`` comes with the
    pipelines and is not in the port's optimizer module yet."""
    opt = ptt.optimizer.Adam(0.1, regularization=ptt.regularizer.L2Decay(
        1e-4), grad_clip=ptt.clip.GradientClipByGlobalNorm(1.0))
    assert opt.regularization is not None and opt._grad_clip is not None
    for name in ("ExponentialMovingAverage", "LookaheadOptimizer",
                 "ModelAverage", "RecomputeOptimizer"):
        assert hasattr(ptt.optimizer, name), name
    assert not hasattr(ptt.optimizer, "PipelineOptimizer")


def test_gradients_reads_the_given_target_gradient():
    """``gradients(targets, inputs, target_gradients)`` seeds the backward
    with the given cotangent. (The JAX package names target@GRAD instead,
    a var nothing writes, and its verifier refuses the program: ROADMAP.md
    Queue 3.)"""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = _data(ptt, "x", (3, 4))
        y = ptt.layers.scale(x, scale=3.0, bias=1.0)
        cot = ptt.layers.data("cot", [3, 4], append_batch_size=False)
        dx, = ptt.gradients([y], [x], [cot])
    feed = {"x": _x((3, 4)), "cot": _x((3, 4), 1)}
    got, = ptt.Executor(ptt.CPUPlace()).run(main, feed=feed, fetch_list=[dx],
                                             scope=ptt.Scope())
    np.testing.assert_allclose(got, 3.0 * feed["cot"], rtol=1e-6)
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        jx = _data(pt, "x", (3, 4))
        jy = pt.layers.scale(jx, scale=3.0, bias=1.0)
        jcot = pt.layers.data("cot", [3, 4], append_batch_size=False)
        pt.framework.backward.gradients([jy], [jx], [jcot])
    grad_op = jmain.global_block().ops[-1]
    assert grad_op.input("OG:Out") == [jy.name + "@GRAD"]
    assert not any(jy.name + "@GRAD" in op.output_names()
                   for op in jmain.global_block().ops)
