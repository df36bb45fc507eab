"""Each op of the BERT serving slice and of the GPT slice, the port
against the JAX package.

Every test builds a one-op Program through the public ``layers`` API of
both packages (same calls, same unique names), runs the JAX Program with
``paddle_tpu.Executor(CPUPlace())``, copies the JAX scope's parameters
into the port with ``set_params_from_numpy`` and runs the port's Program
with ``paddle_tpu_torch.Executor(CPUPlace())`` on the same numpy feeds.
The GPT slice's ops are also differentiated: ``gradients`` of
sum_i <out_i, cot_i> under cotangents fed as data, compared the same way.

Tolerance: f32 on both sides, one op, so only the order of a sum can
differ: rtol/atol 1e-5. Ops that move data (reshape, transpose, slice,
lookup, cast, fill) must agree exactly. The random init ops cannot agree
value for value (threefry against Philox) and are held by statistics.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = build(pkg)
    return main, startup, fetch


def _run_both(build, feed, exact=False):
    """Build with both packages, run, compare every fetch; returns the
    (jax, port) fetch lists."""
    jmain, jstart, jfetch = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        jout = exe.run(jmain, feed=feed, fetch_list=jfetch)
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jmain.list_vars() if v.persistable}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(params, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                                 fetch_list=tfetch)
    for j, t in zip(jout, tout):
        j = np.asarray(j)
        assert j.shape == t.shape
        if exact:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **TOL)
    return jout, tout


def _data(pkg, name, shape, dtype="float32"):
    return pkg.layers.data(name, shape, dtype=dtype, append_batch_size=False)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_mul():
    feed = {"x": _x((2, 3, 4)), "y": _x((4, 5), 1)}
    _run_both(lambda p: [p.layers.mul(_data(p, "x", [2, 3, 4]),
                                      _data(p, "y", [4, 5]),
                                      x_num_col_dims=2)], feed)


@pytest.mark.parametrize("yshape,axis", [((4,), -1), ((3,), 1),
                                         ((2, 3, 4), -1), ((3, 4), 1)])
def test_elementwise_add(yshape, axis):
    feed = {"x": _x((2, 3, 4)), "y": _x(yshape, 1)}
    _run_both(lambda p: [p.layers.elementwise_add(
        _data(p, "x", [2, 3, 4]), _data(p, "y", list(yshape)), axis=axis)],
        feed)


@pytest.mark.parametrize("begin,scale,shift", [(1, True, True),
                                               (2, True, True),
                                               (2, False, False)])
def test_layer_norm(begin, scale, shift):
    """Y, Mean and Variance; the port's Variance comes from the
    kernel's rstd (1/rstd^2 - eps)."""
    feed = {"x": _x((2, 3, 16)) * 2 + 1}

    def build(p):
        x = _data(p, "x", [2, 3, 16])
        y = p.layers.layer_norm(x, scale=scale, shift=shift,
                                begin_norm_axis=begin)
        op = p.default_main_program().global_block().ops[-1]
        return [y, op.output("Mean")[0], op.output("Variance")[0]]
    _run_both(build, feed)


@pytest.mark.parametrize("impl", ["auto", "flash", "xla"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_scaled_dot_product_attention(with_mask, causal, impl):
    b, h, tq, tk, d = 2, 2, 8, 12, 16
    mask = np.zeros((b, 1, 1, tk), np.float32)
    mask[1, ..., 8:] = -1e4
    feed = {"q": _x((b, h, tq, d)), "k": _x((b, h, tk, d), 1),
            "v": _x((b, h, tk, d), 2), "mask": mask}

    def build(p):
        q = _data(p, "q", [b, h, tq, d])
        k = _data(p, "k", [b, h, tk, d])
        v = _data(p, "v", [b, h, tk, d])
        m = _data(p, "mask", [b, 1, 1, tk]) if with_mask else None
        return [p.layers.fused_attention(q, k, v, mask=m, scale=0.3,
                                         causal=causal, impl=impl)]
    _run_both(build, feed)


def test_sequence_parallel_attention_waits_for_the_multi_gpu_slice():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        q = _data(ptt, "q", [1, 2, 4, 8])
        out = tl.fused_attention(q, q, q, impl="ring")
    with pytest.raises(ptt.NotPortedError, match="multi-GPU"):
        ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"q": _x((1, 2, 4, 8))}, fetch_list=[out],
            scope=ptt.Scope())


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_lookup_table(padding_idx):
    ids = np.random.RandomState(0).randint(0, 10, (2, 5, 1)).astype(np.int64)
    ids[0, :3, 0] = [3, 8, 3]
    _run_both(lambda p: [p.layers.embedding(
        _data(p, "ids", [2, 5, 1], "int64"), [10, 6],
        padding_idx=padding_idx)], {"ids": ids}, exact=True)


def test_shape_ops():
    """transpose2, reshape2 (0 copies a dim, -1 infers one), unsqueeze2
    and slice (negative and clipped bounds), as BERT uses them."""
    def build(p):
        x = _data(p, "x", [2, 3, 4])
        return [p.layers.transpose(x, [0, 2, 1]),
                p.layers.reshape(x, [0, -1, 2]),
                p.layers.unsqueeze(x, [1]),
                p.layers.unsqueeze(x, [0, 3]),
                p.layers.slice(x, axes=[1], starts=[0], ends=[1]),
                p.layers.slice(x, axes=[1, 2], starts=[-2, 1],
                               ends=[100, -1])]
    _run_both(build, {"x": _x((2, 3, 4))}, exact=True)


@pytest.mark.parametrize("after", [True, False])
def test_scale(after):
    _run_both(lambda p: [p.layers.scale(_data(p, "x", [3, 4]), scale=1e4,
                                        bias=-1e4, bias_after_scale=after)],
              {"x": _x((3, 4))})


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_is_test(impl):
    _run_both(lambda p: [p.layers.dropout(_data(p, "x", [3, 4]), 0.3,
                                          is_test=True,
                                          dropout_implementation=impl)],
              {"x": _x((3, 4))})


def test_dropout_with_zero_probability_is_identity():
    _run_both(lambda p: [p.layers.dropout(_data(p, "x", [3, 4]), 0.0)],
              {"x": _x((3, 4))}, exact=True)


def test_training_dropout_waits_for_the_training_slice():
    """The training slice has arrived: dropout with is_test=False draws
    its mask from the op's seeded generator and runs (its statistics are
    held in tests/test_torch_training_ops.py); the same scope and seed
    repeat the draw."""
    x = _x((64, 64)) + 5.0
    draws = []
    for _ in range(2):
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            y = tl.dropout(_data(ptt, "x", [64, 64]), 0.25,
                           dropout_implementation="upscale_in_train")
        out, = ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=[y], scope=ptt.Scope())
        draws.append(out)
    kept = draws[0] != 0
    assert 0.6 < kept.mean() < 0.9
    np.testing.assert_array_equal(draws[0][kept],
                                  (x / np.float32(0.75))[kept])
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.parametrize("op_type,role", [("grad_of", "backward"),
                                          ("sgd", "optimize")])
def test_executor_refuses_training_programs(op_type, role):
    """The Executor refuses, before any op runs, a program holding an
    optimizer op not ported yet (sgd). A grad_of whose forward op is not
    in the program (a pruned program; refused before bf16 training and
    recompute were ported) re-runs that forward from the inputs it
    carries, as the JAX package's Executor does."""
    if op_type == "grad_of":
        _grad_of_reruns_its_missing_forward()
        return
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        y = tl.scale(_data(ptt, "x", [3, 4]), scale=2.0)
    main.global_block().append_op(op_type, inputs={"X": [y.name]},
                                  outputs={"Out": [y.name]},
                                  attrs={"op_role": role})
    scope = ptt.Scope()
    with pytest.raises(ptt.NotPortedError, match="not ported"):
        ptt.Executor(ptt.CPUPlace()).run(main, feed={"x": _x((3, 4))},
                                         fetch_list=[y], scope=scope)
    assert not list(scope.keys())


def _grad_of_reruns_its_missing_forward():
    """d<x*y, cot>/d(x, y) with the elementwise_mul op taken out of the
    program and its output fed instead: its grad_of re-runs it."""
    def build(p):
        x, y = _grad_data(p, "x", (3, 4)), _grad_data(p, "y", (3, 4))
        out = p.layers.elementwise_mul(x, y)
        fetch = _with_grads(p, [out], [x, y])[1:]
        blk = p.default_main_program().global_block()
        fwd, = [op for op in blk.ops if op.type == "elementwise_mul"]
        blk.ops.remove(fwd)
        return fetch + [out]
    x, y, cot = _x((3, 4)), _x((3, 4), 1), _cots(12)["cot0"]
    feed = {"x": x, "y": y, "cot0": cot}
    jmain, jstart, jfetch = _build(pt, build)
    tmain, _, tfetch = _build(ptt, build)
    assert "elementwise_mul" not in [op.type for op in
                                     tmain.global_block().ops]
    feed[tfetch[-1].name] = x * y
    with pt.scope_guard(pt.Scope()):
        want = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                              fetch_list=jfetch[:2])
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=tfetch[:2],
                                           scope=ptt.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    np.testing.assert_allclose(got[0], cot.reshape(3, 4) * y, **TOL)
    np.testing.assert_allclose(got[1], cot.reshape(3, 4) * x, **TOL)


def test_activations():
    """gelu (exact erf, as BERT's act="gelu" emits it), gelu with
    approximate=True (tanh form, appended through the Program API since
    the layer takes no attrs) and tanh."""
    def build(p):
        x = _data(p, "x", [4, 8])
        blk = p.default_main_program().global_block()
        approx = blk.create_var(name="gelu_tanh", shape=(4, 8),
                                dtype="float32")
        blk.append_op("gelu", inputs={"X": [x.name]},
                      outputs={"Out": [approx.name]},
                      attrs={"approximate": True})
        return [p.layers.gelu(x), approx, p.layers.tanh(x)]
    _run_both(build, {"x": _x((4, 8)) * 3})


@pytest.mark.parametrize("src,dst", [("float32", "int64"),
                                     ("int64", "float32"),
                                     ("float32", "float16")])
def test_cast(src, dst):
    x = (_x((3, 4)) * 5).astype(src)
    _run_both(lambda p: [p.layers.cast(_data(p, "x", [3, 4], src), dst)],
              {"x": x}, exact=True)


def test_fill_constant():
    _run_both(lambda p: [p.layers.fill_constant([2, 3], "float32", 2.5),
                         p.layers.fill_constant([4], "int64", 7)], {},
              exact=True)


def _init_param(pkg, init, shape, random_seed):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = random_seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        w = pkg.layers.create_parameter(shape, "float32", name="w",
                                        default_initializer=init)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(startup)
    assert len(startup.global_block().ops) == 1
    return np.asarray(scope.find_var(w.name)), startup


def test_truncated_gaussian_random_statistics():
    """N(loc, scale) truncated at 2 scales: both packages' draws lie in
    the bounds and have the truncated law's mean and std (scale *
    0.87962566) within 5 standard errors; a fixed seed or random_seed repeats the draw, another
    one changes it."""
    loc, scale, shape = 0.5, 2.0, (300, 400)
    draws = {}
    for name, pkg in (("jax", pt), ("torch", ptt)):
        w, startup = _init_param(pkg, pkg.initializer.TruncatedNormal(
            loc=loc, scale=scale), shape, 11)
        assert startup.global_block().ops[0].type == \
            "truncated_gaussian_random"
        draws[name] = w
        assert w.shape == shape and w.dtype == np.float32
        assert w.min() >= loc - 2 * scale and w.max() <= loc + 2 * scale
        # 5 standard errors of the mean; the std's is ~0.2%
        std = scale * 0.87962566
        assert abs(w.mean() - loc) < 5 * std / np.sqrt(w.size)
        assert abs(w.std() / std - 1) < 0.01
        # the tails reach the bounds: no collapse to a narrower law
        assert w.min() < loc - 1.9 * scale and w.max() > loc + 1.9 * scale
    again, _ = _init_param(ptt, ptt.initializer.TruncatedNormal(
        loc=loc, scale=scale), shape, 11)
    other, _ = _init_param(ptt, ptt.initializer.TruncatedNormal(
        loc=loc, scale=scale), shape, 12)
    seeded, _ = _init_param(ptt, ptt.initializer.TruncatedNormal(
        loc=loc, scale=scale, seed=5), shape, 11)
    seeded2, _ = _init_param(ptt, ptt.initializer.TruncatedNormal(
        loc=loc, scale=scale, seed=5), shape, 12)
    np.testing.assert_array_equal(again, draws["torch"])
    assert not np.array_equal(other, draws["torch"])
    np.testing.assert_array_equal(seeded, seeded2)
    assert not np.array_equal(draws["jax"], draws["torch"])


def test_uniform_random_statistics():
    """fc's default (Xavier) weight init draws uniform_random."""
    for pkg in (pt, ptt):
        w, startup = _init_param(pkg, pkg.initializer.Uniform(-0.5, 1.5),
                                 (200, 300), 3)
        assert startup.global_block().ops[0].type == "uniform_random"
        assert w.min() >= -0.5 and w.max() <= 1.5
        std = 2.0 / np.sqrt(12)
        assert abs(w.mean() - 0.5) < 5 * std / np.sqrt(w.size)
        assert abs(w.std() / std - 1) < 0.01


def test_constant_initializer_runs_fill_constant():
    for pkg in (pt, ptt):
        w, startup = _init_param(pkg, pkg.initializer.Constant(0.25),
                                 (3, 5), 0)
        assert startup.global_block().ops[0].type == "fill_constant"
        np.testing.assert_array_equal(w, np.full((3, 5), 0.25, np.float32))


# ---------------------------------------------------------------------------
# ops of the GPT slice: forward and gradient against the JAX package
# ---------------------------------------------------------------------------

def _grad_data(pkg, name, shape):
    """A feed var that takes part in differentiation."""
    return pkg.layers.data(name, list(shape), append_batch_size=False,
                           stop_gradient=False)


def _with_grads(pkg, outs, ins):
    """outs + d(sum_i <out_i, cot_i>)/d(ins), the cotangents fed as
    ``cot<i>`` (each inner product a ``mul`` of the flattened pair)."""
    total = None
    for i, o in enumerate(outs):
        cot = pkg.layers.data("cot%d" % i, [-1, 1], append_batch_size=False)
        dot = pkg.layers.mul(pkg.layers.reshape(o, [1, -1]), cot)
        total = dot if total is None else \
            pkg.layers.elementwise_add(total, dot)
    return list(outs) + pkg.framework.backward.gradients([total], ins)


def _cots(*sizes):
    return {"cot%d" % i: _x((n, 1), 20 + i) for i, n in enumerate(sizes)}


@pytest.mark.parametrize("num_or_sections,dim,used", [
    (3, 2, (0, 1, 2)),             # GPT's q, k, v
    ([3, 5, 4], -1, (0, 1, 2)),
    ([2, 1], 1, (0, 1)),
    (3, 2, (0, 2)),                # an output with no gradient
])
def test_split_forward_and_grad(num_or_sections, dim, used):
    """split's outputs arrive at its grad_of together; an output nothing
    differentiates contributes zeros to X's gradient."""
    shape = (2, 3, 12)

    def build(p):
        x = _grad_data(p, "x", shape)
        outs = p.layers.split(x, num_or_sections, dim=dim)
        return _with_grads(p, [outs[i] for i in used], [x]) + \
            [o for i, o in enumerate(outs) if i not in used]
    if isinstance(num_or_sections, int):
        parts = np.split(np.zeros(shape), num_or_sections, axis=dim)
    else:
        parts = np.split(np.zeros(shape), np.cumsum(num_or_sections[:-1]),
                         axis=dim)
    sizes = [a.size for a in parts]
    feed = dict({"x": _x(shape)}, **_cots(*[sizes[i] for i in used]))
    _, tout = _run_both(build, feed)
    if used == (0, 2):
        np.testing.assert_array_equal(tout[2][..., 4:8], 0.0)


@pytest.mark.parametrize("dim,keep_dim", [(None, False), (None, True),
                                          (1, False), (1, True),
                                          ([0, 2], False), (-1, True)])
def test_reduce_sum_forward_and_grad(dim, keep_dim):
    """A full reduction without keep_dim has shape (1,)."""
    shape = (2, 3, 4)
    n_out = np.zeros(shape).sum(axis=None if dim is None else tuple(
        np.atleast_1d(dim)), keepdims=keep_dim).size

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.reduce_sum(x, dim=dim,
                                                   keep_dim=keep_dim)], [x])
    _, tout = _run_both(build, dict({"x": _x(shape)}, **_cots(n_out)))
    if dim is None and not keep_dim:
        assert tout[0].shape == (1,)


@pytest.mark.parametrize("op", ["elementwise_mul", "elementwise_div"])
@pytest.mark.parametrize("yshape,axis", [((2, 3, 4), -1), ((4,), -1),
                                         ((3,), 1), ((3, 4), 1)])
def test_elementwise_mul_div_forward_and_grad(op, yshape, axis):
    xshape = (2, 3, 4)

    def build(p):
        x, y = _grad_data(p, "x", xshape), _grad_data(p, "y", yshape)
        return _with_grads(p, [getattr(p.layers, op)(x, y, axis=axis)],
                           [x, y])
    feed = dict({"x": _x(xshape), "y": np.abs(_x(yshape, 1)) + 0.5},
                **_cots(24))
    _run_both(build, feed)


@pytest.mark.parametrize("xshape,yshape,tx,ty,alpha", [
    ((2, 3, 4), (4, 5), False, False, 1.0),
    ((2, 4, 3), (2, 4, 5), True, False, 1.0),
    ((2, 3, 4), (5, 4), False, True, 0.5),       # GPT's tied logits
    ((4, 3), (5, 4), True, True, 2.0),
    ((3, 4), (4,), False, False, 1.0),
])
def test_matmul_forward_and_grad(xshape, yshape, tx, ty, alpha):
    m = xshape[-1] if tx else xshape[-2]
    n = 1 if len(yshape) == 1 else (yshape[-2] if ty else yshape[-1])
    lead = xshape[:-2] if len(xshape) >= len(yshape) else yshape[:-2]
    size = int(np.prod(lead)) * m * n

    def build(p):
        x, y = _grad_data(p, "x", xshape), _grad_data(p, "y", yshape)
        out = p.layers.matmul(x, y, transpose_x=tx, transpose_y=ty,
                              alpha=alpha)
        return _with_grads(p, [out], [x, y])
    _run_both(build, dict({"x": _x(xshape), "y": _x(yshape, 1)},
                          **_cots(size)))


def test_matmul_out_dtype_takes_float32_and_refuses_bf16():
    """``out_dtype`` takes float32 on f32 operands, and a narrower type
    too: f32 operands with ``out_dtype="bfloat16"`` give the f32 product
    rounded to bf16, as the JAX op gives it (once a refusal: bf16 programs
    were a later slice)."""
    _run_both(lambda p: [p.layers.matmul(
        _data(p, "x", [3, 4]), _data(p, "y", [5, 4]), transpose_y=True,
        out_dtype="float32")], {"x": _x((3, 4)), "y": _x((5, 4), 1)})
    feed = {"x": _x((3, 4)), "y": _x((4, 5), 1)}
    jout, tout = _run_matmul_widened(
        lambda p: [p.layers.matmul(_data(p, "x", [3, 4]),
                                   _data(p, "y", [4, 5]),
                                   out_dtype="bfloat16")], feed)
    assert tout[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(tout[0].float().numpy(),
                                  np.asarray(jout[0]).astype(np.float32))


def _run_matmul_widened(build, feed):
    """Run ``build``'s program in both packages; the port's fetches come
    back as tensors, so their dtypes show."""
    jmain, jstart, jfetch = _build(pt, build)
    tmain, _, tfetch = _build(ptt, build)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        jout = exe.run(jmain, feed=feed, fetch_list=jfetch)
    tout = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=tfetch, scope=ptt.Scope(),
        return_numpy=False)
    return jout, tout


@pytest.mark.parametrize("xshape,yshape,tx,ty", [
    ((6, 8), (5, 8), False, True),
    ((2, 3, 8), (5, 8), False, True),            # GPT's bf16 tied logits
    ((2, 8, 3), (2, 8, 5), True, False),
    ((3, 8), (2, 8, 5), False, False),            # X broadcast over Y's
])
def test_matmul_widens_bf16_operands_to_float32(xshape, yshape, tx, ty):
    """bf16 operands with ``out_dtype="float32"``: the f32 output of the
    JAX op (``_matmul_widen``: bf16 products are exact in f32, so only
    the order of the f32 sums differs, rtol 1e-6), and gradients in the
    operands' dtype, the cotangent cast to bf16 before both products and
    each product rounded to bf16 (one bf16 ulp apart at most, 2^-8)."""
    m = xshape[-1] if tx else xshape[-2]
    n = yshape[-2] if ty else yshape[-1]
    lead = xshape[:-2] if len(xshape) >= len(yshape) else yshape[:-2]
    size = int(np.prod(lead)) * m * n

    def build(p):
        x, y = _grad_data(p, "x", xshape), _grad_data(p, "y", yshape)
        xb, yb = p.layers.cast(x, "bfloat16"), p.layers.cast(y, "bfloat16")
        out = p.layers.matmul(xb, yb, transpose_x=tx, transpose_y=ty,
                              out_dtype="float32")
        return _with_grads(p, [out], [xb, yb])
    jout, tout = _run_matmul_widened(
        build, dict({"x": _x(xshape), "y": _x(yshape, 1)}, **_cots(size)))
    assert [t.dtype for t in tout] == [torch.float32, torch.bfloat16,
                                       torch.bfloat16]
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-6, atol=1e-6)
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j).astype(np.float32),
                                   rtol=2.0 ** -8, atol=1e-6)


def test_set_precision_keeps_bf16_sums_in_float32():
    """The Executor turns off cuBLAS's bf16 split-K reductions, whose
    partial sums are rounded to bf16: bf16 products sum in f32."""
    flags = torch.backends.cuda.matmul
    flags.allow_bf16_reduced_precision_reduction = True
    ptt.Executor(ptt.CPUPlace())
    assert flags.allow_bf16_reduced_precision_reduction is False


