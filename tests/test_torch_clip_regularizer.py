"""Regularizers and gradient clips: the port against the JAX package.

``L1Decay``/``L2Decay`` optimizer-wide and per parameter (a parameter's
own regularizer first), each clip class as an optimizer's ``grad_clip``,
``set_gradient_clip`` globally and with ``param_list``, and
``ErrorClipByValue``: each builds the same program in both packages
(equal JSON), then trains a tiny two-layer ``fc`` program three SGD
steps from the same weights. Tolerance: f32 on both sides through two
small products, rtol 1e-5 and atol 1e-6 on losses and parameters.

The dtypes of a bf16 gradient through the clip ops are pinned op by op
against the JAX ops: ``squared_l2_norm`` of a bf16 gradient is a 0-d
bf16 scalar, ``elementwise_max`` of that with an f32 [1] tensor is f32,
and a bf16 gradient times the f32 scale is f32, so a bf16 model's
clipped gradients are f32 in both packages. Values within one bf16 ulp of
the largest magnitude (rounding points differ, as in
test_torch_optimizers.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import clip as jclip
from paddle_tpu import regularizer as jreg_mod
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import regularizer as treg_mod
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.ops import registry as treg
from test_torch_bert_training import _normalized

_MODS = {pt: (jclip, jreg_mod), ptt: (tclip, treg_mod)}


def _program(pkg, grad_clip=None, regularization=None, own_reg=None,
             own_clip=None, global_clip=None, per_param=False):
    """Two fc layers; ``own_reg(reg_module)`` / ``own_clip(clip_module)``
    give the first weight its own regularizer / clip;
    ``global_clip(clip_module)`` is set with ``set_gradient_clip`` (with
    ``param_list``: the first weight)."""
    clip_mod, reg_mod = _MODS[pkg]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4, 8], append_batch_size=False)
        attr = pkg.ParamAttr(
            regularizer=own_reg and own_reg(reg_mod),
            gradient_clip=own_clip and own_clip(clip_mod))
        h = pkg.layers.fc(x, 16, act="tanh", param_attr=attr)
        y = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(pkg.layers.square(y - 0.5))
        if global_clip:
            params = main.all_parameters()[:1] if per_param else None
            clip_mod.set_gradient_clip(global_clip(clip_mod),
                                       param_list=params)
        try:
            pkg.optimizer.SGD(
                0.5, regularization=regularization and regularization(
                    reg_mod),
                grad_clip=grad_clip and grad_clip(clip_mod)).minimize(loss)
        finally:
            clip_mod.set_gradient_clip(None)
    return main, startup, loss


def _train_both(**kw):
    jmain, jstart, jloss = _program(pt, **kw)
    tmain, tstart, tloss = _program(ptt, **kw)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    feed = {"x": np.random.RandomState(2).randn(4, 8).astype(np.float32)}
    params = [p.name for p in jmain.all_parameters()]
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.list_vars() if v.persistable}
        jl = [exe.run(jmain, feed=feed, fetch_list=[jloss])[0]
              for _ in range(3)]
        jfinal = {p: np.asarray(jscope.find_var(p)) for p in params}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(state, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        exe = ptt.Executor(ptt.CPUPlace())
        tl = [exe.run(tmain, feed=feed, fetch_list=[tloss])[0]
              for _ in range(3)]
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=1e-5)
    for p in params:
        np.testing.assert_allclose(tscope.find_var(p).numpy(), jfinal[p],
                                   rtol=1e-5, atol=1e-6, err_msg=p)
    moved = max(float(np.abs(jfinal[p] - state[p]).max()) for p in params)
    assert moved > 1e-3
    return tmain


def _types(program):
    return [op.type for op in program.global_block().ops]


@pytest.mark.parametrize("kind", ["L1", "L2"])
def test_optimizer_wide_regularizer(kind):
    reg = (lambda m: m.L1Decay(0.05)) if kind == "L1" else \
        (lambda m: m.L2Decay(0.05))
    types = _types(_train_both(regularization=reg))
    assert types.count("sum") == 4          # one per parameter
    assert types.count("sign") == (4 if kind == "L1" else 0)


def test_parameter_regularizer_comes_before_the_optimizer_s():
    types = _types(_train_both(regularization=lambda m: m.L2Decay(0.05),
                               own_reg=lambda m: m.L1Decay(0.1)))
    assert types.count("sum") == 4 and types.count("sign") == 1


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_optimizer_grad_clip(kind):
    make = {"value": lambda m: m.GradientClipByValue(0.05),
            "norm": lambda m: m.GradientClipByNorm(0.1),
            "global_norm": lambda m: m.GradientClipByGlobalNorm(0.1)}[kind]
    types = _types(_train_both(grad_clip=make,
                               regularization=lambda m: m.L2Decay(0.01)))
    op = {"value": "clip", "norm": "clip_by_norm",
          "global_norm": "squared_l2_norm"}[kind]
    assert types.count(op) == 4
    # regularization first, then the clip, then the update
    assert types.index("sum") < types.index(op) < types.index("sgd")


@pytest.mark.parametrize("per_param", [False, True])
def test_set_gradient_clip(per_param):
    """``set_gradient_clip`` applies to every gradient when the optimizer
    has no clip of its own; ``param_list`` also makes it the listed
    parameter's own clip (as in the JAX package, the global clip is set
    either way)."""
    tmain = _train_both(global_clip=lambda m: m.GradientClipByValue(0.02),
                        per_param=per_param)
    assert _types(tmain).count("clip") == 4
    own = [p.gradient_clip_attr is not None for p in tmain.all_parameters()]
    assert own == [per_param, False, False, False]
    assert tclip._gradient_clip is None


def test_parameter_clip_comes_before_the_global_clip():
    types = _types(_train_both(
        own_clip=lambda m: m.GradientClipByNorm(0.1),
        global_clip=lambda m: m.GradientClipByValue(0.02)))
    assert types.count("clip_by_norm") == 1 and types.count("clip") == 3


def test_set_gradient_clip_global_norm_takes_every_gradient():
    types = _types(_train_both(
        global_clip=lambda m: m.GradientClipByGlobalNorm(0.1),
        per_param=True))
    assert types.count("squared_l2_norm") == 4


def test_error_clip_by_value_appends_a_clip_of_the_gradient():
    progs = {}
    for pkg, mod in ((pt, jclip), (ptt, tclip)):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            g = pkg.layers.data("g", [3, 4], append_batch_size=False)
            mod.ErrorClipByValue(0.3)._append_clip_op(main.global_block(),
                                                      g.name)
        progs[pkg] = main
    assert _normalized(progs[ptt]) == _normalized(progs[pt])
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    out, = ptt.Executor(ptt.CPUPlace()).run(progs[ptt], feed={"g": x},
                                            fetch_list=["g"])
    np.testing.assert_array_equal(out, np.clip(x, -0.3, 0.3))


def _bf16_pair(a):
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a.copy()).to(torch.bfloat16))


def _pin(name, got, want):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    assert tuple(got.shape) == tuple(want.shape), name
    w = np.asarray(want).astype(np.float64)
    _, e = np.frexp(max(float(np.abs(w).max()), 2.0 ** -126))
    assert np.abs(to_numpy(got).astype(np.float64) - w).max() <= \
        np.ldexp(1.0, e - 8), name


def test_bf16_gradient_dtypes_through_the_global_norm_clip():
    rng = np.random.RandomState(3)
    g = rng.randn(16, 8).astype(np.float32)
    jg, tg = _bf16_pair(g)
    run = {"j": lambda op, ins, a={}: jreg.get_op(op).fn(None, ins, a),
           "t": lambda op, ins, a={}: treg.get_op(op).fn(None, ins, a)}
    jsq = run["j"]("squared_l2_norm", {"X": [jg]})["Out"]
    tsq = run["t"]("squared_l2_norm", {"X": [tg]})["Out"]
    _pin("squared_l2_norm", tsq, jsq)
    assert tsq.dtype == torch.bfloat16 and tsq.dim() == 0
    jf32 = jnp.asarray(np.array([1.0], np.float32))
    tf32 = torch.tensor([1.0])
    jmax = run["j"]("elementwise_max", {"X": [jsq], "Y": [jf32]})["Out"]
    tmax = run["t"]("elementwise_max", {"X": [tsq], "Y": [tf32]})["Out"]
    _pin("elementwise_max", tmax, jmax)
    assert tmax.dtype == torch.float32 and tuple(tmax.shape) == (1,)
    # a 0-d f32 scale times a bf16 gradient: torch alone would keep bf16
    jscale, tscale = jnp.float32(0.25), torch.tensor(0.25)
    jmul = run["j"]("elementwise_mul", {"X": [jg], "Y": [jscale]})["Out"]
    tmul = run["t"]("elementwise_mul", {"X": [tg], "Y": [tscale]})["Out"]
    _pin("elementwise_mul", tmul, jmul)
    assert tmul.dtype == torch.float32
    jsum = run["j"]("sum", {"X": [jsq, jnp.float32(2.0)]})["Out"]
    tsum = run["t"]("sum", {"X": [tsq, torch.tensor(2.0)]})["Out"]
    _pin("sum", tsum, jsum)
    jcn = run["j"]("clip_by_norm", {"X": [jg]}, {"max_norm": 1.0})["Out"]
    tcn = run["t"]("clip_by_norm", {"X": [tg]}, {"max_norm": 1.0})["Out"]
    _pin("clip_by_norm", tcn, jcn)
    for op, attrs in (("clip", {"min": -0.5, "max": 0.5}),
                      ("sqrt", {}), ("square", {}), ("sign", {})):
        x = {"X": [jnp.abs(jg)]} if op == "sqrt" else {"X": [jg]}
        tx = {"X": [tg.abs()]} if op == "sqrt" else {"X": [tg]}
        _pin(op, run["t"](op, tx, attrs)["Out"],
             run["j"](op, x, attrs)["Out"])


def test_bf16_model_clipped_gradients_are_f32():
    """Built in the port: a bf16 weight's gradient, clipped by the global
    norm, reaches the update op as an f32 tensor, as in JAX."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4, 8], dtype="bfloat16",
                            append_batch_size=False)
        w = ptt.layers.create_parameter([8, 3], "bfloat16")
        loss = ptt.layers.mean(ptt.layers.cast(
            ptt.layers.mul(x, w), "float32"))
        ptt.optimizer.SGD(0.1, grad_clip=ptt.clip.GradientClipByGlobalNorm(
            1.0)).minimize(loss)
    sgd = [op for op in main.global_block().ops if op.type == "sgd"][0]
    grad = sgd.input("Grad")[0]
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": torch.ones(4, 8, dtype=torch.bfloat16)}
    g, = exe.run(main, feed=feed, fetch_list=[grad], scope=scope,
                 return_numpy=False)
    assert g.dtype == torch.float32 and tuple(g.shape) == (8, 3)
