"""The optimizer update ops and classes: the port against the JAX package.

Every update op of paddle_tpu/ops/optimizer_ops.py but
``average_accumulates`` (tests/test_torch_averaging.py) runs in both
packages on the same numpy state, one parametrised case per (op,
variant, dtype): f32, and
bf16 parameter and gradient beside f32 accumulators (what a bf16 model
hands the optimizer). Each output must have the JAX op's dtype and shape,
and its values must agree to rtol 1e-6 in the f32 cases (the same
elementwise formula, libm against XLA's own sqrt, pow and divide, a few
ulps apart; an update lands close to zero in some elements, p minus a
step of about its own size, so the bound adds 1e-6 of the output's
largest magnitude absolute) and within one bf16 ulp of the output's
largest magnitude in the bf16 cases, f32 outputs included: a product
with a bf16 operand (lr * g, (1 - beta1) * g) is rounded to bf16 in
torch, while XLA may keep it in f32 inside a fused expression, and where
such a term nearly cancels (a moment's decay against the new gradient)
that rounding is as large as the largest term's ulp.

``adamw`` is also held through the port's ``fused_adam_plain`` (the
kernel's oracle) against the JAX op with its Pallas kernel in interpret
mode, and ``coeff = 0`` against ``adam`` bit for bit. ``dpsgd`` draws
its noise from each package's own generator, so it is held by its
statistics. Each optimizer class runs three steps of a tiny two-layer
``fc`` program in both packages from the same weights: equal programs,
accumulators of equal names, and equal values (rtol 1e-5, atol 1e-6: f32
through two products and their gradients, summed in another order).
"""
import importlib

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.ops import pallas_dispatch as jpd
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import fused_adam as tadam
from test_torch_bert_training import _normalized

jopt_ops = importlib.import_module("paddle_tpu.ops.optimizer_ops")

N = (6, 5)

# op type -> (accumulator slots and how each starts, attrs of each variant)
_POS = "pos"          # |N(0,1)| + 0.1: a squared accumulator
_POW = "pow"          # a beta power
_OPS = {
    "sgd": ([], {"": {}}),
    "momentum": ([("Velocity", "randn")],
                 {"": {"mu": 0.9}, "nesterov": {"mu": 0.9,
                                                "use_nesterov": True}}),
    "lars_momentum": ([("Velocity", "randn")],
                      {"": {"mu": 0.9, "lars_coeff": 0.01,
                            "lars_weight_decay": 0.001}}),
    "adam": ([("Moment1", "randn"), ("Moment2", _POS), ("Beta1Pow", _POW),
              ("Beta2Pow", _POW)], {"": {}, "lazy": {"lazy_mode": True}}),
    "adamw": ([("Moment1", "randn"), ("Moment2", _POS), ("Beta1Pow", _POW),
               ("Beta2Pow", _POW)],
              {"": {"coeff": 0.05}, "lazy": {"coeff": 0.05,
                                             "lazy_mode": True}}),
    "adagrad": ([("Moment", _POS)], {"": {"epsilon": 1e-6}}),
    "decayed_adagrad": ([("Moment", _POS)], {"": {"decay": 0.9}}),
    "rmsprop": ([("MeanSquare", _POS), ("Moment", "randn"),
                 ("MeanGrad", "small")],
                {"": {"decay": 0.9, "momentum": 0.5},
                 "centered": {"decay": 0.9, "momentum": 0.5,
                              "centered": True}}),
    "adamax": ([("Moment", "randn"), ("InfNorm", _POS), ("Beta1Pow", _POW)],
               {"": {}}),
    "lamb": ([("Moment1", "randn"), ("Moment2", _POS), ("Beta1Pow", _POW),
              ("Beta2Pow", _POW)],
             {"": {"weight_decay": 0.01},
              "no_decay": {"weight_decay": 0.0}}),
    "ftrl": ([("SquaredAccumulator", _POS), ("LinearAccumulator", "randn")],
             {"": {"l1": 0.1, "l2": 0.2},
              "lr_power": {"l1": 0.0, "l2": 0.0, "lr_power": -0.7}}),
    "adadelta": ([("AvgSquaredGrad", _POS), ("AvgSquaredUpdate", _POS)],
                 {"": {"rho": 0.9}}),
}
_NO_LR = ("adadelta",)
_CASES = [(op, variant, dtype) for op, (_, variants) in _OPS.items()
          for variant in variants for dtype in ("float32", "bfloat16")]


def _state(op, seed, shape=N):
    """{slot: f32 numpy} of one update: parameter, gradient (two rows
    exactly zero, which lazy Adam leaves alone), accumulators, rate."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    g = (rng.randn(*shape) * 0.5).astype(f32)
    g[1] = g[4] = 0.0
    ins = {"Param": rng.randn(*shape).astype(f32), "Grad": g,
           "LearningRate": np.array([0.05], f32)}
    for slot, kind in _OPS[op][0]:
        if kind == _POS:
            ins[slot] = (np.abs(rng.randn(*shape)) + 0.1).astype(f32)
        elif kind == _POW:
            ins[slot] = np.array([0.9 ** 3 if slot == "Beta1Pow"
                                  else 0.999 ** 3], f32)
        else:
            scale = 0.01 if kind == "small" else 0.1
            ins[slot] = (rng.randn(*shape) * scale).astype(f32)
    if op in _NO_LR:
        del ins["LearningRate"]
    return ins


def _both(ins, bf16_slots=()):
    """The JAX and torch inputs of a state, the named slots in bf16."""
    jins, tins = {}, {}
    for slot, a in ins.items():
        j, t = jnp.asarray(a), torch.from_numpy(a.copy())
        if slot in bf16_slots:
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        jins[slot], tins[slot] = [j], [t]
    return jins, tins


def _bf16_ulp(x):
    _, e = np.frexp(np.maximum(np.abs(x), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _check(name, got, want, bf16):
    """One output: JAX's dtype and shape, then the stated tolerance."""
    want_np = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    assert tuple(got.shape) == tuple(want.shape), name
    g = to_numpy(got).astype(np.float64)
    w = want_np.astype(np.float64)
    if bf16:
        assert np.all(np.abs(g - w) <= _bf16_ulp(np.abs(w).max())), name
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("op,variant,dtype", _CASES)
def test_update_op_matches_jax(op, variant, dtype):
    attrs = _OPS[op][1][variant]
    ins = _state(op, seed=len(op) + len(variant))
    jins, tins = _both(ins, ("Param", "Grad") if dtype == "bfloat16"
                       else ())
    want = jreg.get_op(op).fn(None, jins, attrs)
    got = treg.get_op(op).fn(None, tins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        _check("%s %s" % (op, slot), got[slot], want[slot],
               dtype == "bfloat16")
    if attrs.get("lazy_mode"):
        # the two all-zero gradient rows keep their parameter
        np.testing.assert_array_equal(to_numpy(got["ParamOut"])[[1, 4]],
                                      to_numpy(tins["Param"][0])[[1, 4]])


def _adam_args(ins):
    t = {k: torch.from_numpy(v.copy()) for k, v in ins.items()}
    return (t["Param"], t["Grad"], t["Moment1"], t["Moment2"],
            t["LearningRate"], t["Beta1Pow"], t["Beta2Pow"])


@pytest.mark.parametrize("shape", [(32, 128), (40, 96)])
def test_adamw_plain_matches_jax_pallas_interpret(shape, monkeypatch):
    """The port's fused_adam_plain with coeff against the JAX ``adamw``
    op with ``use_pallas={"adam"}`` in interpret mode (its fused-Adam
    Pallas kernel, then the decoupled decay): rtol 1e-6 plus 1e-6 of each
    output's largest magnitude (a moment near zero is the difference of
    two terms, rounded in another order)."""
    ins = _state("adamw", seed=7, shape=shape)
    seen, orig = set(), jpl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.add(getattr(getattr(kernel, "func", kernel), "__name__", ""))
        return orig(kernel, *args, **kwargs)
    monkeypatch.setattr(jpl, "pallas_call", spy)
    jins, _ = _both(ins)
    with jpd.scope(jpd.PallasConfig({"adam"}, interpret=True)):
        want = jopt_ops._adamw(None, jins, {"coeff": 0.05})
    assert "_adam_kernel" in seen
    got = tadam.fused_adam_plain(*_adam_args(ins), 0.9, 0.999, 1e-8, 0.05)
    for a, key in zip(got, ("ParamOut", "Moment1Out", "Moment2Out")):
        w = np.asarray(want[key])
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_adam_coeff_zero_is_adam_bit_for_bit(dtype):
    """coeff = 0 is Adam, bits and all, and coeff > 0 moves p by the
    decay of the old p on top of Adam's step."""
    args = list(_adam_args(_state("adam", seed=3)))
    args[0] = args[0].to(dtype)
    adam = tadam.fused_adam_plain(*args)
    zero = tadam.fused_adam(*args, 0.9, 0.999, 1e-8, 0.0)
    for a, b in zip(adam, zero):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ins = {"Param": [args[0]], "Grad": [args[1]], "Moment1": [args[2]],
           "Moment2": [args[3]], "LearningRate": [args[4]],
           "Beta1Pow": [args[5]], "Beta2Pow": [args[6]]}
    adamw = treg.get_op("adamw").fn(None, ins, {"coeff": 0.0})
    assert torch.equal(adamw["ParamOut"], adam[0])
    decayed = tadam.fused_adam_plain(*args, 0.9, 0.999, 1e-8, 0.5)[0]
    want = (adam[0].float() - 0.05 * 0.5 * args[0].float()).to(dtype)
    assert torch.equal(decayed, want)


def test_dpsgd_clips_and_adds_noise_of_the_stated_spread():
    """DP-SGD: the gradient clipped to norm ``clip`` (sigma = 0: the step
    is lr times the clipped gradient, against the JAX op), and the noise
    of 10^5 elements with mean 0 and std sigma * clip within 5 sigma of
    the estimate."""
    rng = np.random.RandomState(0)
    g = (rng.randn(200, 500) * 3.0).astype(np.float32)
    p = rng.randn(200, 500).astype(np.float32)
    lr = np.array([0.1], np.float32)
    attrs = {"clip": 2.0, "sigma": 0.0}
    want = jopt_ops._dpsgd(_JaxCtx(), {"Param": [jnp.asarray(p)],
                                       "Grad": [jnp.asarray(g)],
                                       "LearningRate": [jnp.asarray(lr)]},
                           attrs)["ParamOut"]
    ctx = _TorchCtx()
    tins = {"Param": [torch.from_numpy(p)], "Grad": [torch.from_numpy(g)],
            "LearningRate": [torch.from_numpy(lr)]}
    got = treg.get_op("dpsgd").fn(ctx, tins, attrs)["ParamOut"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    step = (p - got.numpy()) / 0.1
    np.testing.assert_allclose(np.linalg.norm(step), 2.0, rtol=1e-5)
    tins["Grad"] = [torch.zeros(200, 500)]
    noisy = treg.get_op("dpsgd").fn(ctx, tins, {"clip": 2.0, "sigma": 1.5})
    noise = (p - noisy["ParamOut"].numpy()) / 0.1
    n, std = noise.size, 1.5 * 2.0
    assert abs(noise.mean()) <= 5 * std / np.sqrt(n)
    # the sample std of n normals has std ~ std / sqrt(2 n)
    assert abs(noise.std() - std) <= 5 * std / np.sqrt(2 * n)


class _JaxCtx(object):
    def rng(self):
        import jax
        return jax.random.PRNGKey(0)


class _TorchCtx(object):
    def generator(self, attrs):
        return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# the classes: three steps of a tiny fc program in both packages
# ---------------------------------------------------------------------------

_CLASSES = {
    "SGD": lambda o: o.SGD(0.1),
    "Momentum": lambda o: o.Momentum(0.1, 0.9),
    "Momentum_nesterov": lambda o: o.Momentum(0.1, 0.9, use_nesterov=True),
    "LarsMomentum": lambda o: o.LarsMomentum(0.1, 0.9),
    "DGCMomentum": lambda o: o.DGCMomentumOptimizer(0.1, 0.9),
    "Adagrad": lambda o: o.Adagrad(0.1),
    "DecayedAdagrad": lambda o: o.DecayedAdagrad(0.01),
    "Adadelta": lambda o: o.Adadelta(),
    "Adam": lambda o: o.Adam(0.01),
    "AdamW": lambda o: o.AdamW(0.01, weight_decay=0.1),
    "Lamb": lambda o: o.Lamb(0.01, exclude_from_weight_decay_fn=lambda p:
                             p.name.endswith(".b_0")),
    "Adamax": lambda o: o.Adamax(0.01),
    "RMSProp": lambda o: o.RMSProp(0.01),
    "RMSProp_centered": lambda o: o.RMSProp(0.01, momentum=0.5,
                                            centered=True),
    "Ftrl": lambda o: o.Ftrl(0.1, l1=0.01, l2=0.01),
    "Dpsgd": lambda o: o.Dpsgd(0.1, clip=1.0, sigma=0.0),
}


def _fc_program(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4, 8], append_batch_size=False)
        h = pkg.layers.fc(x, 16, act="tanh")
        y = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(pkg.layers.square(y - 0.5))
        make_opt(pkg.optimizer).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(_CLASSES))
def test_optimizer_class_trains_like_jax(name):
    jmain, jstart, jloss = _fc_program(pt, _CLASSES[name])
    tmain, tstart, tloss = _fc_program(ptt, _CLASSES[name])
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    feed = {"x": np.random.RandomState(1).randn(4, 8).astype(np.float32)}
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        jexe = pt.Executor(pt.CPUPlace())
        jexe.run(jstart)
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in jmain.list_vars() if v.persistable}
        jl = [jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]
              for _ in range(3)]
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(state, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        texe = ptt.Executor(ptt.CPUPlace())
        tl = [texe.run(tmain, feed=feed, fetch_list=[tloss])[0]
              for _ in range(3)]
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=1e-5)
    accs = sorted(n for n in state if n not in
                  {p.name for p in jmain.all_parameters()})
    assert accs == sorted(n for n in tscope.keys() if n in state and n
                          not in {p.name for p in tmain.all_parameters()})
    for n in state:
        np.testing.assert_allclose(
            to_numpy(tscope.find_var(n)).astype(np.float64),
            np.asarray(jscope.find_var(n)).astype(np.float64),
            rtol=1e-5, atol=1e-6, err_msg=n)
