"""Mixed precision (paddle_tpu_torch/contrib/mixed_precision.py) against
the JAX package's, and the fp16 plain flash attention, the dtype
promotion of the decorated programs' elementwise ops and the card's
precision flags.

``decorate`` must build the JAX package's program: the same op list
(types, order, inputs and outputs, so the same cast names) and the same
var dtypes, for the MLP of tests/test_contrib.py, tiny BERT and a tiny
ResNet-18, and the verifier's diagnostics of the decorated BERT equal
(six ``shape_dtype`` warnings: ``elementwise_add`` of a low-precision
``fc`` output and its f32 bias). Trained three Adam steps in both
packages from the JAX startup's persistables (dropout 0):

- losses within rtol 2e-4 in bf16 and fp16: both packages round at the
  same ops, in another summation order, so a low-precision activation
  may land an ulp apart (2^-8 bf16, 2^-11 fp16) and the f32 mean over
  tokens averages that out (measured under 1e-5);
- the loss-scale and good-steps sequences exactly: they move by the
  finiteness of every gradient, which both packages see alike.

The reference's behaviours are pinned, odd ones too: an overflow step (a
feed that makes the loss and the gradients non-finite) hands the inner
optimizer a zero gradient (Adam's moments decay by beta1 / beta2, and
the parameters stay bit-equal only while the moments are 0) and
multiplies the scale by ``decr_ratio``, at every overflow, since
``decr_every_n_nan_or_inf`` is never read; bf16 with
``init_loss_scaling`` 1 takes the plain path (no scale, no finiteness
check), other values the scaled one; custom lists move an op between
the lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.framework import analysis as janalysis
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.framework import analysis as tanalysis
from paddle_tpu_torch.framework.executor import set_precision
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.registry import get_op as tget

MP = {pt: jmp, ptt: tmp}
BERT = {pt: jbert, ptt: tbert}
TINY_BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 ff_size=128, max_position=64, hidden_dropout=0.0,
                 attn_dropout=0.0)
BATCH, SEQ, PREDS, LR, STEPS = 2, 16, 4, 1e-3, 3
FP16 = dict(dtype="float16", init_loss_scaling=2.0 ** 15,
            use_dynamic_loss_scaling=True, incr_every_n_steps=2)
DTYPES = {"bf16": dict(dtype="bfloat16"), "fp16": FP16}
LOSS_RTOL = 2e-4


def _mlp(pkg, dtype, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        x = L.data("x", [8], dtype="float32")
        y = L.data("y", [1], dtype="int64")
        h = L.fc(x, 16, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), y))
        opt = MP[pkg].decorate(pkg.optimizer.Adam(1e-2), dtype=dtype, **kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _bert(pkg, amp, lists=None):
    """(main, startup, loss, decorated optimizer, feed) of tiny BERT's
    pretraining program under ``decorate(Adam(LR), **amp)``."""
    held = {}

    def opt_fn(loss):
        held["opt"] = MP[pkg].decorate(pkg.optimizer.Adam(LR),
                                       amp_lists=lists, **amp)
        return held["opt"].minimize(loss)
    cfg = BERT[pkg].BertConfig(**TINY_BERT)
    with pkg.unique_name.guard():
        main, startup, _, fetch = BERT[pkg].bert_pretrain_program(
            cfg, BATCH, SEQ, PREDS, optimizer_fn=opt_fn)
    feed = jbert.synthetic_batch(jbert.BertConfig(**TINY_BERT), BATCH, SEQ,
                                 PREDS, seed=0)
    return main, startup, fetch["loss"], held["opt"], feed


def _resnet18(pkg, dtype):
    mod = jresnet if pkg is pt else tresnet

    def opt_fn(loss):
        return MP[pkg].decorate(pkg.optimizer.Momentum(0.1, 0.9),
                                dtype=dtype).minimize(loss)
    with pkg.unique_name.guard():
        return mod.resnet_train_program(18, 10, (3, 32, 32),
                                        optimizer_fn=opt_fn)[0]


def _ops(main):
    return [(op.type, op.inputs, op.outputs, op.attrs.get("out_dtype"))
            for op in main.global_block().ops]


def _var_dtypes(main):
    return {n: v.dtype for n, v in main.global_block().vars.items()}


def _assert_same_program(a, b):
    assert _ops(b) == _ops(a)
    assert _var_dtypes(b) == _var_dtypes(a)


@pytest.mark.parametrize("amp", ["bf16", "fp16"])
def test_decorated_mlp_is_the_jax_program(amp):
    kw = dict(DTYPES[amp], incr_every_n_steps=2)
    a, b = _mlp(pt, **kw)[0], _mlp(ptt, **kw)[0]
    _assert_same_program(a, b)
    assert b._version > 0


@pytest.mark.parametrize("amp", ["bf16", "fp16"])
def test_decorated_bert_is_the_jax_program(amp):
    a, b = _bert(pt, DTYPES[amp])[0], _bert(ptt, DTYPES[amp])[0]
    _assert_same_program(a, b)
    casts = [op for op in b.global_block().ops if op.type == "cast"
             and op.attrs.get("op_role") == "amp"]
    assert len(casts) == 33
    isfinite = [op for op in b.global_block().ops if op.type == "isfinite"]
    assert len(isfinite) == (46 if amp == "fp16" else 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorated_resnet18_is_the_jax_program(dtype):
    _assert_same_program(_resnet18(pt, dtype), _resnet18(ptt, dtype))


@pytest.mark.parametrize("amp", ["bf16", "fp16"])
def test_verifier_sees_the_decorated_bert_as_the_jax_package(amp):
    keys = []
    for pkg, an in ((pt, janalysis), (ptt, tanalysis)):
        main, _, loss, _, feed = _bert(pkg, DTYPES[amp])
        res = an.verify_program(
            main, feeds={k: v.shape for k, v in feed.items()},
            fetch_list=[loss.name])
        keys.append([(d.pass_name, d.severity, d.op_idx, d.op_type, d.vars)
                     for d in res])
    assert keys[1] == keys[0]
    warn = [k for k in keys[1] if k[1] == "warning"]
    assert len(warn) == 6
    assert {k[0] for k in warn} == {"shape_dtype"}
    assert {k[3] for k in warn} == {"elementwise_add"}
    assert not [k for k in keys[1] if k[1] == "error"]


def _train_both(amp, feeds, lists=None, fetch_state=True):
    """Train tiny BERT in both packages on ``feeds`` (one feed dict a
    step), the port from the JAX startup's persistables: per package the
    list of fetched runs ([loss, loss scale, good steps] where they
    exist), the final persistables and the parameter names."""
    out = []
    init = None
    for pkg in (pt, ptt):
        main, startup, loss, opt, _ = _bert(pkg, DTYPES[amp], lists)
        fetch = [loss.name]
        if fetch_state and opt.get_loss_scaling() is not None:
            fetch.append(opt.get_loss_scaling().name)
            good = [v.name for v in main.list_vars()
                    if v.name.startswith("good_steps")]
            fetch += good
        persist = [v.name for v in main.list_vars() if v.persistable]
        if pkg is pt:
            scope = pt.Scope()
            with pt.scope_guard(scope):
                exe = pt.Executor(pt.CPUPlace())
                exe.run(startup)
                init = {n: np.asarray(scope.find_var(n)) for n in persist}
                runs = [[np.asarray(r) for r in
                         exe.run(main, feed=f, fetch_list=fetch)]
                        for f in feeds]
                final = {n: np.asarray(scope.find_var(n)) for n in persist}
        else:
            scope = ptt.Scope()
            ptt.set_params_from_numpy(init, main, scope, ptt.CPUPlace())
            with ptt.scope_guard(scope):
                exe = ptt.Executor(ptt.CPUPlace())
                runs = [exe.run(main, feed=f, fetch_list=fetch)
                        for f in feeds]
                final = {n: to_numpy(scope.find_var(n)) for n in persist}
        out.append((runs, final, [p.name for p in main.all_parameters()]))
    return init, out


@pytest.mark.parametrize("amp", ["bf16", "fp16"])
def test_decorated_bert_trains_like_jax(amp):
    feed = _bert(pt, DTYPES[amp])[4]
    _, ((jruns, jfinal, params), (truns, tfinal, _)) = _train_both(
        amp, [feed] * STEPS)
    jloss = [float(r[0].reshape(-1)[0]) for r in jruns]
    tloss = [float(r[0].reshape(-1)[0]) for r in truns]
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert tloss[-1] < tloss[0]
    if amp == "fp16":
        # loss scale and good steps: equal, value for value
        for j in range(1, 3):
            assert [float(r[j].reshape(-1)[0]) for r in truns] == \
                [float(r[j].reshape(-1)[0]) for r in jruns]
        # incr_every_n_steps=2 doubles the scale every second clean step
        names = sorted(n for n in tfinal if n.startswith("loss_scaling"))
        assert float(tfinal[names[0]].reshape(-1)[0]) == 2.0 ** 16
    for p in params:
        assert tfinal[p].dtype == np.float32   # f32 masters


def _overflow(feed):
    """The feed with one input-mask element at 1e36: its attention bias
    (mask * 1e4 - 1e4) is Inf in f32 and in fp16, so the loss and every
    gradient of the step are non-finite."""
    bad = dict(feed)
    bad["input_mask"] = feed["input_mask"].copy()
    bad["input_mask"][0, 0, 0] = 1e36
    return bad


def _scalar(x):
    return float(np.asarray(x).reshape(-1)[0])


def test_overflow_steps_zero_the_gradient_and_shrink_the_scale():
    """Overflow at the first step (Adam's moments still 0: the zero
    gradient leaves every parameter bit-equal), then a clean step, then
    two overflows in a row (each shrinks the scale by decr_ratio 0.8:
    decr_every_n_nan_or_inf=2 is never read; the zero gradient decays
    Adam's moments by beta1 / beta2 exactly, and the parameters move by
    Adam's step of those moments, as in the reference), then clean."""
    feed = _bert(pt, FP16)[4]
    bad = _overflow(feed)
    feeds = [bad, feed, bad, bad, feed]
    init, ((jruns, _, _), (truns, _, _)) = _train_both("fp16", feeds)
    for j in (1, 2):
        assert [_scalar(r[j]) for r in truns] == \
            [_scalar(r[j]) for r in jruns]
    assert not np.isfinite(_scalar(truns[0][0]))
    assert np.isfinite(_scalar(truns[1][0]))

    main, _, loss, opt, _ = _bert(ptt, FP16)
    scale = opt.get_loss_scaling().name
    good = [n for n in main.global_block().vars
            if n.startswith("good_steps")][0]
    params = [p.name for p in main.all_parameters()]
    m1 = {p: "%s_moment1_0" % p for p in params}
    m2 = {p: "%s_moment2_0" % p for p in params}
    scope = ptt.Scope()
    ptt.set_params_from_numpy(init, main, scope, ptt.CPUPlace())

    def state(names):
        return {n: to_numpy(scope.find_var(n)).copy() for n in names}
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        p0 = state(params)
        exe.run(main, feed=bad, fetch_list=[loss.name])
        for n, v in state(params).items():
            np.testing.assert_array_equal(v, p0[n], err_msg=n)
        assert _scalar(state([scale])[scale]) == 2.0 ** 15 * 0.8 or \
            _scalar(state([scale])[scale]) == float(
                np.float32(2.0 ** 15) * np.float32(0.8))
        assert _scalar(state([good])[good]) == 0.0
        exe.run(main, feed=feed, fetch_list=[loss.name])
        assert _scalar(state([good])[good]) == 1.0
        for _ in range(2):
            s0 = np.float32(_scalar(state([scale])[scale]))
            mom = state(list(m1.values()) + list(m2.values()))
            exe.run(main, feed=bad, fetch_list=[loss.name])
            assert _scalar(state([scale])[scale]) == float(
                s0 * np.float32(0.8))
            assert _scalar(state([good])[good]) == 0.0
            after = state(list(m1.values()) + list(m2.values()))
            for p in params:
                np.testing.assert_array_equal(
                    after[m1[p]], np.float32(0.9) * mom[m1[p]])
                np.testing.assert_array_equal(
                    after[m2[p]], np.float32(0.999) * mom[m2[p]])


def test_decr_every_n_nan_or_inf_is_never_read():
    """Any decr_every_n_nan_or_inf builds the same program."""
    a = _mlp(ptt, "float16", init_loss_scaling=8.0,
             use_dynamic_loss_scaling=True, decr_every_n_nan_or_inf=1)[0]
    b = _mlp(ptt, "float16", init_loss_scaling=8.0,
             use_dynamic_loss_scaling=True, decr_every_n_nan_or_inf=7)[0]
    assert _ops(a) == _ops(b)


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_bf16_unit_scale_takes_the_plain_path(pkg):
    plain = _mlp(pkg, "bfloat16")
    assert plain[3].get_loss_scaling() is None
    assert "isfinite" not in {op.type for op in
                              plain[0].global_block().ops}
    scaled = _mlp(pkg, "bfloat16", init_loss_scaling=4.0)
    assert scaled[3].get_loss_scaling() is not None
    types = [op.type for op in scaled[0].global_block().ops]
    assert "isfinite" in types and "logical_and" in types
    # no dynamic update without use_dynamic_loss_scaling
    assert not [n for n in scaled[0].global_block().vars
                if n.startswith("good_steps")]


def test_custom_lists_move_ops_between_lists():
    lists = [MP[pkg].AutoMixedPrecisionLists(
        custom_white_list={"gelu"}, custom_black_list={"elementwise_add"})
        for pkg in (pt, ptt)]
    assert lists[1].white_list == lists[0].white_list
    assert lists[1].black_list == lists[0].black_list
    a = _bert(pt, DTYPES["bf16"], lists[0])[0]
    b = _bert(ptt, DTYPES["bf16"], lists[1])[0]
    _assert_same_program(a, b)
    plain = _bert(ptt, DTYPES["bf16"])[0]
    n = sum(op.type == "cast" for op in b.global_block().ops)
    assert n > sum(op.type == "cast" for op in plain.global_block().ops)
    gelu = [op for op in b.global_block().ops if op.type == "gelu"]
    assert gelu and all(b.global_block().var(op.input("X")[0]).dtype ==
                        "bfloat16" for op in gelu)


# ---------------------------------------------------------------------------
# the fp16 plain flash attention against the JAX kernel at fp16 (the Pallas
# kernel computes fp16 in f32 from the fp16 values and rounds the output:
# one fp16 rounding apart, 2^-10 relative, at most)
# ---------------------------------------------------------------------------

def _f16(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float16)


def test_plain_flash_fp16_matches_pallas_forward():
    b, h, t, d = 2, 2, 32, 16
    q, k, v = (_f16((b, h, t, d), s) for s in (4, 5, 6))
    mask = np.zeros((b, 1, 1, t), np.float32)
    mask[1, :, :, -7:] = -1e4
    got, got_lse = tfa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
        d ** -0.5, False)
    want, want_lse = jfa._pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        d ** -0.5, False, 16, 16, True)
    assert got.dtype == torch.float16
    w = np.asarray(want).astype(np.float32)
    assert np.abs(got.float().numpy() - w).max() <= \
        2.0 ** -10 * np.abs(w).max()
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** 12])
def test_plain_flash_fp16_matches_pallas_backward(do_scale):
    b, h, t, d = 2, 2, 32, 16
    q, k, v = (_f16((b, h, t, d), s) for s in (7, 8, 9))
    do = _f16((b, h, t, d), 10, do_scale)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = jfa._pallas_forward(jq, jk, jv, None, d ** -0.5, True,
                                   16, 16, True)
    want = jfa._pallas_backward(jq, jk, jv, None, out, lse, jdo,
                                d ** -0.5, True, 16, 16, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tout = torch.from_numpy(np.asarray(out))
    got = tfa.flash_attention_bwd(tq, tk, tv, None, tout,
                                  torch.from_numpy(np.asarray(lse)), tdo,
                                  d ** -0.5, True)
    for g, w in zip(got, want[:3]):
        assert g.dtype == torch.float16
        w = np.asarray(w).astype(np.float32)
        assert np.isfinite(g.float().numpy()).all()
        assert np.abs(g.float().numpy() - w).max() <= \
            2.0 ** -10 * np.abs(w).max()


def test_flash_kernel_takes_fp16_and_no_other_new_dtype():
    assert tfa._DTYPES == {torch.float32: 0, torch.bfloat16: 1,
                           torch.float16: 2}


# ---------------------------------------------------------------------------
# dtype promotion on the decorated paths: every elementwise op of a
# decorated program gives the JAX package's result dtype for a bf16/fp16
# operand against an f32 one of rank 0, 1 or full
# ---------------------------------------------------------------------------

class _Ctx(object):
    device = torch.device("cpu")

    def constant(self, make):
        return make()


_RANK_SHAPES = {"rank0": (), "rank1": (3,), "full": (4, 3)}
_LOW = {"bf16": (jnp.bfloat16, torch.bfloat16),
        "fp16": (jnp.float16, torch.float16)}


def _pair(op, low, rank, swap):
    """({slot: [jax arrays]}, {slot: [torch tensors]}, attrs) for ``op``
    with a low-precision (4, 3) operand and an f32 one of ``rank``
    (``swap``: the f32 operand first)."""
    jl, tl = _LOW[low]
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32) + 0.5
    y = np.asarray(np.random.RandomState(1).rand(*_RANK_SHAPES[rank]) + 0.5,
                   np.float32)
    jx, tx = jnp.asarray(x).astype(jl), torch.from_numpy(x).to(tl)
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    if op == "scale":     # one operand: the low one at the rank
        xr = x.reshape(-1)[:int(np.prod(_RANK_SHAPES[rank]))].reshape(
            _RANK_SHAPES[rank])
        return ({"X": [jnp.asarray(xr).astype(jl)]},
                {"X": [torch.from_numpy(np.array(xr)).to(tl)]},
                {"scale": 2.0, "bias": 1.0})
    if swap:
        (jx, tx), (jy, ty) = (jy, ty), (jx, tx)
    if op == "where":
        c = np.random.RandomState(2).rand(4, 3) > 0.5
        return ({"Condition": [jnp.asarray(c)], "X": [jx], "Y": [jy]},
                {"Condition": [torch.from_numpy(c)], "X": [tx], "Y": [ty]},
                {})
    return {"X": [jx], "Y": [jy]}, {"X": [tx], "Y": [ty]}, {"axis": -1}


_PROMOTION_CASES = [
    (op, low, rank, swap)
    for op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_div", "where", "scale")
    for low in sorted(_LOW) for rank in sorted(_RANK_SHAPES)
    for swap in ((False,) if op == "scale" else (False, True))]


@pytest.mark.parametrize("op,low,rank,swap", _PROMOTION_CASES)
def test_result_dtype_is_the_jax_packages(op, low, rank, swap):
    jins, tins, attrs = _pair(op, low, rank, swap)
    want = jget(op).fn(None, jins, attrs)["Out"]
    got = tget(op).fn(_Ctx(), tins, attrs)["Out"]
    assert str(got.dtype).split(".")[1] == str(jnp.asarray(want).dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-2)


def test_set_precision_turns_off_reduced_precision_reductions():
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, torch.backends.cudnn.allow_tf32,
             flags.allow_bf16_reduced_precision_reduction,
             flags.allow_fp16_reduced_precision_reduction,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        flags.allow_fp16_reduced_precision_reduction = True
        flags.allow_bf16_reduced_precision_reduction = True
        set_precision()
        assert flags.allow_fp16_reduced_precision_reduction is False
        assert flags.allow_bf16_reduced_precision_reduction is False
        assert flags.allow_tf32 is False
    finally:
        (flags.allow_tf32, torch.backends.cudnn.allow_tf32,
         flags.allow_bf16_reduced_precision_reduction,
         flags.allow_fp16_reduced_precision_reduction,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
