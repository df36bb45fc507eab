"""The averaging wrappers: the port against the JAX package.

``ExponentialMovingAverage``, ``LookaheadOptimizer``, ``ModelAverage``
(with its ``average_accumulates`` op) and ``RecomputeOptimizer`` build
the same programs in both packages and, from the same weights (copied
with ``set_params_from_numpy``), keep the same state step by step: f32
values within rtol 1e-6 / atol 1e-7 (the same elementwise formulas over
a tiny fc program, summed in another order in the matmuls' gradients),
counters exactly. ``apply``/``restore`` give the JAX package's values
but move values, never tensors: no scope tensor is bound under two
names, and the backup is a copy of its own.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.ops import registry as treg
from test_torch_bert_training import _normalized

importlib.import_module("paddle_tpu.ops.optimizer_ops")

RTOL, ATOL = 1e-6, 1e-7
STEPS = 3


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

# (num_accumulates, old_num_accumulates, num_updates, rate, min_w, max_w)
_ACC_CASES = {
    # num_updates reaches 16384: sum_1 spills into sum_2
    "spill": (7, 3, 16383, 0.5, 10000, 10000),
    # num_accumulates reaches min_w = int(11 * 0.9): the window closes
    "trigger": (9, 4, 10, 0.9, 10, 20),
    # one short of the window: nothing moves to sum_3
    "below_window": (8, 4, 10, 0.9, 10, 20),
    # the window truncates 67 * 0.15 = 10.05 to 10 and caps at max_w
    "truncated_window": (9, 0, 66, 0.15, 2, 40),
    "capped_window": (4, 1, 99, 0.5, 2, 5),
    # a spill and a trigger in one update
    "spill_and_trigger": (9, 2, 16383, 1e-4, 10, 10),
}


@pytest.mark.parametrize("case", sorted(_ACC_CASES))
def test_average_accumulates_matches_jax(case):
    num_acc, old_acc, num_upd, rate, min_w, max_w = _ACC_CASES[case]
    rng = np.random.RandomState(len(case))
    ins = {"param": rng.randn(5, 3), "in_sum_1": rng.randn(5, 3),
           "in_sum_2": rng.randn(5, 3), "in_sum_3": rng.randn(5, 3)}
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    for slot, v in (("in_num_accumulates", num_acc),
                    ("in_old_num_accumulates", old_acc),
                    ("in_num_updates", num_upd)):
        ins[slot] = np.array([v], np.int32)
    attrs = {"average_window": rate, "min_average_window": min_w,
             "max_average_window": max_w}
    want = jreg.get_op("average_accumulates").fn(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    got = treg.get_op("average_accumulates").fn(
        None, {k: [torch.from_numpy(v.copy())] for k, v in ins.items()},
        attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        assert str(got[slot].dtype).split(".")[-1] == str(want[slot].dtype)
        _close(to_numpy(got[slot]), want[slot], slot)
    moved = not np.array_equal(np.asarray(want["out_sum_3"]),
                               ins["in_sum_3"])
    assert moved == (case in ("trigger", "truncated_window",
                              "capped_window", "spill_and_trigger"))


# ---------------------------------------------------------------------------
# the classes, on a tiny fc program in both packages
# ---------------------------------------------------------------------------

def _fc_program(pkg, wrap):
    """A two-layer fc regression trained by Adam(0.05) under ``wrap(pkg,
    inner optimizer, loss)``, which minimizes and returns the wrapper."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4, 8], append_batch_size=False)
        h = pkg.layers.fc(x, 16, act="tanh")
        y = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(pkg.layers.square(y - 0.5))
        wrapper = wrap(pkg, pkg.optimizer.Adam(0.05), loss)
    return main, startup, loss, wrapper


def _ema(pkg, opt, loss):
    opt.minimize(loss)
    ema = pkg.optimizer.ExponentialMovingAverage(0.9)
    ema.update()
    return ema


def _lookahead(pkg, opt, loss):
    la = pkg.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=2)
    la.minimize(loss)
    return la


def _model_average(pkg, opt, loss):
    opt.minimize(loss)
    return pkg.optimizer.ModelAverage(0.5, min_average_window=2,
                                      max_average_window=3)


def _recompute(pkg, opt, loss):
    rec = pkg.optimizer.RecomputeOptimizer(opt)
    rec._set_checkpoints([loss])
    rec.minimize(loss)
    return rec


_WRAPS = {"ema": _ema, "lookahead": _lookahead,
          "model_average": _model_average, "recompute": _recompute}
_FEED = {"x": np.random.RandomState(1).randn(4, 8).astype(np.float32)}


def _both(name, steps=STEPS, inspect=None):
    """Build ``name``'s program in both packages, start the JAX one and
    copy its persistables into the port; run ``steps`` steps in each,
    calling ``inspect(jax side, port side)`` after every step. Each side
    is (main, scope, wrapper, executor)."""
    jmain, jstart, jloss, jw = _fc_program(pt, _WRAPS[name])
    tmain, tstart, tloss, tw = _fc_program(ptt, _WRAPS[name])
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    ptt.set_params_from_numpy(
        {v.name: np.asarray(jscope.find_var(v.name))
         for v in jmain.list_vars() if v.persistable}, tmain, tscope,
        ptt.CPUPlace())
    jside = (jmain, jscope, jw, jexe)
    tside = (tmain, tscope, tw, texe)
    for _ in range(steps):
        with pt.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=_FEED, fetch_list=[jloss])
        with ptt.scope_guard(tscope):
            tl, = texe.run(tmain, feed=_FEED, fetch_list=[tloss])
        _close(tl, jl, "loss")
        if inspect is not None:
            inspect(jside, tside)
    return jside, tside


def _state_equal(jside, tside, names=None):
    jmain, jscope = jside[:2]
    tscope = tside[1]
    names = names or [v.name for v in jmain.list_vars() if v.persistable]
    for n in names:
        _close(to_numpy(tscope.find_var(n)), np.asarray(jscope.find_var(n)),
               n)


def test_ema_accumulators_match_jax():
    jside, tside = _both("ema", inspect=_state_equal)
    ema_names = sorted(v.name for v in tside[2]._ema_vars.values())
    assert ema_names == sorted(v.name for v in jside[2]._ema_vars.values())
    assert len(ema_names) == len(tside[0].all_parameters()) == 4
    # the accumulators moved away from their start at 0
    assert all(np.abs(to_numpy(tside[1].find_var(n))).max() > 1e-3
               for n in ema_names)


def test_lookahead_syncs_every_k_steps_like_jax():
    slow = []

    def inspect(jside, tside):
        _state_equal(jside, tside)
        tscope = tside[1]
        names = sorted(n for n in tscope.keys() if ".slow" in n)
        slow.append({n: to_numpy(tscope.find_var(n)) for n in names})
    _both("lookahead", inspect=inspect)
    assert len(slow[0]) == 4
    # step 1: no sync, the slow weights keep their start at 0; step 2:
    # the sync writes them; step 3: no sync again
    assert all(not v.any() for v in slow[0].values())
    assert all(v.any() for v in slow[1].values())
    assert all(np.array_equal(slow[1][n], slow[2][n]) for n in slow[1])


def test_model_average_sums_counters_and_apply_match_jax():
    counts = []

    def inspect(jside, tside):
        _state_equal(jside, tside)
        tscope = tside[1]
        accs = next(iter(tside[2]._accs.values()))
        counts.append([int(to_numpy(tscope.find_var(accs[s].name))[0])
                       for s in ("num_accumulates", "old_num_accumulates",
                                 "num_updates")])
    jside, tside = _both("model_average", steps=4, inspect=inspect)
    # the window (min 2, max 3, rate 0.5) closes at the 2nd and 4th updates
    assert counts == [[1, 0, 1], [0, 2, 2], [1, 2, 3], [0, 2, 4]]
    jmain, jscope, jma, jexe = jside
    tmain, tscope, tma, texe = tside
    params = [p.name for p in tmain.all_parameters()]
    with pt.scope_guard(jscope):
        with jma.apply(jexe):
            javg = {n: np.asarray(jscope.find_var(n)) for n in params}
        jafter = {n: np.asarray(jscope.find_var(n)) for n in params}
    before = {n: tscope.find_var(n).clone() for n in params}
    with ptt.scope_guard(tscope):
        with tma.apply(texe):
            for n in params:
                _close(to_numpy(tscope.find_var(n)), javg[n], n)
    for n in params:
        _close(to_numpy(tscope.find_var(n)), jafter[n], n)
        assert torch.equal(tscope.find_var(n), before[n])


def test_recompute_optimizer_records_checkpoints_and_delegates():
    jside, tside = _both("recompute", inspect=_state_equal)
    loss_name = [n for n in tside[0]._recompute_checkpoints]
    assert loss_name == jside[0]._recompute_checkpoints
    assert len(loss_name) == 1 and loss_name[0].startswith("mean")
    # the inner optimizer's own program: no op of the wrapper's
    plain = _fc_program(ptt, lambda pkg, opt, loss: opt.minimize(loss))[0]
    assert _normalized(plain) == _normalized(tside[0])


@pytest.mark.parametrize("name", ["ema", "model_average"])
def test_apply_and_restore_move_values_not_tensors(name):
    """Under ``apply`` every scope tensor stays bound under its one name
    and holds the average; an in-place write to a parameter under
    ``apply`` (what a replayed step does to its static inputs) reaches
    neither the accumulators nor the restored values."""
    _, tside = _both(name, steps=2)
    tmain, tscope, wrapper, texe = tside
    params = [p.name for p in tmain.all_parameters()]
    before = {n: (v, v.clone()) for n, v in tscope.items()
              if isinstance(v, torch.Tensor)}
    with ptt.scope_guard(tscope):
        with wrapper.apply(texe):
            tensors = [v for v in tscope.items()
                       if isinstance(v[1], torch.Tensor)]
            assert len({id(v) for _, v in tensors}) == len(tensors)
            assert all(tscope.find_var(n) is t for n, (t, _) in
                       before.items())
            for n in params:
                tscope.find_var(n).add_(100.0)
    for n, (t, value) in before.items():
        assert tscope.find_var(n) is t, n
        assert torch.equal(t, value), n
