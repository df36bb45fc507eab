"""The learning-rate schedules: the port against the JAX package and the
closed form.

Each schedule of paddle_tpu/layers/learning_rate_scheduler.py is built in
both packages (equal programs: the same ops, attrs and var names, the
counter's ``increment`` and its int64 initializer included) and its rate
fetched for 8 runs of each; both must equal the closed form at the
counter's value. Tolerance rtol 1e-6, with an absolute 1e-7 of the
schedule's largest rate: both compute in f32, and the JAX package's XLA
turns a divide by a constant into a multiply by its reciprocal, which
leaves ~1e-7 relative, and a polynomial decay that reaches 0 exactly
ends at -1.5e-8 of its rate there.

The JAX package's ``autoincreased_step_counter`` appends an increment of
the shared ``@LR_DECAY_COUNTER@`` at every call, so a schedule built on
another (``linear_lr_warmup`` of a ``polynomial_decay``) advances the
counter twice a run: the inner schedule reads 2k and the warmup 2k + 1
at run k. The port carries that, and the last case pins it.
"""
import math

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bert_training import _normalized

STEPS = 8


def _poly(lr, end, power, decay_steps, cycle):
    def f(s):
        if cycle:
            ds = decay_steps * max(math.ceil(s / decay_steps), 1)
        else:
            ds, s = decay_steps, min(s, decay_steps)
        return (lr - end) * (1 - s / ds) ** power + end
    return f


def _warm(lr, warmup, start, end):
    return lambda s, after: start + (end - start) * s / warmup \
        if s < warmup else after


# name -> (build(layers), closed form of the rate at counter value s,
#          the counter's first value)
_SCHEDULES = {
    "noam": (lambda L: L.noam_decay(64, 4, learning_rate=2.0),
             lambda s: 2.0 * 64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5), 1),
    "exponential": (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * 0.5 ** (s / 3), 0),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * 0.5 ** (s // 3), 0),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 3, 0.5),
                    lambda s: 0.1 * math.exp(-0.5 * s / 3), 0),
    "natural_exp_staircase": (
        lambda L: L.natural_exp_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 * math.exp(-0.5 * (s // 3)), 0),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 3, 0.5),
                     lambda s: 0.1 / (1 + 0.5 * s / 3), 0),
    "inverse_time_staircase": (
        lambda L: L.inverse_time_decay(0.1, 3, 0.5, staircase=True),
        lambda s: 0.1 / (1 + 0.5 * (s // 3)), 0),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0),
                   _poly(0.1, 0.01, 2.0, 5, False), 0),
    "polynomial_linear": (lambda L: L.polynomial_decay(0.1, 5, 0.0),
                          _poly(0.1, 0.0, 1.0, 5, False), 0),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 3, 0.01, power=2.0, cycle=True),
        _poly(0.1, 0.01, 2.0, 3, True), 0),
    "piecewise": (lambda L: L.piecewise_decay([2, 5], [0.1, 0.05, 0.01]),
                  lambda s: 0.1 if s < 2 else 0.05 if s < 5 else 0.01, 0),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 4),
               lambda s: 0.1 * 0.5 * (math.cos((s // 2) * math.pi / 4) + 1),
               0),
    "linear_warmup": (lambda L: L.linear_lr_warmup(0.1, 3, 0.0, 0.1),
                      lambda s: _warm(0.1, 3, 0.0, 0.1)(s, 0.1), 0),
}


def _warmup_of_poly(L):
    return L.linear_lr_warmup(L.polynomial_decay(1e-4, 6, 0.0), 2, 0.0,
                              1e-4)


def _warmup_of_poly_closed(k):
    """Run k: the decay reads counter 2k, the warmup 2k + 1."""
    return _warm(1e-4, 2, 0.0, 1e-4)(2 * k + 1,
                                      _poly(1e-4, 0.0, 1.0, 6, False)(2 * k))


def _rates(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        lr = build(pkg.layers)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        rates = [float(np.asarray(exe.run(main, fetch_list=[lr])[0])
                       .reshape(())) for _ in range(STEPS)]
    return main, startup, rates


@pytest.mark.parametrize("name", sorted(_SCHEDULES) + ["warmup_of_poly"])
def test_schedule_matches_jax_and_closed_form(name):
    if name == "warmup_of_poly":
        build, want = _warmup_of_poly, [_warmup_of_poly_closed(k)
                                        for k in range(STEPS)]
    else:
        build, closed, first = _SCHEDULES[name]
        want = [closed(first + k) for k in range(STEPS)]
    jmain, jstart, jrates = _rates(pt, build)
    tmain, tstart, trates = _rates(ptt, build)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    atol = 1e-7 * max(abs(w) for w in want)
    np.testing.assert_allclose(trates, want, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(jrates, want, rtol=1e-6, atol=atol)


def test_schedule_rate_stays_a_device_tensor_and_counter_int64():
    """The rate is an f32 tensor the update op reads where it lies (no
    host value); the counter keeps int64 across runs."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        lr = ptt.layers.polynomial_decay(0.1, 5)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run(main, fetch_list=[lr], scope=scope, return_numpy=False)
    counter = scope.find_var("@LR_DECAY_COUNTER@")
    assert out.dtype.is_floating_point and out.shape == (1,)
    assert str(counter.dtype) == "torch.int64" and int(counter[0]) == 0
    assert [op.attrs.get("op_role") for op in main.global_block().ops
            if op.type == "increment"] == ["lr_sched"]
