"""The port's resilience layer (paddle_tpu_torch/framework/resilience.py
and the checkpoint hooks of io.py) against the JAX package's: the
legacy injector's spec grammar and firing, RetryPolicy's delays (equal
for the same seed, exactly; the sleep is injected, so nothing sleeps),
classify, the event log and its metrics round-tripping through
parse_metrics_text, and ResilientTrainer on the JAX package's toy
trainer (tests/test_resilience.py): a preemption, a collective timeout
and a NaN at step 6 recover bit-identical to the uninterrupted run, so
do run_steps windows and a torn checkpoint write; the restart budget, a
fatal error and a pre-filled directory behave as there; the
numeric_policy="rewind" contract (the poisoned batch skipped on
replay). The port's final weights are held against the JAX trainer's
from the same startup within rtol 1e-6 (f32 Adam on the same ops)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import faultinject as jfi
from paddle_tpu.framework import resilience as jres
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu_torch.framework import faultinject as tfi
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.framework.watchdog import CollectiveTimeoutError

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean():
    for res, fi in ((jres, jfi), (tres, tfi)):
        res.install(None)
        res.clear_events()
        fi.disarm()
    yield
    for res, fi in ((jres, jfi), (tres, tfi)):
        res.install(None)
        res.clear_events()
        fi.disarm()


def _fast_policy(res, **kw):
    kw.setdefault("base_delay_s", 0.0)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("sleep", lambda s: None)
    return res.RetryPolicy(**kw)


# ---------------------------------------------------------------------------
# FaultSpec / FaultInjector / RetryPolicy / classify / events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["step:preempt@5", "serve:slow=2.5@3",
                                  "step:nan~0.25", "ckpt_write:io_error",
                                  "warp_core:breach@1", "step:io_error@1",
                                  "just-garbage"])
def test_fault_spec_parses_alike(text):
    outcome = []
    for res in (jres, tres):
        try:
            outcome.append(repr(res.FaultSpec.parse(text)))
        except ValueError as e:
            outcome.append(("ValueError", str(e)))
    assert outcome[1] == outcome[0]


def _fire_all(res, specs, calls):
    inj = res.FaultInjector(specs, seed=3)
    out = []
    for point in calls:
        try:
            out.append(inj.fire(point, what="w"))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out, inj.counts(), [
        (e["point"], e["fault"], e["call"]) for e in res.events("fault")]


def test_injector_fires_alike():
    specs = ("step:preempt@3;step:collective_timeout@5,step:nan@6;"
             "step:die@7;ckpt_write:io_error@2;serve:error@1;"
             "serve:slow=0.5@2;step:preempt~0.3")
    calls = ["step"] * 12 + ["ckpt_write"] * 3 + ["serve"] * 3
    j, t = _fire_all(jres, specs, calls), _fire_all(tres, specs, calls)
    assert t == j
    assert ("SimulatedPreemptionError",
            "injected preemption at step call 3 (w)") in t[0]


def test_retry_policy_delays_equal_the_jax_package_exactly():
    for kw in (dict(seed=0), dict(seed=7, jitter=0.9, multiplier=3.0),
               dict(seed=1, base_delay_s=0.2, max_delay_s=0.5)):
        delays = [[p.delay_s(a) for a in range(8)]
                  for p in (jres.RetryPolicy(**kw), tres.RetryPolicy(**kw))]
        assert delays[1] == delays[0]
    slept = {}
    for res in (jres, tres):
        calls, naps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("down")
            return "up"
        policy = res.RetryPolicy(max_attempts=4, seed=5, sleep=naps.append)
        assert policy.call(flaky, what="flaky") == "up"
        slept[res.__name__] = (naps, [(e["attempt"], e["backoff_s"])
                                      for e in res.events("retry")])
    assert slept[tres.__name__] == slept[jres.__name__]
    with pytest.raises(ValueError, match="max_attempts"):
        tres.RetryPolicy(max_attempts=0)


def test_classify_matches_the_jax_package():
    errors = [CollectiveTimeoutError(), tres.SimulatedPreemptionError(),
              tres.ServerOverloadedError(), OSError(), TimeoutError(),
              ConnectionError(), FloatingPointError(),
              tres.NumericFaultError("x"), tres.DeadlineExceededError(),
              ValueError(), TypeError(), KeyError(), IndexError(),
              NotImplementedError(), AssertionError(), RuntimeError(),
              tres.SimulatedHostDeathError(), ptt.NotPortedError()]
    twins = {"CollectiveTimeoutError": jres.CollectiveTimeoutError,
             "NotPortedError": NotImplementedError}
    for e in errors:
        name = type(e).__name__
        twin = twins.get(name) or getattr(jres, name, None) or type(e)
        assert tres.classify(e) == jres.classify(twin(*e.args)), name


def test_event_log_metrics_round_trip():
    samples = {}
    for res in (jres, tres):
        res.clear_events()
        # the verifier's cumulative counters (what earlier programs of
        # this process produced) are no part of the event log
        res.clear_analysis()
        with res.context(host="h1"):
            res.record_event("fault", point="step", fault="preempt")
        res.record_event("restore", step=3, latency_s=0.2)
        res.record_event("numeric_fault", policy="skip",
                         culprit='odd "name"\n}')
        res.record_bytes("ckpt", 100, 40)
        text = res.metrics_text()
        parsed = res.parse_metrics_text(text)
        samples[res.__name__] = sorted(
            (n, sorted(lbl.items()), v) for n, lbl, v in parsed
            if "executor_step" not in n)
        assert res.events("fault")[0]["host"] == "h1"
        res.clear_events()
        assert res.events() == [] and res.bytes_totals() == {}
    assert samples[tres.__name__] == samples[jres.__name__]
    assert ("paddle_tpu_resilience_numeric_fault_total",
            [("culprit", 'odd "name"\n}'), ("policy", "skip")], 1.0) in \
        samples[tres.__name__]


def test_run_with_deadline():
    import threading
    assert tres.run_with_deadline(lambda: 41 + 1, 5.0) == 42
    assert tres.run_with_deadline(lambda: "no bound", None) == "no bound"
    gate = threading.Event()
    with pytest.raises(tres.DeadlineExceededError, match="deadline"):
        tres.run_with_deadline(gate.wait, 0.02, what="slow body")
    gate.set()
    assert tres.events("deadline")[-1]["what"] == "slow body"


# ---------------------------------------------------------------------------
# ResilientTrainer
# ---------------------------------------------------------------------------

def _toy_program(pkg, dropout=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [1], dtype="float32")
        if dropout:
            x = L.dropout(x, 0.25)
        pred = L.fc(x, size=1, param_attr=pkg.ParamAttr(name="res_w"),
                    bias_attr=pkg.ParamAttr(name="res_b"))
        loss = L.reduce_mean(L.square(pred - y))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _toy_feeds(n, batch=4):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        xv = rng.randn(batch, 4).astype(np.float32)
        out.append({"x": xv, "y": (xv @ w).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def toy():
    """The port's toy trainer and the JAX startup's weights."""
    jmain, jstart, _ = _toy_program(pt)
    jscope = JScope()
    with jscope_guard(jscope):
        pt.Executor(pt.CPUPlace()).run(jstart)
    weights = {v.name: np.asarray(jscope.find_var(v.name))
               for v in jmain.list_vars() if v.persistable}
    main, startup, loss = _toy_program(ptt)
    return main, startup, loss, weights


def _train(toy, ckpt_dir, feeds, target=None, **kw):
    """ResilientTrainer over ``feeds`` from the JAX startup's weights:
    (fetches, final res_w, the scope)."""
    main, _, loss, weights = toy
    kw.setdefault("checkpoint_every", 3)
    kw.setdefault("retry_policy", _fast_policy(tres))
    scope = ptt.Scope()
    ptt.set_params_from_numpy(weights, main, scope, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    trainer = tres.ResilientTrainer(exe, target or main, ckpt_dir,
                                    fetch_list=[loss], scope=scope, **kw)
    fetches = trainer.run(feeds)
    return fetches, scope.find_var("res_w").numpy().copy(), scope


def _same_fetches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("spec", ["step:preempt@6",
                                  "step:collective_timeout@6",
                                  "step:nan@6"])
def test_injected_step_fault_recovers_bitwise_identical(tmp_path, toy,
                                                        spec):
    feeds = _toy_feeds(8)
    ref_fetches, ref_w, _ = _train(toy, str(tmp_path / "ref"), feeds)
    with tres.inject(spec):
        got_fetches, got_w, _ = _train(toy, str(tmp_path / "chaos"), feeds)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches)
    assert len(tres.events("fault")) == 1
    assert len(tres.events("restart")) == 1
    assert tres.events("restore")[-1]["step"] == 3
    # the JAX package's trainer from the same weights, the same fault
    jmain, jstart, jloss = _toy_program(pt)
    with jres.inject(spec), jscope_guard(JScope()):
        jexe = pt.Executor(pt.CPUPlace())
        jexe.run(jstart)
        for n, v in toy[3].items():
            pt.global_scope().set_var(n, v)
        trainer = jres.ResilientTrainer(
            jexe, jmain, str(tmp_path / "jax"), fetch_list=[jloss],
            checkpoint_every=3, retry_policy=_fast_policy(jres))
        jfetches = trainer.run(feeds)
        jw = np.asarray(pt.global_scope().find_var("res_w"))
    np.testing.assert_allclose(got_w, jw, rtol=RTOL)
    np.testing.assert_allclose(
        np.ravel([f[0] for f in got_fetches]),
        np.ravel([np.asarray(f[0]) for f in jfetches]), rtol=RTOL)


def test_recovery_through_run_steps_windows(tmp_path, toy):
    feeds = _toy_feeds(8)
    kw = dict(steps_per_dispatch=2, checkpoint_every=2)
    ref_fetches, ref_w, _ = _train(toy, str(tmp_path / "ref"), feeds, **kw)
    with tres.inject("step:preempt@3"):   # the third dispatched window
        got_fetches, got_w, _ = _train(toy, str(tmp_path / "chaos"), feeds,
                                       **kw)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches)
    assert tres.events("restore")[-1]["step"] == 4


def test_recovery_on_compiled_program_with_a_timeout(tmp_path, toy):
    """A CompiledProgram with collective_timeout_s armed (never trips on
    the CPU): the injected CollectiveTimeoutError restores and replays;
    with dropout, the replay draws the uninterrupted run's numbers."""
    main = toy[0]
    feeds = _toy_feeds(6)

    def compiled():
        return ptt.CompiledProgram(main, ptt.BuildStrategy(
            collective_timeout_s=120.0)).with_data_parallel()
    ref_fetches, ref_w, _ = _train(toy, str(tmp_path / "ref"), feeds,
                                   compiled(), checkpoint_every=2)
    with tres.inject("step:collective_timeout@4"):
        got_fetches, got_w, _ = _train(toy, str(tmp_path / "chaos"), feeds,
                                       compiled(), checkpoint_every=2)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches)
    assert tres.events("restore")[-1]["step"] == 2


def test_dropout_replays_draw_the_uninterrupted_numbers(tmp_path):
    main, startup, loss = _toy_program(ptt, dropout=True)
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope0)
    weights = {v.name: scope0.find_var(v.name)
               for v in main.list_vars() if v.persistable}
    toy = (main, startup, loss, weights)
    feeds = _toy_feeds(7)
    ref_fetches, ref_w, ref_scope = _train(toy, str(tmp_path / "r"), feeds)
    with tres.inject("step:preempt@5"):
        got_fetches, got_w, scope = _train(toy, str(tmp_path / "c"), feeds)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches)
    assert scope.find_var("@EAGER_SALT@") == ref_scope.find_var(
        "@EAGER_SALT@")


def test_restart_budget_exhaustion(tmp_path, toy):
    with tres.inject("step:preempt~1.0"):   # every dispatch dies
        with pytest.raises(tres.RestartBudgetExceededError,
                           match="restart budget"):
            _train(toy, str(tmp_path), _toy_feeds(4), max_restarts=2)
    assert len(tres.events("restart")) == 2
    assert len(tres.events("giveup")) == 1


def test_fatal_error_is_not_retried(tmp_path, toy):
    feeds = _toy_feeds(4)
    feeds[2]["x"] = np.zeros((4, 4, 9), np.float32)   # wrong rank: a bug
    with pytest.raises(ValueError, match="rank"):
        _train(toy, str(tmp_path), feeds)
    assert tres.events("restart") == []
    assert len(tres.events("fatal")) == 1


@pytest.mark.parametrize("torn", ["legacy", "failpoint"])
def test_torn_checkpoint_write_recovers(tmp_path, toy, torn):
    """An I/O fault mid-commit (shards on disk, no manifest): the trainer
    rolls back to the previous valid checkpoint and converges to the
    uninterrupted result; the torn dir is never restored from."""
    feeds = _toy_feeds(6)
    ref_fetches, ref_w, _ = _train(toy, str(tmp_path / "ref"), feeds)
    # commit 1 = the step-0 baseline; commit 2 = the step-3 save
    ctx = tres.inject("ckpt_write:io_error@2") if torn == "legacy" else \
        tfi.failpoints(["io.manifest_write:raise@2"])
    with ctx:
        got_fetches, got_w, _ = _train(toy, str(tmp_path / "chaos"), feeds)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches)
    assert tres.events("restore")[-1]["step"] == 0
    raw, wire = tres.bytes_totals()["ckpt"]["raw"], \
        tres.bytes_totals()["ckpt"]["wire"]
    assert raw > 0 and wire > 0


def test_a_torn_dir_a_restore_tries_is_quarantined(tmp_path, toy):
    main, _, loss, weights = toy
    scope = ptt.Scope()
    ptt.set_params_from_numpy(weights, main, scope, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    d = str(tmp_path)
    ptt.io.save_checkpoint(exe, d, main, step=0, scope=scope)
    with tfi.failpoints(["io.manifest_write:raise@1"]):
        with pytest.raises(OSError):
            ptt.io.save_checkpoint(exe, d, main, step=3, scope=scope)
    report = ptt.io.scrub_checkpoint(d)
    assert report["steps"][3]["status"] == "incomplete"
    assert tres.events("scrub")[-1]["incomplete"] == 1
    import os
    os.remove(os.path.join(d, "latest"))       # a lost pointer
    assert ptt.io.load_checkpoint(exe, d, main, scope=scope) == 0
    assert [e["step_dir"] for e in tres.events("ckpt_quarantine")] == \
        ["step_3"]


def test_trainer_rejects_prepopulated_ckpt_dir(tmp_path, toy):
    main, _, loss, weights = toy
    scope = ptt.Scope()
    ptt.set_params_from_numpy(weights, main, scope, ptt.CPUPlace())
    trainer = tres.ResilientTrainer(ptt.Executor(ptt.CPUPlace()), main,
                                    str(tmp_path), fetch_list=[loss],
                                    scope=scope,
                                    retry_policy=_fast_policy(tres))
    trainer.run(_toy_feeds(2))
    with pytest.raises(ValueError, match="already holds checkpoints"):
        trainer.run(_toy_feeds(2))


def test_trainer_requires_fetch_list_and_refuses_a_sharded_feed(tmp_path,
                                                                toy):
    main = toy[0]
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(ValueError, match="fetch_list"):
        tres.ResilientTrainer(exe, main, str(tmp_path)).run(_toy_feeds(2))
    with pytest.raises(ptt.NotPortedError, match="torch.distributed"):
        tres.ResilientTrainer(exe, main, str(tmp_path), feed=object())
    with pytest.raises(ValueError, match="ShardedFeed"):
        tres.ResilientTrainer(exe, main, str(tmp_path),
                              fetch_list=[toy[2]]).run()


@pytest.mark.parametrize("window", [1, 2])
def test_rewind_replays_without_the_poison_batch(tmp_path, toy, window):
    """numeric_policy="rewind": the poisoned batch raises
    NumericFaultError, the trainer restores and replays without it, and
    the result equals the uninterrupted run of the other batches bit for
    bit (its slot reports None)."""
    main = toy[0]
    feeds = _toy_feeds(8)
    clean = [f for i, f in enumerate(feeds) if i != 4]
    ref_fetches, ref_w, ref_scope = _train(toy, str(tmp_path / "ref"),
                                           clean)
    poisoned = list(feeds)
    poisoned[4] = dict(feeds[4], x=feeds[4]["x"].copy())
    poisoned[4]["x"][0, 0] = np.nan
    rewind = ptt.CompiledProgram(main, ptt.BuildStrategy(
        numeric_policy="rewind")).with_data_parallel()
    got_fetches, got_w, scope = _train(toy, str(tmp_path / "chaos"),
                                       poisoned, rewind,
                                       steps_per_dispatch=window)
    np.testing.assert_array_equal(got_w, ref_w)
    _same_fetches(got_fetches, ref_fetches[:4] + [None] + ref_fetches[4:])
    assert [e["batch"] for e in tres.events("poison_batch")] == [4]
    assert [e["batch"] for e in tres.events("poison_skip")] == [4]
    assert tres.events("restore")[-1]["step"] == 3
    for n, v in ref_scope.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(scope.find_var(n), v), n
