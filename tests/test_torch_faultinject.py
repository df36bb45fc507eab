"""The port's failpoint plane (paddle_tpu_torch/framework/faultinject.py)
and numeric guard (BuildStrategy check_numerics / numeric_policy through
Executor.run and run_steps) against the JAX package's.

The spec grammar and firing cases of tests/test_faultinject.py run in
both packages and must give the same fire counts, errors, corrupted
arrays and counters; ``corrupt`` and ``flip`` also act on torch tensors
(a copy, the caller's tensor untouched). The numeric-policy cases run
the JAX package's toy trainer (tests/test_faultinject.py ``_train_setup``:
fc 8 relu, fc 3, softmax cross-entropy, SGD 0.1, a dp=1 mesh) in both
packages from the JAX startup's weights: the same culprit names, the
same ``(policy, step)`` events, the same errors; "skip" bit-exact in the
port; parameters of both packages within rtol 1e-6 (f32, the same
ops; only the order of a sum may differ)."""
import contextlib
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import compiler as jcomp
from paddle_tpu.framework import faultinject as jfi
from paddle_tpu.framework import resilience as jres
from paddle_tpu_torch.framework import faultinject as tfi
from paddle_tpu_torch.framework import resilience as tres

RTOL = 1e-6
PACKAGES = [(jfi, jres), (tfi, tres)]


@pytest.fixture(autouse=True)
def _clean():
    for fi, res in PACKAGES:
        fi.disarm()
        fi.reset_counters()
        res.clear_events()
    yield
    for fi, res in PACKAGES:
        fi.disarm()
        fi.reset_counters()
        res.clear_events()


# ---------------------------------------------------------------------------
# the spec grammar and firing, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "transport.send:raise=TimeoutError/slow@3+^h2",
    "executor.step:corrupt=x@5", "coordination.hb:drop~0.25",
    "io.manifest_write:delay=0.01", "serving.infer:raise",
    "buddy.p2p_fetch:flip=w@2"])
def test_specs_parse_alike(text):
    j, t = jfi.FailSpec.parse(text), tfi.FailSpec.parse(text)
    assert repr(t) == repr(j)
    assert vars(t) == vars(j)


@pytest.mark.parametrize("text", [
    "transport.sned:raise", "transport.send:explode",
    "executor.step:corrupt", "no-colon-here"])
def test_bad_specs_raise_alike(text):
    with pytest.raises(ValueError) as je:
        jfi.FailSpec.parse(text)
    with pytest.raises(ValueError) as te:
        tfi.FailSpec.parse(text)
    assert str(te.value) == str(je.value)
    assert sorted(tfi.SITES) == sorted(jfi.SITES)
    assert {k: v.__name__ for k, v in tfi.SITES.items()} == \
        {k: v.__name__ for k, v in jfi.SITES.items()}


def _scenario(fi, res):
    """Every action and schedule form, the outcome of each hit recorded
    as a comparable value."""
    out = []

    def hit(site, payload=None, host=None):
        try:
            r = fi.hit(site, payload, host=host)
        except Exception as e:
            return ("raise", type(e).__name__, str(e))
        return "DROP" if r is fi.DROP else \
            "same" if r is payload else "other"
    assert fi.hit("transport.send") is None       # unarmed: identity
    assert fi.hits_total() == {}
    with fi.failpoints(["transport.send:raise@3"]):
        out.append([hit("transport.send") for _ in range(4)])
        out.append(fi.hits_total())
    with fi.failpoints(["coordination.hb:drop@2+^1"]):
        out.append([hit("coordination.hb", host=h)
                    for h in (0, 0, 1, "1", 1)])
    with fi.failpoints(["coordination.hb:drop^h7"]):
        with res.context(host="h7"):
            out.append(hit("coordination.hb"))
        out.append(hit("coordination.hb"))
    with fi.failpoints(["transport.send:drop~0.5"], seed=1234):
        out.append([hit("transport.send") for _ in range(64)])
    with fi.failpoints(["io.member_write:raise"]):
        out.append(hit("io.member_write"))
    with fi.failpoints(["transport.send:raise=TimeoutError/too slow"]):
        out.append(hit("transport.send"))
    with fi.failpoints(["transport.send:raise=NoSuchError"]):
        out.append(hit("transport.send"))
    with fi.failpoints(["transport.send:drop"]):
        out.append(hit("not.a.site"))
    t0 = time.perf_counter()
    with fi.failpoints(["serving.infer:delay=0.02"]):
        out.append(hit("serving.infer", {"a": 1}))
    out.append(time.perf_counter() - t0 >= 0.015)
    fi.arm(["transport.send:drop@1"])
    fi.hit("transport.send")
    before = fi.hits_total()
    with fi.failpoints(["coordination.hb:drop"]):
        fi.hit("coordination.hb")
        out.append([s.site for s in fi.schedules()])
    out.append([[s.site for s in fi.schedules()], fi.hits_total() == before])
    fi.disarm()
    out.append([(e["kind"], e["site"], e["action"], e["visit"])
                for e in res.events("failpoint")])
    return out


def test_firing_matches_the_jax_package():
    j = _scenario(jfi, jres)
    t = _scenario(tfi, tres)
    assert t == j
    assert {"DROP", "same"} == set(j[5])      # actually probabilistic


def test_env_split_matches_the_jax_package(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS",
                       "transport.send:drop@1;step:raise@2,"
                       "io.manifest_write:raise")
    monkeypatch.setenv("PADDLE_TPU_FAULT_SEED", "7")
    for fi, _ in PACKAGES:
        assert sorted(s.site for s in fi.reload_env()) == \
            ["io.manifest_write", "transport.send"]
        assert fi.armed()
        fi.disarm()
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "")
    assert tfi.reload_env() == [] and not tfi.armed()


def test_corrupt_and_flip_match_on_numpy_and_copy_torch_tensors():
    feed = {"x": np.linspace(1.0, 2.0, 6, dtype=np.float32).reshape(2, 3),
            "y": np.arange(2, dtype=np.int64),
            "d": np.ones(3, np.float64)}
    for action, name in (("corrupt", "x"), ("flip", "x"), ("corrupt", "y"),
                         ("flip", "y"), ("flip", "d"), ("corrupt", "nope")):
        outs = []
        for fi, _ in PACKAGES:
            with fi.failpoints(["executor.step:%s=%s" % (action, name)]):
                outs.append(fi.hit("executor.step", feed))
        j, t = outs
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype
            assert np.array_equal(t[k].view(np.uint8), j[k].view(np.uint8))
            if k != name:
                assert t[k] is feed[k]
        if name == "nope":
            assert t is feed
    assert np.isfinite(feed["x"]).all()             # never written
    # torch tensors: a poisoned copy, the caller's tensor untouched
    tfeed = {"x": torch.ones(2, 3), "b": torch.ones(4, dtype=torch.bfloat16),
             "i": torch.arange(3)}
    with tfi.failpoints(["executor.step:corrupt=x"]):
        out = tfi.hit("executor.step", tfeed)
    assert int(torch.isnan(out["x"]).sum()) == 1 and out["i"] is tfeed["i"]
    with tfi.failpoints(["executor.step:flip=b"]):
        out = tfi.hit("executor.step", tfeed)
    assert torch.isfinite(out["b"]).all()
    assert int((out["b"] != tfeed["b"]).sum()) == 1
    with tfi.failpoints(["executor.step:corrupt=i"]):
        out = tfi.hit("executor.step", tfeed)
    assert int(out["i"][0]) == torch.iinfo(torch.int64).max
    assert torch.equal(tfeed["x"], torch.ones(2, 3))
    assert torch.equal(tfeed["b"], torch.ones(4, dtype=torch.bfloat16))
    assert torch.equal(tfeed["i"], torch.arange(3))


def test_metrics_export_matches_the_jax_package():
    texts = []
    for fi, res in PACKAGES:
        res.clear_events()
        cold = res.metrics_text()
        assert "failpoint_hits_total" not in cold
        assert "faultinject_armed" not in cold
        with fi.failpoints(["transport.send:drop@1"]):
            fi.hit("transport.send")
            texts.append(sorted(
                line for line in res.metrics_text().splitlines()
                if "failpoint" in line or "faultinject" in line
                or "events_total" in line))
        res.clear_events()
    assert texts[1] == texts[0]
    assert 'paddle_tpu_resilience_failpoint_hits_total{site=' \
        '"transport.send"} 1' in texts[1]


# ---------------------------------------------------------------------------
# numeric_policy: raise / skip / rewind, in both packages
# ---------------------------------------------------------------------------

def _toy(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [1], dtype="int64")
        h = L.fc(x, size=8, act="relu")
        logits = L.fc(h, size=3)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


class _Pair(object):
    """The toy trainer in both packages from the JAX startup's weights,
    each behind a CompiledProgram on a dp=1 mesh."""

    def __init__(self, **bs_kw):
        jmain, jstart, self.jloss = _toy(pt)
        tmain, tstart, self.tloss = _toy(ptt)
        assert self.tloss.name == self.jloss.name
        self.jscope, self.jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(self.jscope):
            self.jexe.run(jstart)
        self.persist = sorted(v.name for v in jmain.list_vars()
                              if v.persistable)
        self.tscope = ptt.Scope()
        ptt.set_params_from_numpy(
            {n: np.asarray(self.jscope.find_var(n)) for n in self.persist},
            tmain, self.tscope, ptt.CPUPlace())
        self.texe = ptt.Executor(ptt.CPUPlace())
        jbs, tbs = jcomp.BuildStrategy(**bs_kw), ptt.BuildStrategy(**bs_kw)
        jbs.mesh_axes = tbs.mesh_axes = {"dp": 1}
        self.jcomp = jcomp.CompiledProgram(jmain, jbs)
        self.tcomp = ptt.CompiledProgram(tmain, tbs)

    def run(self, feed, spec=None, steps=False):
        """One run (or run_steps window) in each package: (jax outcome,
        port outcome), an outcome being the fetches or the error."""
        outs = []
        for fi, exe, comp, loss, scope, guard in (
                (jfi, self.jexe, self.jcomp, self.jloss, self.jscope,
                 pt.scope_guard),
                (tfi, self.texe, self.tcomp, self.tloss, self.tscope,
                 ptt.scope_guard)):
            armed = fi.failpoints([spec]) if spec else \
                contextlib.nullcontext()
            with armed, guard(scope):
                try:
                    fn = exe.run_steps if steps else exe.run
                    outs.append(fn(comp, feed={k: v.copy() for k, v in
                                               feed.items()},
                                   fetch_list=[loss]))
                except Exception as e:
                    outs.append(e)
        return outs

    def params(self):
        return ({n: np.asarray(self.jscope.find_var(n)) for n in self.persist},
                {n: self.tscope.find_var(n).numpy().copy()
                 for n in self.persist})

    def assert_params_close(self):
        j, t = self.params()
        for n in self.persist:
            np.testing.assert_allclose(t[n], j[n], rtol=RTOL, atol=1e-7,
                                       err_msg=n)


def _feed(rng, n=8):
    return {"x": rng.rand(n, 4).astype(np.float32),
            "y": rng.randint(0, 3, (n, 1)).astype(np.int64)}


def _faults(res):
    return [(e["policy"], e.get("step"), e.get("culprit"))
            for e in res.events("numeric_fault")]


def test_raise_names_the_same_culprit():
    pair = _Pair(check_numerics=True)
    feed = _feed(np.random.RandomState(0))
    pair.run(feed)
    bad = dict(feed, x=feed["x"].copy())
    bad["x"][0, 0] = np.nan
    j, t = pair.run(bad)
    assert type(j) is type(t) is FloatingPointError
    assert str(t) == str(j) and "var '" in str(t)
    assert _faults(tres) == _faults(jres)
    assert _faults(tres)[0][0] == "raise" and _faults(tres)[0][2]


def test_skip_discards_the_step_bit_exactly_as_the_jax_package():
    pair = _Pair(numeric_policy="skip")
    feed = _feed(np.random.RandomState(0))
    pair.run(feed)
    before = pair.params()[1]
    salt = pair.tscope.find_var("@EAGER_SALT@")
    j, t = pair.run(feed, "executor.step:corrupt=x@1")
    assert not np.isfinite(j[0]).all() and not np.isfinite(t[0]).all()
    after = pair.params()[1]
    for n in pair.persist:                       # the in-graph revert
        assert np.array_equal(after[n].view(np.uint8),
                              before[n].view(np.uint8)), n
    assert pair.tscope.find_var("@EAGER_SALT@") == salt   # stepped back
    for _ in range(3):
        j, t = pair.run(feed)
        np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    assert _faults(tres) == _faults(jres)
    assert [f[0] for f in _faults(tres)] == ["skip"]
    pair.assert_params_close()


def test_skip_budget_escalates_as_the_jax_package():
    pair = _Pair(numeric_policy="skip", numeric_skip_budget=2)
    feed = _feed(np.random.RandomState(0))
    pair.run(feed)
    outcomes = []
    with jfi.failpoints(["executor.step:corrupt=x@1+"]), \
            tfi.failpoints(["executor.step:corrupt=x@1+"]):
        for _ in range(3):
            outcomes.append(pair.run(feed))
    assert [type(o).__name__ for o in outcomes[2]] == \
        ["SkipBudgetExceededError"] * 2
    assert str(outcomes[2][1]) == str(outcomes[2][0])
    pair.run(feed)                     # a clean step ends the streak
    j, t = pair.run(feed, "executor.step:corrupt=x@1")
    assert not isinstance(t, Exception) and not isinstance(j, Exception)
    assert pair.texe._numeric_skips == pair.jexe._numeric_skips == 1
    assert _faults(tres) == _faults(jres)
    pair.assert_params_close()


def test_rewind_raises_the_typed_error_with_the_poisoned_state():
    pair = _Pair(numeric_policy="rewind")
    feed = _feed(np.random.RandomState(0))
    pair.run(feed)
    j, t = pair.run(feed, "executor.step:corrupt=x@1")
    for e in (j, t):
        assert isinstance(e, jres.NumericFaultError if e is j
                          else tres.NumericFaultError)
        assert isinstance(e, FloatingPointError)
    assert (t.culprit, t.window_offset, t.step) == \
        (j.culprit, j.window_offset, j.step) and t.culprit
    after = pair.params()[1]
    assert any(not np.isfinite(v).all() for v in after.values())
    assert _faults(tres) == _faults(jres)


def test_run_steps_skips_inside_the_window_as_the_jax_package():
    pair = _Pair(numeric_policy="skip")
    rng = np.random.RandomState(0)
    stacked = {"x": rng.rand(4, 8, 4).astype(np.float32),
               "y": rng.randint(0, 3, (4, 8, 1)).astype(np.int64)}
    stacked["x"][2, 0, 0] = np.nan                   # step 2 of 4
    j, t = pair.run(stacked, steps=True)
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL)
    assert _faults(tres) == _faults(jres)
    assert [f[:2] for f in _faults(tres)] == [("skip", 2)]
    assert _faults(tres)[0][2]
    pair.assert_params_close()
    # the window equals the same window run without batch 2, bit for bit
    clean = _Pair(numeric_policy="skip")
    keep = {k: np.delete(v, 2, axis=0) for k, v in stacked.items()}
    _, t2 = clean.run(keep, steps=True)
    np.testing.assert_array_equal(np.delete(t[0], 2, axis=0), t2[0])
    for n in pair.persist:
        assert np.array_equal(pair.params()[1][n], clean.params()[1][n]), n


def test_run_steps_rewind_names_the_window_offset():
    pair = _Pair(numeric_policy="rewind")
    rng = np.random.RandomState(0)
    stacked = {"x": rng.rand(3, 8, 4).astype(np.float32),
               "y": rng.randint(0, 3, (3, 8, 1)).astype(np.int64)}
    stacked["x"][1, 0, 0] = np.nan
    j, t = pair.run(stacked, steps=True)
    assert isinstance(t, tres.NumericFaultError)
    assert (t.window_offset, t.culprit) == (j.window_offset, j.culprit) \
        == (1, t.culprit)
    assert _faults(tres) == _faults(jres)


def test_skip_in_a_window_gives_the_next_step_the_skipped_draws():
    """A program with dropout: the step after a skipped one draws the
    skipped step's numbers (the run counter goes back), in ``run`` and in
    a ``run_steps`` window, so both equal the same batches run without
    the poisoned one, bit for bit."""
    def build():
        main, startup = ptt.Program(), ptt.Program()
        with ptt.unique_name.guard(), ptt.program_guard(main, startup):
            L = ptt.layers
            x = L.data("x", [4], dtype="float32")
            h = L.dropout(L.fc(x, size=16), 0.3)
            loss = L.mean(L.fc(h, size=1))
            ptt.optimizer.Adam(0.01).minimize(loss)
        return main, startup, loss
    main, startup, loss = build()
    rng = np.random.RandomState(1)
    xs = rng.rand(6, 8, 4).astype(np.float32)
    scopes = []
    for _ in range(2):
        scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        scopes.append((scope, exe))
    skip = ptt.CompiledProgram(main, ptt.BuildStrategy(
        numeric_policy="skip")).with_data_parallel()
    (gs, gexe), (cs, cexe) = scopes
    poisoned = xs.copy()
    poisoned[2, 0, 0] = np.nan
    got = [gexe.run(skip, feed={"x": poisoned[i]}, fetch_list=[loss],
                    scope=gs)[0] for i in range(3)]
    win, = gexe.run_steps(skip, feed={"x": poisoned[3:]}, fetch_list=[loss],
                          scope=gs)
    win2, = gexe.run_steps(skip, feed={"x": poisoned}, fetch_list=[loss],
                           scope=gs)
    keep = [0, 1, 3, 4, 5]
    ref = [cexe.run(main, feed={"x": xs[i]}, fetch_list=[loss],
                    scope=cs)[0] for i in keep[:2]]
    ref_win, = cexe.run_steps(main, feed={"x": xs[3:]}, fetch_list=[loss],
                              scope=cs)
    ref_win2, = cexe.run_steps(main, feed={"x": xs[keep]},
                               fetch_list=[loss], scope=cs)
    assert np.array_equal(np.stack(got[:2]), np.stack(ref))
    assert not np.isfinite(got[2]).all()
    assert np.array_equal(win, ref_win)
    assert np.array_equal(np.delete(win2, 2, axis=0), ref_win2)
    for n, v in cs.items():
        assert torch.equal(gs.find_var(n), v) if isinstance(
            v, torch.Tensor) else gs.find_var(n) == v, n


# ---------------------------------------------------------------------------
# the guard's kernels' plain versions (the CPU path; chip_smoke.py holds
# the kernels against them on the card) and the plan's written state
# ---------------------------------------------------------------------------

def test_guard_plain_versions():
    from paddle_tpu_torch.ops.kernels import numeric_guard as ng
    bad = [torch.ones(3), torch.tensor([1.0, float("nan")]),
           torch.ones(2, dtype=torch.bfloat16),
           torch.tensor([float("-inf")], dtype=torch.float64)]
    flags = torch.zeros(len(bad) + 2, dtype=torch.uint8)
    ng.finite_flags(bad, flags, None)          # a CPU tensor: plain
    assert flags.tolist() == [0, 1, 0, 1, 1, 1]
    clean = [torch.ones(3)] * 4
    ng.finite_flags(clean, flags, None)
    assert flags.tolist() == [0, 0, 0, 0, 0, 1]   # the sticky byte stays
    src = [torch.arange(4.0), torch.ones(2, dtype=torch.bfloat16)]
    for gate, want in ((None, src), (torch.zeros(1, dtype=torch.uint8),
                                     None),
                       (torch.ones(1, dtype=torch.uint8), src)):
        dst = [torch.full((4,), -1.0),
               torch.zeros(2, dtype=torch.bfloat16)]
        before = [d.clone() for d in dst]
        ng.guarded_copy(list(zip(src, dst)), None, gate=gate)
        for d, w in zip(dst, want or before):
            assert torch.equal(d, w)
    assert all(ng.is_guarded_dtype(d) for d in (
        torch.float32, torch.bfloat16, torch.float16, torch.float64))
    assert not ng.is_guarded_dtype(torch.int64)


def test_the_plan_knows_every_persistable_a_step_writes():
    """``_RunPlan.writes`` (decided once from the blocks) holds every
    persistable a step changes: what "skip" keeps and reverts."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        L = ptt.layers
        x = L.data("x", [4], dtype="float32")
        lr = L.linear_lr_warmup(L.polynomial_decay(0.1, 10), 2, 0.0, 0.1)
        loss = L.mean(L.fc(L.fc(x, 8, act="relu"), 1))
        ptt.optimizer.AdamW(lr, weight_decay=0.01).minimize(loss)
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    before = {n: v.clone() for n, v in scope.items()
              if isinstance(v, torch.Tensor)}
    exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[loss], scope=scope)
    changed = {n for n, v in before.items()
               if not torch.equal(v, scope.find_var(n))}
    plan = exe._plan(main, [loss.name], True)
    assert changed and changed <= set(plan.writes)
    assert set(plan.writes) <= set(plan.persistable)
