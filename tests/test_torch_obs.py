"""The port's spans engine (paddle_tpu_torch/framework/obs.py) and the
Executor's phase spans, against the JAX package's.

The engine cases of tests/test_obs.py that need no process or server run
against the port's engine (nesting and parentage, the shared no-op when
disabled, the ring bound and its dropped counter on the metrics surface,
the header round trip, the Chrome-trace merge, the clock-offset probe
through a request function). The Executor cases run the same toy
programs through both packages' Executors on the CPU: the same
``exec.step`` labels ("miss" then "hit"), one ``exec.compile`` under the
miss, ``exec.execute`` and ``exec.writeback`` under every step, and the
same counts in the ``executor_step_seconds`` histogram. No tolerance:
the comparisons are of labels, parentage and counts.
"""
import collections
import json
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import obs as jobs
from paddle_tpu.framework import resilience as jres
from paddle_tpu_torch.framework import obs, resilience

ENGINES = [(jobs, jres), (obs, resilience)]


@pytest.fixture(autouse=True)
def _clean():
    for eng, res in ENGINES:
        res.clear_events()
        res.clear_exec()
        eng.disable()
        eng.clear()
        eng.set_clock_offset(0.0)
    yield
    for eng, res in ENGINES:
        eng.disable()
        eng.clear()
        eng.set_clock_offset(0.0)
        res.clear_exec()


def test_span_nesting_parentage_and_labels():
    obs.enable("unit")
    with obs.span("outer", k=1) as outer:
        assert obs.current() == (outer.trace, outer.id)
        with obs.span("inner") as inner:
            inner.set(extra="x")
        with pytest.raises(RuntimeError):
            with obs.span("failing"):
                raise RuntimeError("boom")
    got = {s["name"]: s for s in obs.spans()}
    assert set(got) == {"outer", "inner", "failing"}
    assert got["inner"]["parent"] == got["outer"]["id"]
    assert got["failing"]["parent"] == got["outer"]["id"]
    assert got["inner"]["trace"] == got["outer"]["trace"]
    assert got["outer"]["parent"] is None
    assert got["outer"]["labels"] == {"k": 1}
    assert got["inner"]["labels"]["extra"] == "x"
    assert got["failing"]["labels"]["error"] == "RuntimeError"
    for s in got.values():
        assert s["t1"] >= s["t0"]
    assert got["outer"]["t0"] <= got["inner"]["t0"]
    assert got["inner"]["t1"] <= got["outer"]["t1"]


def test_disabled_records_nothing_and_is_the_shared_noop():
    assert not obs.enabled()
    a = obs.span("x")
    b = obs.span("y", label=1)
    assert a is b
    with a:
        assert obs.current() is None
        assert obs.record("z", 0.0, 1.0) is None
    assert obs.spans() == []


def test_ring_bound_evicts_and_counts_dropped(monkeypatch):
    obs.enable("ring")
    monkeypatch.setattr(obs, "_ring", collections.deque(maxlen=8))
    for i in range(12):
        with obs.span("s%d" % i):
            pass
    assert len(obs.spans()) == 8
    assert obs.dropped_total() == 4
    assert "trace_spans_dropped_total 4" in resilience.metrics_text()
    obs.clear()
    assert obs.dropped_total() == 0


def test_header_round_trip_and_malformed():
    obs.enable("hdr")
    with obs.span("root") as sp:
        h = obs.header()
        assert h == "%s:%s" % (sp.trace, sp.id)
    assert obs.parse_header(h) == (sp.trace, sp.id)
    for bad in (None, "", "nocolon", "a:b:c", 42):
        assert obs.parse_header(bad) == (None, None)
    assert obs.header() is None


def test_record_joins_the_current_trace():
    obs.enable("rec")
    with obs.span("root") as sp:
        sid = obs.record("late", obs.now() - 0.5, obs.now(), why="q")
    late = obs.spans(name="late")[0]
    assert late["id"] == sid and late["parent"] == sp.id
    assert late["trace"] == sp.trace and late["labels"] == {"why": "q"}


def test_chrome_trace_merges_like_the_jax_package():
    """A dump of each engine merged by each engine's chrome_trace: the
    same events, ids and clock-shifted timestamps."""
    dumps = []
    for eng, _ in ENGINES:
        eng.enable("merge")
        with eng.span("a", n=1):
            pass
        dumps.append(eng.dump_dict())
    other = {"format": "paddle_tpu_trace", "version": 1,
             "service": "other", "pid": 99999, "clock_offset_s": 1.5,
             "dropped": 0,
             "spans": [{"trace": "t1", "id": "s1", "parent": None,
                        "name": "remote", "t0": 10.0, "t1": 11.0,
                        "labels": {}, "tid": "main"}]}
    traces = [eng.chrome_trace(dumps + [other]) for eng, _ in ENGINES]
    assert traces[0] == traces[1]
    trace = json.loads(json.dumps(traces[1]))
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {os.getpid(), 99999}
    remote = [e for e in xs if e["name"] == "remote"][0]
    assert remote["ts"] == pytest.approx((10.0 + 1.5) * 1e6)
    assert remote["dur"] == pytest.approx(1e6)
    assert all("trace_id" in e["args"] and "span_id" in e["args"]
               for e in xs)
    assert obs.dump_dict()["format"] == "paddle_tpu_trace"


def test_clock_offset_probe_takes_the_min_rtt_sample():
    def call(cmd):
        assert cmd == "time"
        return {"wall": obs.now() + 2.0}
    off = obs.probe_clock_offset(call, samples=3)
    assert abs(off - 2.0) < 0.1
    assert obs.clock_offset() == off


# ---------------------------------------------------------------------------
# executor phases, in both packages
# ---------------------------------------------------------------------------

def _sgd_program(pkg, windowed):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        if windowed:
            x = L.data("x", [2, 4], "float32", append_batch_size=False)
            y = L.data("y", [2, 1], "float32", append_batch_size=False)
            loss = L.reduce_mean(L.square(L.fc(x, 1) - y))
        else:
            x = L.data("x", [4], dtype="float32")
            yv = L.data("y", [1], dtype="int64")
            loss = L.mean(L.softmax_with_cross_entropy(L.fc(x, 3), yv))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _phases(eng):
    steps = eng.spans(name="exec.step")
    return {
        "cache": [s["labels"]["cache"] for s in steps],
        "entry": [s["labels"]["entry"] for s in steps],
        "compile_parents": [steps.index(next(
            st for st in steps if st["id"] == c["parent"]))
            for c in eng.spans(name="exec.compile")],
        "kids": {name: sorted(steps.index(next(
            st for st in steps if st["id"] == k["parent"]))
            for k in eng.spans(name=name))
            for name in ("exec.execute", "exec.writeback")},
        "one_trace_each": all(
            {sp["name"] for sp in eng.spans(trace_id=s["trace"])} >= {
                "exec.step", "exec.execute", "exec.writeback"}
            for s in steps)}


@pytest.mark.parametrize("entry", ["run", "run_steps"])
def test_executor_phase_spans_and_histogram_match_the_jax_package(entry):
    got = []
    rng = np.random.RandomState(0)
    if entry == "run":
        feed = {"x": rng.rand(4, 4).astype(np.float32),
                "y": np.zeros((4, 1), np.int64)}
    else:
        feed = {"x": rng.rand(3, 2, 4).astype(np.float32),
                "y": np.zeros((3, 2, 1), np.float32)}
    for (eng, res), pkg in zip(ENGINES, (pt, ptt)):
        eng.enable("exec")
        main, startup, loss = _sgd_program(pkg, entry == "run_steps")
        with pkg.scope_guard(pkg.Scope()):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            for _ in range(2):
                getattr(exe, entry)(main, feed=feed, fetch_list=[loss])
        tot = res.executor_step_totals()
        got.append((_phases(eng),
                    {k: tot[k]["count"] for k in sorted(tot)}))
        text = res.metrics_text()
        assert 'executor_step_seconds_count{kind="total"} 2' in text
    assert got[1] == got[0]
    phases, counts = got[1]
    assert phases["cache"] == ["miss", "hit"]
    assert phases["entry"] == [entry, entry]
    assert phases["compile_parents"] == [0]
    assert phases["kids"] == {"exec.execute": [0, 1],
                              "exec.writeback": [0, 1]}
    assert phases["one_trace_each"]
    assert counts == {"compile": 1, "execute": 2, "total": 2,
                      "writeback": 2}


def test_use_program_cache_false_compiles_every_run():
    obs.enable("nocache")
    main, startup, loss = _sgd_program(ptt, False)
    feed = {"x": np.ones((2, 4), np.float32),
            "y": np.zeros((2, 1), np.int64)}
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_program_cache=False)
    assert [s["labels"]["cache"] for s in obs.spans(name="exec.step")] \
        == ["miss", "miss"]
    assert len(obs.spans(name="exec.compile")) == 2
    # the verifier's memo still makes the second walk a probe
    assert len(main._verify_cache) == 1
