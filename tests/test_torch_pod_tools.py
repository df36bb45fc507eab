"""The port's small tools and the serving probe's buddy fold, run beside
the JAX package's tools on the same inputs: ``paddle_tpu_torch.tools.
traceview`` (merged span dumps: the same Chrome trace, byte for byte),
``tools.op_coverage`` (the same report over the port's registry, which
lacks only the deferred op types) and ``serving_probe``'s "buddy" fold
with its two ``--strict`` flags (the same summary and verdicts)."""
import json
import os
import sys

import pytest

from paddle_tpu_torch.framework import obs, resilience
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.tools import op_coverage, serving_probe, traceview

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    path = os.path.join(ROOT, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


@pytest.fixture
def dumps(tmp_path):
    """Two span dumps: this process's and a second process's."""
    obs.enable()
    obs.clear()
    try:
        with obs.span("exec.step", entry="run"):
            with obs.span("exec.execute"):
                pass
        mine = obs.dump(str(tmp_path / "a.json"))
    finally:
        obs.disable()
        obs.clear()
    with open(mine) as f:
        d = json.load(f)
    other = dict(d, pid=d["pid"] + 1, service="replica-1",
                 clock_offset_s=0.25)
    path = str(tmp_path / "b.json")
    with open(path, "w") as f:
        json.dump(other, f)
    return [mine, path]


def test_traceview_merges_like_the_jax_tool(dumps, tmp_path, capsys):
    jax_tv = _jax_tool("traceview")
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jax_tv.main(["-o", out_j] + dumps) == 0
    assert traceview.main(["-o", out_t] + dumps) == 0
    with open(out_j) as f, open(out_t) as g:
        merged = json.load(g)
        assert merged == json.load(f)
    names = {e["name"] for e in merged["traceEvents"] if e["ph"] == "X"}
    assert {"exec.step", "exec.execute"} <= names
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("[]")
    assert jax_tv.main(["-o", out_j, bad] + dumps) == \
        traceview.main(["-o", out_t, bad] + dumps) == 1
    assert jax_tv.main(["--stdout", bad]) == \
        traceview.main(["--stdout", bad]) == 2
    capsys.readouterr()


def test_op_coverage_reports_like_the_jax_tool(tmp_path, capsys):
    jax_oc = _jax_tool("op_coverage")
    from test_torch_op_coverage import DEFERRED
    deferred = {op for ops in DEFERRED.values() for op in ops}
    path = str(tmp_path / "opcov.txt")
    with open(path, "w") as f:
        f.write("mul\nsoftmax\nadam\n")

    def report(main):
        rc = main(path)
        lines = capsys.readouterr().out.splitlines()
        return rc, lines[0], {ln.strip() for ln in lines[1:]}
    rc_j, head_j, unc_j = report(jax_oc.main)
    rc_t, head_t, unc_t = report(op_coverage.main)
    assert rc_j == rc_t == 1
    assert unc_t == unc_j - deferred
    assert head_t == "registered: %d  exercised: 3  uncovered: %d" % (
        len(registry.registered_ops()), len(unc_t))
    assert jax_oc.main(str(tmp_path / "missing")) == \
        op_coverage.main(str(tmp_path / "missing")) == 2
    capsys.readouterr()


def test_op_coverage_recording(tmp_path, monkeypatch):
    path = str(tmp_path / "seen.txt")
    monkeypatch.setattr(registry, "_COVERAGE_PATH", path)
    monkeypatch.setattr(registry, "_COVERAGE_SEEN", set())
    for op in ("mul", "mul", "relu"):
        registry._track(op)
    with open(path) as f:
        assert f.read().split() == ["mul", "relu"]


@pytest.mark.parametrize("case", ["healthy", "lagging", "coord_payload"])
def test_serving_probe_buddy_fold_matches_the_jax_tool(tmp_path, case):
    jax_sp = _jax_tool("serving_probe")
    resilience.clear_events()
    try:
        gens = {"healthy": (4, 4, 3), "lagging": (4, 1, 4),
                "coord_payload": (2, 2, 2)}[case]
        for h, g in enumerate(gens):
            resilience.record_buddy_gen(h, g)
            resilience.record_buddy_resident(h, 1000 + h)
        resilience.record_buddy_resident(
            "coord", 1 << 20 if case == "coord_payload" else 512)
        resilience.record_buddy_delta_ratio(0.25)
        resilience.record_buddy_fetch_ms(1.5)
        resilience.record_bytes("buddy_snapshot", 4000, 1000)
        resilience.record_event("buddy_restore", outcome="ok", step=4)
        path = str(tmp_path / "metrics.txt")
        with open(path, "w") as f:
            f.write(resilience.metrics_text())
    finally:
        resilience.clear_events()
    url = "file://" + path
    got, want = (serving_probe.scrape_metrics(url),
                 jax_sp.scrape_metrics(url))
    assert got["buddy"] == want["buddy"]
    assert got["events_total"] == want["events_total"]
    assert got["buddy"]["buddy_generation/host1"] == gens[1]
    for name in ("buddy_generation_flags", "buddy_resident_flags"):
        mine = getattr(serving_probe, name)(got)
        assert mine == getattr(jax_sp, name)(want)
        assert bool(mine) == {
            "buddy_generation_flags": case == "lagging",
            "buddy_resident_flags": case == "coord_payload"}[name]
