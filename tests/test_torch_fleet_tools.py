"""The port's fleet tools beside the JAX package's, on the same inputs:
``serving_probe``'s "transport", "router" and "qos" folds with their
``--strict`` flags (``term_regression_flags``, ``qos_quota_flags``),
``coordsvc --status``, the ``servingsvc client`` loop and tenant-class
loading, ``traceview --from`` (the live ``GET /admin/trace`` pull) and
``resilience.serve_metrics``. Everything runs in this process on
127.0.0.1 with port 0; no test spawns a process, every wait is bounded
by WAIT_S."""
import contextlib
import io
import json
import os
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch import serving_fleet as tfleet
from paddle_tpu_torch.framework import obs, resilience
from paddle_tpu_torch.framework.transport import CoordServer
from paddle_tpu_torch.tools import (coordsvc, serving_probe, servingsvc,
                                    traceview)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 20.0


def _jax_tool(name):
    path = os.path.join(ROOT, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


@pytest.fixture(autouse=True)
def _clean():
    resilience.clear_events()
    resilience.clear_router()
    resilience.clear_bytes()
    yield
    resilience.clear_events()
    resilience.clear_router()
    resilience.clear_bytes()


def _wait(cond, what, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for %s" % what)


def _exposition(case):
    """A router's and two clients' series; ``stale`` adds a
    stale-primary response and a client pinned below the group term,
    ``drift`` a tenant series that no longer sums to the aggregate."""
    for tenant in ("gold", "gold", "bronze"):
        resilience.record_router_request("ok", router=2, tenant=tenant)
    resilience.record_router_request("shed", router=2, tenant="bronze")
    if case == "drift":
        resilience.record_router_request("ok", router=2)
    resilience.record_router_retry(1, router=2)
    resilience.observe_router_batch(3, router=2)
    resilience.set_router_queue_depth(2, router=2)
    resilience.set_router_inflight(0, 1, router=2)
    resilience.set_router_tenant_queue_depth("gold", 2, router=2)
    resilience.record_router_expired("queue", tenant="bronze", router=2)
    resilience.record_event("fleet_leader_term", router=2, term=1)
    resilience.record_event("transport_reconnect", attempt=1)
    resilience.record_event("transport_hb_lag", host=0, lag_s=0.01)
    resilience.record_event("transport_hb_lag", host=1, lag_s=0.02)
    resilience.record_event("transport_term", host=0, term=1)
    resilience.record_event("transport_term", host=1,
                            term=0 if case == "stale" else 1)
    if case == "stale":
        resilience.record_event("transport_stale_primary", host=1,
                                term=0, seen=1)
    return resilience.metrics_text(resilience.metrics(by_host=True))


@pytest.mark.parametrize("case", ["clean", "stale", "drift"])
def test_transport_router_and_qos_folds_match_the_jax_tool(tmp_path,
                                                           case):
    jax_sp = _jax_tool("serving_probe")
    path = str(tmp_path / "metrics.txt")
    with open(path, "w") as f:
        f.write(_exposition(case))
    url = "file://" + path
    got, want = (serving_probe.scrape_metrics(url),
                 jax_sp.scrape_metrics(url))
    for section in ("transport", "router", "qos", "events_total"):
        assert got[section] == want[section], section
    assert got["router"]["router_requests_total/ok/router2"] == \
        (4 if case == "drift" else 3)
    assert got["qos"]["router_requests_total/ok/router2/tenant:gold"] == 2
    assert "transport_heartbeat_lag/host1" in got["transport"]
    for name in ("term_regression_flags", "qos_quota_flags"):
        mine = getattr(serving_probe, name)(got)
        assert mine == getattr(jax_sp, name)(want)
        assert bool(mine) == {"term_regression_flags": case == "stale",
                              "qos_quota_flags": case == "drift"}[name]
    flagged = serving_probe.strict_flags(got)
    assert set(flagged) == {"clean": set(), "stale": {"term_regression"},
                            "drift": {"qos_drift"}}[case]


def test_serve_metrics_serves_the_live_exposition():
    resilience.record_router_request("ok", router=2, tenant="gold")
    with resilience.serve_metrics() as server:
        assert server.url == "http://127.0.0.1:%d/metrics" % server.port
        with urllib.request.urlopen(server.url, timeout=WAIT_S) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
        assert body == resilience.metrics_text(
            resilience.metrics(by_host=True))
        assert 'router_requests_total{outcome="ok",router="2",' \
            'tenant="gold"} 1' in body
        base = server.url.rsplit("/", 1)[0]
        with urllib.request.urlopen(base + "/healthz",
                                    timeout=WAIT_S) as resp:
            assert resp.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=WAIT_S)
        summary = serving_probe.scrape_metrics(server.url)
        assert "qos" in summary and not serving_probe.strict_flags(summary)
    assert resilience.events("metrics_serve")


def test_coordsvc_status_probe_matches_the_jax_tool(capsys):
    jax_cs = _jax_tool("coordsvc")
    with contextlib.ExitStack() as stack:
        srv = CoordServer(2, hb_deadline_s=5.0).start()
        stack.callback(srv.close)
        dead = "127.0.0.1:9"
        code, reports = coordsvc.probe_status([srv.address, dead])
        jcode, jreports = jax_cs.probe_status([srv.address, dead])
        assert code == jcode == 0
        assert [sorted(r) for r in reports] == \
            [sorted(r) for r in jreports]
        assert reports[0]["role"] == "primary" and reports[0]["reachable"]
        assert reports[1] == {"address": dead, "reachable": False}
        assert coordsvc.main(["--status", dead]) == 2
        assert coordsvc.main(["--status", srv.address]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert json.loads(lines[-1])["role"] == "primary"
    for bad in ([], ["--n-hosts", "many"]):
        with pytest.raises(SystemExit):
            coordsvc.main(bad)
    capsys.readouterr()


def test_tenant_classes_load_inline_and_from_a_file(tmp_path):
    jax_ss = _jax_tool("servingsvc")
    spec = {"gold": {"weight": 4, "priority": 1}}
    path = tmp_path / "classes.json"
    path.write_text(json.dumps(spec))
    for arg in (json.dumps(spec), "@" + str(path)):
        assert servingsvc._load_tenant_classes(arg) == \
            jax_ss._load_tenant_classes(arg) == spec
    assert servingsvc._load_tenant_classes(None) is None


@pytest.fixture(scope="module")
def fc_artifact(tmp_path_factory):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [6], dtype="float32")
        y = ptt.layers.softmax(ptt.layers.fc(x, 3))
    d = str(tmp_path_factory.mktemp("tools_fc"))
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        ptt.save_inference_model(d, ["x"], [y], exe, main_program=main,
                                 format="stablehlo", batch_sizes=(1, 8))
    return d


def test_client_loop_and_live_trace_pull(fc_artifact, monkeypatch, capsys):
    """``servingsvc client`` reads requests from stdin and writes one
    result a line through a router; with tracing on, ``traceview
    --from`` pulls the router's and the replica's spans live and merges
    one request's tree across both."""
    obs.enable()
    obs.clear()
    try:
        with contextlib.ExitStack() as stack:
            srv = CoordServer(None, hb_deadline_s=2.0).start()
            stack.callback(srv.close)
            rep = tfleet.ReplicaMember(
                fc_artifact, srv.address, 1, 0, ctl_interval_s=0.05,
                hb_interval_s=0.1, join_timeout_s=WAIT_S,
                place=ptt.CPUPlace()).start()
            stack.callback(rep.close)
            router = tfleet.FleetRouter(
                srv.address, 1, batch_deadline_s=0.005,
                ctl_interval_s=0.05, hb_interval_s=0.1,
                poll_interval_s=0.03, join_timeout_s=WAIT_S).start()
            stack.callback(router.close)
            _wait(lambda: len(router.routable()) == 1, "replica routable")
            xv = np.ones((2, 6), np.float32).tolist()
            lines = [json.dumps({"feeds": {"x": xv}}), "",
                     json.dumps({"feeds": {"nope": xv}})]
            monkeypatch.setattr(sys, "stdin",
                                io.StringIO("\n".join(lines) + "\n"))
            args = types.SimpleNamespace(routers=router.url,
                                         deadline_s=WAIT_S, tenant="gold",
                                         retry_budget=None)
            assert servingsvc._client_main(args) == 0
            out = [json.loads(ln) for ln in
                   capsys.readouterr().out.splitlines()]
            assert [o["ok"] for o in out] == [True, False]
            assert np.asarray(out[0]["outputs"][0]).shape == (2, 3)
            assert out[1]["kind"] == "ValueError"
            dumps = [traceview.pull_live(router.url),
                     traceview.pull_live(rep.address)]
            assert all(d["spans"] for d in dumps)
            merged = traceview.merge(dumps)
            names = {e["name"] for e in merged["traceEvents"]
                     if e["ph"] == "X"}
            assert {"router.serve", "replica.serve"} <= names
            assert traceview.main(["--stdout", "--from", ",".join(
                [router.url, rep.address, "127.0.0.1:9"])]) == 1
            assert json.loads(capsys.readouterr().out)["traceEvents"]
    finally:
        obs.disable()
        obs.clear()
