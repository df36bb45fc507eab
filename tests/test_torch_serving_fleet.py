"""The port's serving fleet (paddle_tpu_torch/serving_fleet.py) against
the JAX package's (paddle_tpu/serving_fleet.py).

* The router's pure parts: the same pending queue and clock through both
  packages' ``_request_rows``, ``_merge``, ``_split`` and the weighted
  fair cut ``_cut_batch_wfq`` give equal outputs; ``parse_tenant_classes``
  gives equal classes; the same router, tenant and transport events
  render byte-equal ``metrics_text``.
* A fleet on the CPU in one process: a CoordServer, two ReplicaMembers
  (``place=CPUPlace()``) and a FleetRouter over a narrow BERT encoder (2
  layers, hidden 128, T = 16) that the port exported from weights copied
  out of the JAX package. Answers through the router are bit-equal to
  the port's direct ServingPredictor at the same bucket (every request
  has 2 or 3 rows, so every batch runs bucket 8) and within rtol/atol
  1e-5 of the JAX package's predictor on the same weights (the serving
  artifact parity test's tolerance). A replica whose endpoint dies costs
  no request; a rolling deploy to a second weights file (the same
  exported programs, another ``weights.npz``) drops none and moves every
  answer to the new weights.
* The Autoscaler with in-process spawner and stopper grows the group on
  a shed surge and shrinks it when idle.

Which replica a request lands on is a race: the tests compare outcomes,
answers and event multisets, never orderings. No process is spawned;
every wait is bounded by WAIT_S.
"""
import contextlib
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu import serving_fleet as jfleet
from paddle_tpu.framework import resilience as jres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import serving_fleet as tfleet
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.framework.transport import CoordServer

WAIT_S = 20.0
TOL = dict(rtol=1e-5, atol=1e-5)
T = 16
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]


@pytest.fixture(autouse=True)
def _clean():
    for res in (jres, tres):
        res.install(None)
        res.clear_events()
        res.clear_router()
        res.clear_bytes()
    yield
    for res in (jres, tres):
        res.install(None)
        res.clear_events()
        res.clear_router()
        res.clear_bytes()


def _wait(cond, what, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError("timed out waiting for %s" % what)


# ---------------------------------------------------------------------------
# the router's pure parts
# ---------------------------------------------------------------------------

META = {"feed_names": ["x", "table"], "fetch_names": ["y", "s"],
        "feed_batch_factors": {"x": 2, "table": 0},
        "fetch_batch_factors": {"y": 1, "s": 0},
        "feed_dtypes": {"x": "float32", "table": "float32"},
        "feed_inner_shapes": {"x": [3], "table": [2]},
        "dynamic_batch": True, "max_bucket": 8}
CLASSES = {"gold": {"weight": 4, "priority": 2},
           "silver": {"weight": 2, "priority": 1,
                      "tenants": ["crawler"]},
           "default": {"weight": 1, "priority": 0, "rate": 50,
                       "burst": 5, "max_inflight": 8}}


def _router(fleet, **kw):
    """An unstarted router (no socket, no coordinator) with META cached."""
    r = fleet.FleetRouter("127.0.0.1:1", 2, batch_deadline_s=0.0, **kw)
    r._meta = dict(META)
    return r


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(2 * n, 3).round(3).tolist(),
            "table": [1.0, 2.0]}


def test_request_rows_merge_and_split_match():
    out = {}
    for name, fleet in (("jax", jfleet), ("torch", tfleet)):
        r = _router(fleet)
        rows = [r._request_rows(_rows(n, n), META) for n in (1, 2, 3)]
        errors = []
        for bad in ({"x": [[1.0, 2.0, 3.0]], "table": [1.0, 2.0]},
                    {"x": [[1.0, 2.0]] * 2, "table": [1.0, 2.0]},
                    {"table": [1.0, 2.0]},
                    {"x": [[1.0, 2.0, 3.0], [1.0]], "table": [0, 0]},
                    {"x": [[1.0, 2.0, 3.0]] * 2, "table": [[0, 0]]}):
            with pytest.raises(ValueError) as e:
                r._request_rows(bad, META)
            errors.append(str(e.value))
        batch = [fleet._Pending(_rows(n, n), n, time.monotonic() + 9)
                 for n in (1, 2, 3)]
        merged = fleet.FleetRouter._merge(batch, META)
        resp = {"outputs": [[[float(i)] for i in range(6)], [7.0]],
                "dtypes": ["float32", "float32"], "replica": 1,
                "generation": 3}
        r._split(batch, resp, META)
        out[name] = (rows, errors, merged, [p.result for p in batch])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [1, 2, 3]
    assert [len(p["outputs"][0]) for p in out["torch"][3]] == [1, 2, 3]


def test_weighted_fair_cut_matches():
    """Three tenants queue rows; both packages cut the same batches in
    the same order with the same virtual tags, and shed the same
    requests (the rate and in-flight quotas, the queue cap)."""
    out = {}
    for name, fleet in (("jax", jfleet), ("torch", tfleet)):
        r = _router(fleet, max_batch=8, max_queue=12,
                    tenant_classes=CLASSES)
        now = time.monotonic()
        admitted, shed = [], []
        order = ["gold", "crawler", "default", "gold", "gold", "crawler",
                 "default", "default", "default", "default", "default",
                 "default", "gold", "crawler", "gold"]
        with r._qcond:
            for tenant in set(order):     # token buckets on one clock
                r._tstate_for(tenant)["t_tok"] = now
            for i, tenant in enumerate(order):
                p = fleet._Pending(_rows(1 + i % 3, i), 1 + i % 3,
                                   now + 60.0, tenant=tenant)
                why = r._qos_admit_locked(p, now)
                (shed if why else admitted).append(
                    (i, tenant, why and why.split(" ")[0]))
        batches = []
        while any(r._tqueues.values()):
            batch = r._cut_batch_wfq()
            batches.append([(p.tenant, p.n, p.vstart, p.vfinish)
                            for p in batch])
        out[name] = (admitted, shed, batches, r._vclock,
                     {t: dict(st, t_tok=None)
                      for t, st in sorted(r._tstate.items())})
    assert out["torch"] == out["jax"]
    assert out["torch"][1], "no request hit a quota"
    assert len(out["torch"][2]) > 2


def test_parse_tenant_classes_match():
    for spec in (CLASSES, None, {}, [{"name": "a", "weight": 3}]):
        got = {k: {s: getattr(c, s) for s in c.__slots__}
               for k, c in tfleet.parse_tenant_classes(spec).items()}
        want = {k: {s: getattr(c, s) for s in c.__slots__}
                for k, c in jfleet.parse_tenant_classes(spec).items()}
        assert got == want
    for bad in ({"a": {"weight": 0}}, {"a": {"rate": -1}},
                {"a": {"max_inflight": 0}}):
        for fleet in (jfleet, tfleet):
            with pytest.raises(ValueError):
                fleet.parse_tenant_classes(bad)


def _record_traffic(res):
    res.record_router_request("ok", router=2, tenant="gold")
    res.record_router_request("ok", router=2, tenant="default")
    res.record_router_request("shed", router=2, tenant="gold")
    res.record_router_request("ok")
    res.record_router_retry(1, router=2)
    res.observe_router_batch(3, router=2)
    res.observe_router_batch(8, router=2)
    res.observe_router_batch(200)
    res.record_router_slow(0.25, trace="abc", router=2, tenant="gold")
    res.record_router_expired("queue", tenant="gold", router=2)
    res.record_router_expired("replica")
    res.set_router_queue_depth(4, router=2)
    res.set_router_inflight(0, 2, router=2)
    res.set_router_inflight(1, 1, router=2)
    res.set_router_tenant_queue_depth("gold", 3, router=2)
    for kind, fields in (
            ("transport_reconnect", {"attempt": 1}),
            ("transport_failover", {"to": "h:2"}),
            ("transport_hb_lag", {"host": 0, "lag_s": 0.125}),
            ("transport_hb_lag", {"host": 1, "lag_s": 0.5}),
            ("transport_term", {"host": 0, "term": 1}),
            ("transport_promote", {"index": 1, "term": 1}),
            ("transport_repl_lag", {"lag": 3}),
            ("fleet_leader_term", {"router": 2, "term": 1}),
            ("fleet_autoscale", {"action": "grow", "target": 3})):
        res.record_event(kind, **fields)
    res.record_bytes("stateship", 1000, 400)


def _clear_series(res, fi, obs):
    """Every process-global series a package's exposition renders: a
    byte-equal rendering needs both packages to start from nothing,
    whatever tests ran before in this process."""
    for clear in ("clear_events", "clear_router", "clear_bytes",
                  "clear_exec", "clear_analysis", "clear_buddy_gens",
                  "clear_kernel_choice"):
        getattr(res, clear, lambda: None)()
    fi.disarm()
    fi.reset_counters()
    obs.disable()
    obs.clear()


def test_router_tenant_and_transport_series_render_byte_equal():
    from paddle_tpu.framework import faultinject as jfi
    from paddle_tpu.framework import obs as jobs
    from paddle_tpu_torch.framework import faultinject as tfi
    from paddle_tpu_torch.framework import obs as tobs
    texts = {}
    for name, res, fi, obs in (("jax", jres, jfi, jobs),
                               ("torch", tres, tfi, tobs)):
        _clear_series(res, fi, obs)
        _record_traffic(res)
        texts[name] = (res.metrics_text(),
                       res.metrics_text(res.metrics(by_host=True)),
                       res.router_totals(), res.router_totals(True))
    assert texts["torch"] == texts["jax"]
    text = texts["torch"][0]
    for series in ("router_requests_total", "router_retries_total",
                   "router_batch_size_bucket", "router_queue_depth",
                   "router_replica_inflight",
                   "router_tenant_queue_depth",
                   "router_deadline_expired_total",
                   "transport_reconnects_total",
                   "transport_failovers_total",
                   "transport_heartbeat_lag", "transport_term",
                   "transport_replication_lag", "fleet_leader_term",
                   "fleet_target_replicas", "stateship_bytes_total"):
        assert "paddle_tpu_resilience_" + series in text, series


# ---------------------------------------------------------------------------
# a fleet on the CPU, in one process
# ---------------------------------------------------------------------------

def _encoder(pkg):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    bert = jbert if pkg is pt else tbert
    cfg = bert.BertConfig(vocab_size=100, hidden_size=128, num_layers=2,
                          num_heads=4, ff_size=256, max_position=64)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feeds = [pkg.layers.data(n, [T, 1], dtype=dt) for n, dt in zip(
            FEEDS, ["int64", "int64", "int64", "float32"])]
        _, pooled = bert.bert_encoder(*feeds, cfg, is_test=True)
    return main, startup, pooled


def _jax_weights(seed):
    main, startup, _ = _encoder(pt)
    startup.random_seed = seed
    sc = pt.Scope()
    with pt.scope_guard(sc):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {v.name: np.asarray(sc.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _reweighted(src, dst, weights):
    """``src``'s exported programs beside another weights file."""
    shutil.copytree(src, dst)
    sdir = os.path.join(dst, "serving")
    with open(os.path.join(sdir, "meta.json")) as f:
        names = json.load(f)["weight_names"]
    np.savez(os.path.join(sdir, "weights.npz"),
             **{n: weights[n] for n in names})
    return dst


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port dir A, port dir B, JAX dir A): A from the JAX startup's
    weights at seed 3, B the same programs with seed 4's weights."""
    root = tmp_path_factory.mktemp("fleet_bert")
    wa = _jax_weights(3)
    jmain, jstart, jpooled = _encoder(pt)
    jstart.random_seed = 3
    jdir = str(root / "jax")
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        pt.save_inference_model(jdir, FEEDS, [jpooled], exe,
                                main_program=jmain, format="stablehlo",
                                batch_sizes=(1, 8))
    tmain, _, tpooled = _encoder(ptt)
    sc = ptt.Scope()
    ptt.set_params_from_numpy(wa, tmain, sc, ptt.CPUPlace())
    adir = str(root / "a")
    with ptt.scope_guard(sc):
        ptt.save_inference_model(adir, FEEDS, [tpooled],
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=tmain, format="stablehlo",
                                 batch_sizes=(1, 8))
    bdir = _reweighted(adir, str(root / "b"), _jax_weights(4))
    return adir, bdir, jdir


def _request(n, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, T, 1), np.float32)
    for row in range(1, n):
        mask[row, rng.randint(2, T):] = 0.0
    return {"src_ids": rng.randint(0, 100, (n, T, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (n, 1, 1)).astype(np.int64),
            "sent_ids": np.zeros((n, T, 1), np.int64),
            "input_mask": mask}


def _wire(feed):
    return {k: v.tolist() for k, v in feed.items()}


def _fleet(stack, artifact, n_replicas=2, hb_deadline_s=2.0):
    srv = CoordServer(None, hb_deadline_s=hb_deadline_s).start()
    stack.callback(srv.close)
    reps = []
    for i in range(n_replicas):
        rep = tfleet.ReplicaMember(
            artifact, srv.address, n_replicas, i, ctl_interval_s=0.05,
            hb_interval_s=0.1, join_timeout_s=WAIT_S,
            place=ptt.CPUPlace()).start()
        stack.callback(rep.close)
        reps.append(rep)
    router = tfleet.FleetRouter(
        srv.address, n_replicas, max_batch=8, batch_deadline_s=0.01,
        ctl_interval_s=0.05, hb_interval_s=0.1, poll_interval_s=0.03,
        join_timeout_s=WAIT_S).start()
    stack.callback(router.close)
    _wait(lambda: len(router.routable()) == n_replicas,
          "all replicas routable")
    return srv, reps, router


def _post(router, feed):
    return tfleet.http_json("POST", router.url + "/infer",
                            {"feeds": _wire(feed)}, timeout_s=WAIT_S)


def _in_parallel(fn, n):
    out = [None] * n
    ts = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(i)))
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ts)
    return out


def _direct(pred, feed):
    """The direct predictor's answer at bucket 8 (the fleet's bucket for
    every batch of these tests)."""
    return pred._run_impl(feed, force_bucket=8)[0]


def test_fleet_answers_equal_the_direct_predictor_and_the_jax_one(
        artifacts):
    adir, _, jdir = artifacts
    direct = tserving.load_serving_artifact(adir, place=ptt.CPUPlace())
    jpred = jserving.load_serving_artifact(jdir)
    feeds = [_request(2 + i % 2, i) for i in range(10)]
    with contextlib.ExitStack() as stack:
        _, reps, router = _fleet(stack, adir)
        got = _in_parallel(lambda i: _post(router, feeds[i]), len(feeds))
        health = [r.health() for r in reps]
    for feed, (status, resp) in zip(feeds, got):
        assert status == 200, resp
        out = np.asarray(resp["outputs"][0], dtype=resp["dtypes"][0])
        assert out.shape == (len(feed["src_ids"]), 128)
        np.testing.assert_array_equal(out, _direct(direct, feed))
        want, = jpred.run({k: v.astype(np.int32) if v.dtype == np.int64
                           else v for k, v in feed.items()})
        np.testing.assert_allclose(out, want, **TOL)
    tot = tres.router_totals()
    assert tot["requests"] == {"ok": len(feeds)}
    assert 0 < tot["batch_count"] <= len(feeds)
    assert sum(h["requests"] for h in health) == tot["batch_count"]
    assert {h["status"] for h in health} == {"ok"}


def test_replica_endpoint_death_fails_no_request(artifacts):
    adir, _, _ = artifacts
    direct = tserving.load_serving_artifact(adir, place=ptt.CPUPlace())
    with contextlib.ExitStack() as stack:
        _, reps, router = _fleet(stack, adir, hb_deadline_s=1.0)
        # replica 0's listener dies while its lease keeps beating: the
        # router still picks it and must fail over per dispatch
        reps[0]._server.shutdown()
        reps[0]._server.server_close()
        feeds = [_request(2, 100 + i) for i in range(12)]
        got = _in_parallel(lambda i: _post(router, feeds[i]), len(feeds))
        assert [s for s, _ in got] == [200] * len(feeds)
        assert {r["replica"] for _, r in got} == {1}
        assert tres.events("router_retry")
        for feed, (_, resp) in zip(feeds, got):
            np.testing.assert_array_equal(
                np.asarray(resp["outputs"][0], np.float32),
                _direct(direct, feed))
        # its control plane stops too: the lease lapses, the fleet
        # fences it and routes around it without a retry
        reps[0]._co.close()
        _wait(lambda: sorted(router.routable()) == [1],
              "replica 0 fenced out of rotation")
        status, resp = _post(router, feeds[0])
        assert status == 200 and resp["replica"] == 1


def test_rolling_deploy_to_a_second_weights_file_drops_nothing(artifacts):
    adir, bdir, _ = artifacts
    old = tserving.load_serving_artifact(adir, place=ptt.CPUPlace())
    new = tserving.load_serving_artifact(bdir, place=ptt.CPUPlace())
    feed = _request(2, 7)
    want_old, want_new = _direct(old, feed), _direct(new, feed)
    assert not np.array_equal(want_old, want_new)
    with contextlib.ExitStack() as stack:
        _, reps, router = _fleet(stack, adir)
        stop, failures, served = threading.Event(), [], []
        lock = threading.Lock()

        def load():
            while not stop.is_set():
                try:
                    status, resp = _post(router, feed)
                except Exception as e:   # noqa: BLE001 - recorded
                    status, resp = -1, repr(e)
                with lock:
                    (served if status == 200 else failures).append(resp)
                time.sleep(0.01)

        loaders = [threading.Thread(target=load) for _ in range(2)]
        for t in loaders:
            t.start()
        try:
            _wait(lambda: len(served) >= 6, "traffic before the deploy")
            summary = router.rolling_deploy(bdir,
                                            per_replica_timeout_s=WAIT_S)
            n_at_deploy = len(served)
            _wait(lambda: len(served) >= n_at_deploy + 6,
                  "traffic after the deploy")
        finally:
            stop.set()
            for t in loaders:
                t.join(WAIT_S)
        assert not failures, failures[:3]
        assert summary["refreshed"] == [0, 1]
        assert [r.generation for r in reps] == [2, 2]
        # every answer is one generation's, bit for bit; the last ones
        # are all the new weights'
        for resp in served:
            out = np.asarray(resp["outputs"][0], np.float32)
            want = want_new if resp["generation"] == 2 else want_old
            np.testing.assert_array_equal(out, want)
        assert all(r["generation"] == 2 for r in served[n_at_deploy:])
        status, resp = _post(router, feed)
        assert status == 200
        np.testing.assert_array_equal(
            np.asarray(resp["outputs"][0], np.float32), want_new)
    ship = tres.bytes_totals().get("stateship")
    assert ship and 0 < ship["wire"] < ship["raw"]
    kinds = {e["kind"] for e in tres.events()}
    assert {"fleet_deploy_begin", "fleet_deploy_done", "fleet_rejoin",
            "fleet_admit", "fleet_deploy_complete"} <= kinds


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fc_artifact(tmp_path_factory):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [6], dtype="float32")
        y = ptt.layers.softmax(ptt.layers.fc(x, 3))
    d = str(tmp_path_factory.mktemp("fleet_fc"))
    sc = ptt.Scope()
    with ptt.scope_guard(sc):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        ptt.save_inference_model(d, ["x"], [y], exe, main_program=main,
                                 format="stablehlo", batch_sizes=(1, 8))
    return d


# the autoscaler's members tick their control rounds at this interval: a
# resize is refused while a round is open, so rounds far apart leave it
# room even on a loaded host
CTL_S = 0.2


def test_autoscaler_grows_on_a_surge_and_shrinks_when_idle(fc_artifact):
    with contextlib.ExitStack() as stack:
        srv = CoordServer(2, hb_deadline_s=1.0).start()
        stack.callback(srv.close)
        rep = tfleet.ReplicaMember(
            fc_artifact, srv.address, 1, 0, ctl_interval_s=CTL_S,
            hb_interval_s=0.1, join_timeout_s=WAIT_S,
            place=ptt.CPUPlace()).start()
        stack.callback(rep.close)
        # a half-second batch window keeps every surge request queued
        # (the 4-deep queue full, the rest shed) however fast the
        # replica and however loaded the host: the autoscaler's signals
        # do not hang on a race between the senders and the batcher
        router = tfleet.FleetRouter(
            srv.address, 1, max_queue=4, max_batch=8,
            batch_deadline_s=0.5, ctl_interval_s=CTL_S,
            hb_interval_s=0.1, poll_interval_s=0.03,
            join_timeout_s=WAIT_S).start()
        stack.callback(router.close)
        _wait(lambda: len(router.routable()) == 1 and router.is_leader(),
              "the replica routable and the router leading")
        grown, stopped = [], []

        def spawner(new_id, new_group):
            r = tfleet.ReplicaMember(
                fc_artifact, srv.address, 1, new_id, n_routers=1,
                group_size=new_group, ctl_interval_s=CTL_S,
                hb_interval_s=0.1, join_timeout_s=WAIT_S,
                place=ptt.CPUPlace()).start()
            stack.callback(r.close)
            grown.append(r)

        auto = tfleet.Autoscaler(
            router, spawner=spawner, stopper=stopped.append,
            min_replicas=1, max_replicas=2, interval_s=0.03, window=8,
            grow_queue_depth=3.0, grow_shed_rate=0.05, hysteresis=2,
            cooldown_s=0.5, drain_timeout_s=WAIT_S).start()
        stack.callback(auto.close)
        xv = np.ones((1, 6), np.float32).tolist()
        surge = threading.Event()

        def pound():
            while not surge.is_set():
                try:
                    tfleet.http_json("POST", router.url + "/infer",
                                     {"feeds": {"x": xv}},
                                     timeout_s=WAIT_S)
                except (OSError, ValueError):
                    pass

        ts = [threading.Thread(target=pound) for _ in range(6)]
        for t in ts:
            t.start()
        try:
            _wait(lambda: any(e.get("action") == "grow" for e in
                              tres.events("fleet_autoscale")),
                  "autoscale grow")
        finally:
            surge.set()
            for t in ts:
                t.join(WAIT_S)
        grow, = [e for e in tres.events("fleet_autoscale")
                 if e.get("action") == "grow"]
        assert (grow["member"], grow["group"]) == (2, 3)
        _wait(lambda: grown, "spawner invoked")
        _wait(lambda: any(e.get("action") == "shrink" for e in
                          tres.events("fleet_autoscale")),
              "autoscale shrink")
        _wait(lambda: srv.state.n_hosts == 2, "group resized back to 2")
        _wait(lambda: len(router.routable()) == 1,
              "drained replica out of rotation")
        assert stopped == [2]
        assert any(e.get("joined") == 2
                   for e in tres.events("fleet_admit"))
        status, _ = tfleet.http_json("POST", router.url + "/infer",
                                     {"feeds": {"x": xv}},
                                     timeout_s=WAIT_S)
        assert status == 200
