"""The port's socket plane (paddle_tpu_torch/framework/transport.py and
coordination.SocketCoordinator) against the JAX package's.

* The op table without sockets: one scripted sequence (hellos, a gather
  round with an imposter, a stale heartbeat, a tombstone, announce /
  unfence, a resize, the member registry, the buddy tables, a snapshot
  and its reload) goes through both packages' ``_PodState`` and
  ``_dispatch`` on a fake clock; every response and every state
  snapshot must be equal.
* The wire both ways: a port SocketCoordinator pair finishes a gather
  round and a fencing against a JAX CoordServer, and a JAX pair does the
  same against a port CoordServer (127.0.0.1, port 0, in-process).
* Failover: a port ``replicated_group`` loses its primary mid-run; the
  clients fail over and nobody is fenced; a stale ex-primary is refused
  by term.
* Pods over sockets: an elastic pod (die, shrink, rejoin) over one
  shared SocketCoordinator equals the LocalCoordinator run bit for bit
  and gives the JAX package's events; a host_id-mode pod with the buddy
  tier restores from the peers' MailboxServer endpoints over TCP; a
  host whose heartbeats lag is drained on the lag its client measured,
  as in the JAX package.

No test spawns a process; every wait is bounded by WAIT_S.
"""
import contextlib
import importlib
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import coordination as jcoord
from paddle_tpu.framework import resilience as jres
from paddle_tpu.framework import transport as jtr
from paddle_tpu_torch.framework import buddy as tbuddy
from paddle_tpu_torch.framework import coordination as tcoord
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.framework import transport as ttr

WAIT_S = 20.0
PKGS = {"jax": (jtr, jcoord, jres), "torch": (ttr, tcoord, tres)}


@pytest.fixture(autouse=True)
def _clean():
    for res in (jres, tres):
        res.install(None)
        res.clear_events()
    yield
    for res in (jres, tres):
        res.install(None)
        res.clear_events()


def _run_hosts(fn, n):
    out, errs = {}, {}

    def worker(h):
        try:
            out[h] = fn(h)
        except Exception as e:   # noqa: BLE001 - returned to the test
            errs[h] = e

    ts = [threading.Thread(target=worker, args=(h,)) for h in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ts), "a host thread hung"
    return out, errs


# ---------------------------------------------------------------------------
# the op table, without sockets
# ---------------------------------------------------------------------------

SCRIPT = [
    # (cmd, host, request fields, fake clock)
    ("hello", 0, {"n_hosts": 3, "lease": True}, 0.0),
    ("hello", 1, {"n_hosts": 3, "lease": True}, 0.1),
    ("hello", 2, {"n_hosts": 3, "lease": True}, 0.2),
    ("hello", 1, {"n_hosts": 4}, 0.2),                 # size mismatch
    ("put", 0, {"name": "g1", "value": [0, "a"], "token": "t0"}, 0.3),
    ("poll", 0, {"name": "g1"}, 0.3),                   # waiting on 1, 2
    ("put", 1, {"name": "g1", "value": {"k": 1}, "token": "t1"}, 0.3),
    ("put", 1, {"name": "g1", "value": 9, "token": "imposter"}, 0.3),
    ("put", 1, {"name": "g1", "value": {"k": 1}, "token": "t1"}, 0.3),
    ("put", 2, {"name": "g1", "value": None, "token": "t2"}, 0.4),
    ("poll", 1, {"name": "g1"}, 0.4),
    ("ack", 0, {"name": "g1"}, 0.4),
    ("ack", 1, {"name": "g1"}, 0.4),
    ("ack", 2, {"name": "g1"}, 0.4),
    ("hb", 0, {}, 0.9),
    ("hb", 1, {}, 0.9),
    ("put", 1, {"name": "g2", "value": 2, "token": "u1"}, 0.9),
    ("SCAN", None, {}, 1.5),                            # host 2 is stale
    ("lost", None, {}, 1.5),
    ("put", 2, {"name": "g2", "value": 3, "token": "u2"}, 1.5),
    ("put", 0, {"name": "g2", "value": 1, "token": "u0"}, 1.5),
    ("poll", 0, {"name": "g2"}, 1.5),                   # frozen without 2
    ("announce_join", 0, {"nonce": 5}, 1.6),            # not fenced
    ("announce_join", 2, {"nonce": 7}, 1.6),
    ("pending_joins", None, {}, 1.6),
    ("unfence", 2, {}, 1.7),
    ("put_info", 0, {"info": {"kind": "replica", "addr": "h:1"}}, 1.7),
    ("put_info", 1, {"info": {"kind": "router", "lterm": 2}}, 1.7),
    ("members", None, {}, 1.8),
    ("resize", None, {"n_hosts": 5}, 1.8),              # grown, fenced
    ("members", None, {}, 1.8),
    ("resize", None, {"n_hosts": 3}, 1.9),
    ("mailbox_hello", 0, {"addr": "127.0.0.1:9"}, 1.9),
    ("put_buddy_meta", 0, {"gen": 1, "buddy": 1, "digest": "d0",
                           "nbytes": 10}, 1.9),
    ("put_buddy_meta", 0, {"gen": 0, "buddy": 1, "digest": "x",
                           "nbytes": 1}, 1.9),          # gen rewind
    ("buddy_meta", None, {"owner": 0}, 1.9),
    ("buddy_meta", None, {}, 1.9),
    ("put_blob", 1, {"gen": 1, "buddy": 0, "blob": {"npz": "YWJj"}}, 2.0),
    ("get_blob", None, {"owner": 1}, 2.0),
    ("get_blob", None, {"owner": 1, "meta_only": True}, 2.0),
    ("mark_lost", 1, {"reason": "declared by a test"}, 2.1),
    ("mark_lost", 0, {"reason": "both gone"}, 2.1),     # blobs evicted
    ("get_blob", None, {"owner": 1}, 2.1),
    ("put", 1, {"name": "g3", "value": 0, "token": "w1"}, 2.2),
]


def _plain(obj):
    """JSON round trip: what the wire would carry (int keys as str)."""
    return json.loads(json.dumps(obj, sort_keys=True))


def _drive(tr):
    state = tr._PodState(3, hb_deadline_s=1.0)
    trail = []
    for cmd, hid, req, now in SCRIPT:
        with state.lock:
            if cmd == "SCAN":
                resp = {"newly": state._scan_heartbeats(now)}
            else:
                resp = tr._dispatch(state, cmd, hid, dict(req), now)
            trail.append((cmd, _plain(resp), _plain(state.to_snapshot())))
    fresh = tr._PodState(None, hb_deadline_s=1.0)
    with state.lock, fresh.lock:
        fresh.load_snapshot(state.to_snapshot(), 10.0)
        reloaded = _plain(fresh.to_snapshot())
        later = _plain(tr._dispatch(fresh, "members", None, {}, 10.5))
    return trail, reloaded, later


def test_pod_state_and_dispatch_script_equal_in_both_packages():
    jtrail, jsnap, jlater = _drive(jtr)
    ttrail, tsnap, tlater = _drive(ttr)
    assert len(ttrail) == len(SCRIPT)
    for (cmd, jr, js), (_, tr_, ts) in zip(jtrail, ttrail):
        assert tr_ == jr, cmd
        assert ts == js, cmd
    assert tsnap == jsnap and tlater == jlater
    # the script reaches what it names: an imposter refused, the stale
    # host tombstoned by the scan, grown slots born fenced, blobs evicted
    by_cmd = [(c, r) for c, r, _ in ttrail]
    assert "error" in by_cmd[7][1]
    assert by_cmd[17][1] == {"newly": [2]}
    assert by_cmd[21][1]["done"] == [0, 1]
    assert set(by_cmd[30][1]["lost"]) == {"3", "4"}
    assert by_cmd[42][1] == {"miss": True}
    assert "fenced" in by_cmd[43][1]


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_socket_coordinators_speak_to_the_other_packages_server(client,
                                                                server):
    _, ccoord, _ = PKGS[client]
    str_, _, _ = PKGS[server]
    with contextlib.ExitStack() as stack:
        srv = str_.CoordServer(2, hb_deadline_s=None).start()
        stack.callback(srv.close)
        cos = []
        for h in range(2):
            co = ccoord.SocketCoordinator(
                srv.address, 2, h, timeout_s=WAIT_S, poll_s=0.002,
                mesh_reinit=False, hb_interval_s=0.05)
            stack.callback(co.close)
            cos.append(co)
        out, errs = _run_hosts(
            lambda h: cos[h].all_gather("round", h, {"host": h}), 2)
        assert not errs, errs
        assert out[0] == out[1] == {0: {"host": 0}, 1: {"host": 1}}
        # both hosts' mailbox endpoints are in the server's address book
        with srv.state.lock:
            assert sorted(srv.state.mailbox_addrs) == [0, 1]
        cos[1].put_info({"kind": "replica", "addr": "h:1"})
        assert cos[0].members()["info"] == {
            1: {"kind": "replica", "addr": "h:1"}}
        # fencing: host 0 declares host 1 lost; host 1's next round
        # refuses it, host 0 sees the tombstone
        cos[0].mark_lost(1, reason="fenced by a test")
        with pytest.raises(ccoord.HostLostError):
            cos[1].all_gather("after", 1, 1)
        assert cos[0].lost_hosts() == {1: "fenced by a test"}
        assert cos[0].all_gather("after", 0, 0) == {0: 0}


def test_mailbox_endpoint_answers_the_other_package():
    """A port MailboxServer takes a JAX client's deposit and fetch, and
    the reverse."""
    for srv_tr, srv_buddy, cli_tr in (
            (ttr, tbuddy, jtr),
            (jtr, __import__("paddle_tpu.framework.buddy",
                             fromlist=["BuddyMailbox"]), ttr)):
        box = srv_tr.MailboxServer(srv_buddy.BuddyMailbox(host_id=1))
        try:
            payload = {"kind": "full", "gen": 1, "digest": None,
                       "blob": {"npz": "YWJj", "gen": 1}}
            ack = cli_tr.mailbox_request(
                box.address, {"cmd": "mb_deposit", "owner": 0,
                              "payload": payload})
            assert ack.get("ok"), ack
            got = cli_tr.mailbox_request(box.address,
                                         {"cmd": "mb_fetch", "owner": 0})
            assert got["gen"] == 1 and got["blob"] == payload["blob"]
            assert cli_tr.mailbox_request(
                box.address, {"cmd": "mb_fetch", "owner": 5}) == {
                    "miss": True}
        finally:
            box.close()


# ---------------------------------------------------------------------------
# failover across a replicated server group
# ---------------------------------------------------------------------------

def test_primary_kill_fails_clients_over_and_fences_nobody():
    with contextlib.ExitStack() as stack:
        servers = ttr.replicated_group(2, n_members=2, hb_deadline_s=1.0)
        for s in servers:
            stack.callback(s.close)
        addrs = ",".join(s.address for s in servers)
        cos = []
        for h in range(2):
            co = tcoord.SocketCoordinator(
                addrs, 2, h, timeout_s=WAIT_S, poll_s=0.002,
                mesh_reinit=False, hb_interval_s=0.05, mailbox=False)
            stack.callback(co.close)
            cos.append(co)
        out, errs = _run_hosts(lambda h: cos[h].all_gather("warm", h, h),
                               2)
        assert not errs and out[0] == {0: 0, 1: 1}
        servers[0].kill()
        out, errs = _run_hosts(
            lambda h: cos[h].all_gather("after", h, "v%d" % h), 2)
        assert not errs, errs
        assert out[0] == out[1] == {0: "v0", 1: "v1"}
        assert cos[0].lost_hosts() == {} and cos[1].lost_hosts() == {}
        with servers[1].state.lock:
            assert servers[1].state.role == "primary"
            assert servers[1].state.term == 1
        assert tres.events("transport_promote")
        assert tres.events("transport_failover")
        text = tres.metrics_text()
        assert "paddle_tpu_resilience_transport_failovers_total" in text


def test_stale_ex_primary_is_refused_by_term():
    with contextlib.ExitStack() as stack:
        servers = ttr.replicated_group(2, n_members=2, hb_deadline_s=None)
        for s in servers:
            stack.callback(s.close)
        # the full partition that makes a zombie: no stream reaches it
        servers[0]._repl.stop()
        servers[1]._repl.stop()
        servers[1]._repl._promote()
        with servers[0].state.lock:
            assert (servers[0].state.role, servers[0].state.term) == (
                "primary", 0)
        client = ttr.CoordClient([servers[1].address, servers[0].address],
                                 host_id=0)
        stack.callback(client.close)
        client.call("hello", n_hosts=2)
        assert client.term_seen == 1
        with client._lock:
            client._teardown_locked()
            client._ep_i = 1                 # aim at the zombie
        assert client.call("lost")["term"] == 1
        stale = tres.events("transport_stale_primary")
        assert stale and (stale[-1]["term"], stale[-1]["seen"]) == (0, 1)


# ---------------------------------------------------------------------------
# pods over sockets
# ---------------------------------------------------------------------------

def _toy(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [1], dtype="float32")
        pred = L.fc(x, size=1, param_attr=pkg.ParamAttr(name="pod_w"),
                    bias_attr=pkg.ParamAttr(name="pod_b"))
        loss = L.reduce_mean(L.square(pred - y))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _feeds(n):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        xv = rng.randn(4, 4).astype(np.float32)
        out.append({"x": xv, "y": (xv @ w).astype(np.float32)})
    return out


def _jax_start():
    """The JAX startup's persistables: both packages' hosts start here."""
    main, startup, _ = _toy(pt)
    sc = pt.Scope()
    with pt.scope_guard(sc):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {v.name: np.asarray(sc.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _trainers(pkg, res, root, n):
    main, startup, loss = _toy(pkg)
    start = _jax_start()
    out = []
    for h in range(n):
        if pkg is pt:
            sc = pt.Scope()
            exe = pt.Executor(pt.CPUPlace())
            with pt.scope_guard(sc):
                exe.run(startup)
        else:
            sc = ptt.Scope()
            exe = ptt.Executor(ptt.CPUPlace())
            exe.run(startup, scope=sc)
            ptt.set_params_from_numpy(start, main, sc, ptt.CPUPlace())
        out.append(res.ResilientTrainer(
            exe, main, os.path.join(root, "h%d" % h), fetch_list=[loss],
            checkpoint_every=3, scope=sc, retry_policy=res.RetryPolicy(
                base_delay_s=0.0, jitter=0.0, sleep=lambda s: None)))
    return out


def _param(trainer):
    v = trainer._scope.find_var("pod_w")
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v).copy()


ELASTIC_KINDS = ("host_death", "elastic_shrink", "elastic_grow", "rejoin",
                 "pod_restore", "restore")


def _elastic(name, root, transport):
    pkg = pt if name == "jax" else ptt
    tr, coord, res = PKGS[name]
    res.clear_events()
    trainers = _trainers(pkg, res, root, 4)
    with contextlib.ExitStack() as stack:
        if transport == "socket":
            srv = tr.CoordServer(4).start()
            stack.callback(srv.close)
            co = coord.SocketCoordinator(srv.address, 4, 0,
                                         timeout_s=WAIT_S, poll_s=0.002)
            stack.callback(co.close)
        else:
            co = coord.LocalCoordinator(4, timeout_s=WAIT_S)
        pod = coord.ElasticTrainer(trainers, co)
        with res.inject("step:die@14"):
            out = pod.run(_feeds(6))
    sig = sorted((e["kind"], str(e.get("capacity"))) for e in res.events()
                 if e["kind"] in ELASTIC_KINDS)
    return out, [_param(t) for t in trainers], sig


def test_elastic_pod_over_a_socket_coordinator(tmp_path):
    """Die, shrink to 3/4, rejoin at 4/4 over one shared port
    SocketCoordinator: bit-equal to the LocalCoordinator run, the JAX
    package's events over its own socket plane."""
    _, local_w, local_sig = _elastic("torch", str(tmp_path / "l"),
                                     "local")
    _, sock_w, sock_sig = _elastic("torch", str(tmp_path / "s"), "socket")
    _, jax_w, jax_sig = _elastic("jax", str(tmp_path / "j"), "socket")
    assert sock_sig == local_sig == jax_sig
    assert [k for k, _ in sock_sig].count("host_death") == 1
    assert ("elastic_shrink", "3/4") in sock_sig
    for a, b, c in zip(sock_w, local_w, jax_w):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-5)


def test_host_id_pod_restores_from_peer_mailboxes_over_tcp(tmp_path):
    """One PodResilientTrainer a host, each on its own SocketCoordinator
    with its MailboxServer: a preemption restores every host from the
    buddy snapshots deposited over TCP (outcome ok, no disk read), and
    the weights equal the uninterrupted run's bit for bit."""
    feeds = _feeds(8)

    def run(tag, fault):
        tres.clear_events()
        trainers = _trainers(ptt, tres, str(tmp_path / tag), 2)
        with contextlib.ExitStack() as stack:
            srv = ttr.CoordServer(2).start()
            stack.callback(srv.close)
            pods = []
            for h in range(2):
                co = tcoord.SocketCoordinator(
                    srv.address, 2, h, timeout_s=WAIT_S, poll_s=0.002,
                    mesh_reinit=False, hb_interval_s=0.05)
                stack.callback(co.close)
                pods.append(tcoord.PodResilientTrainer(
                    [trainers[h]], co, host_id=h, buddy=True,
                    buddy_p2p=True, buddy_compress="zlib"))
            ctx = tres.inject(fault) if fault else contextlib.nullcontext()
            with ctx:
                out, errs = _run_hosts(lambda h: pods[h].run(feeds), 2)
            assert not errs, errs
            with srv.state.lock:
                meta = dict(srv.state.buddy_meta)
        return [_param(t) for t in trainers], meta

    ref, _ = run("ref", None)
    got, meta = run("chaos", "step:preempt@5")
    restores = tres.events("buddy_restore")
    assert restores and {e["outcome"] for e in restores} == {"ok"}
    assert not tres.events("restore")
    assert sorted(meta) == [0, 1]            # metadata only on the server
    assert all("blob" not in rec for rec in meta.values())
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _hb_lag_drain(name, root):
    """Three hosts in host_id mode, each on its own SocketCoordinator,
    host 2's heartbeat thread delayed 1 s a beat (the
    ``coordination.hb`` failpoint): its client's lag is carried on the
    window exchange, and ``drain_hb_lag_s=0.5`` drains it with no
    compute latch anywhere. Returns (the drain and shrink events, the
    hosts the server holds lost, each host's fetch count)."""
    pkg = pt if name == "jax" else ptt
    tr, coord, res = PKGS[name]
    fi = importlib.import_module(pkg.__name__ + ".framework.faultinject")
    res.clear_events()
    trainers = _trainers(pkg, res, root, 3)
    with contextlib.ExitStack() as stack:
        srv = tr.CoordServer(3).start()
        stack.callback(srv.close)
        stack.enter_context(fi.failpoints("coordination.hb:delay=1.0^2"))
        cos = []
        for h in range(3):
            cos.append(coord.SocketCoordinator(
                srv.address, 3, h, timeout_s=WAIT_S, poll_s=0.002,
                mesh_reinit=False, hb_interval_s=0.05))
            stack.callback(cos[-1].close)
        # the lag is measured once a delayed beat has landed
        deadline = time.monotonic() + WAIT_S
        while cos[2]._client.hb_lag_s <= 0.5:
            assert time.monotonic() < deadline, "no heartbeat lag"
            time.sleep(0.02)
        pods = [coord.ElasticTrainer([trainers[h]], cos[h], host_id=h,
                                     rejoin=False, drain_after=2,
                                     drain_hb_lag_s=0.5)
                for h in range(3)]
        for pod in pods:
            pod._straggler_flag = lambda hid: False
        out, errs = _run_hosts(lambda h: pods[h].run(_feeds(6)), 3)
        assert not errs, errs
        lost = sorted(int(h) for h in cos[0].lost_hosts())
    sig = sorted((e["kind"], int(e["drained"]) if "drained" in e
                  else str(e.get("capacity")))
                 for e in res.events()
                 if e["kind"] in ("elastic_drain", "elastic_shrink"))
    return sig, lost, [sum(o is not None for o in out[h]) for h in range(3)]


def test_heartbeat_lag_drains_a_host_over_sockets(tmp_path):
    """The heartbeat-lag drain on the transport's own measurement: the
    port drains the lagging host exactly as the JAX package does, and
    the two survivors run every step."""
    got = {name: _hb_lag_drain(name, str(tmp_path / name))
           for name in PKGS}
    assert got["torch"] == got["jax"]
    sig, lost, fetched = got["torch"]
    assert ("elastic_drain", 2) in sig and lost == [2]
    assert fetched[0] == fetched[1] == 6
