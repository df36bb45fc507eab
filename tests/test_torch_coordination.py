"""The pod coordinators of paddle_tpu_torch held to the JAX package's.

Each scenario of tests/test_pod_recovery.py's and tests/test_elastic.py's
coordinator batteries runs through both packages' Local and File
coordinators (threads as simulated hosts, one FileCoordinator object a
simulated process) and must reach the same verdicts: gathered values,
elected steps, lost maps, fired hooks, the events' kinds and fields. The
mesh hooks run on a size-1 mesh, the one mesh a single card has. No test
binds a port or spawns a process; exact equality throughout (there is no
arithmetic to round).
"""
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.framework import coordination as jax_coord
from paddle_tpu.framework import resilience as jax_res
from paddle_tpu_torch.distributed import mesh as pt_mesh
from paddle_tpu_torch.framework import coordination as pt_coord
from paddle_tpu_torch.framework import resilience as pt_res
from paddle_tpu_torch.ops.registry import NotPortedError

PKGS = {"jax": (jax_coord, jax_res, jax_mesh),
        "torch": (pt_coord, pt_res, pt_mesh)}


@pytest.fixture(autouse=True)
def _clean():
    for _, res, mesh in PKGS.values():
        res.install(None)
        res.clear_events()
        mesh.clear_reinit_hooks()
        mesh.reset_mesh()
    yield
    for _, res, mesh in PKGS.values():
        res.install(None)
        res.clear_events()
        mesh.clear_reinit_hooks()
        mesh.reset_mesh()


def _run_hosts(fn, n):
    """fn(host_id) on n threads: ({hid: result}, {hid: error type})."""
    out, errs = {}, {}

    def worker(hid):
        try:
            out[hid] = fn(hid)
        except Exception as e:
            errs[hid] = type(e).__name__

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out, errs


def _events(res, *kinds):
    return [{k: v for k, v in e.items() if k != "time"}
            for e in res.events() if e["kind"] in kinds]


def _both(scenario, *args):
    """The scenario's verdict in each package; they must be equal."""
    got = {name: scenario(*mods, *args) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_local_gather_barrier_and_round_cleanup():
    def scenario(coord, res, mesh):
        co = coord.LocalCoordinator(3, timeout_s=5.0)
        g = _run_hosts(lambda h: co.all_gather("g1", h, h * 10), 3)
        rounds = dict(co._rounds)
        b = _run_hosts(lambda h: co.barrier("b1", h), 3)
        return g, rounds, b, co.live_hosts(), co.lost_hosts()
    g, rounds, b, live, lost = _both(scenario)
    assert g == ({0: {0: 0, 1: 10, 2: 20}, 1: {0: 0, 1: 10, 2: 20},
                  2: {0: 0, 1: 10, 2: 20}}, {})
    assert rounds == {} and b[0][0] == [0, 1, 2]
    assert live == [0, 1, 2] and lost == {}


def test_local_elect_consensus_and_quorum():
    def scenario(coord, res, mesh):
        co = coord.LocalCoordinator(3, timeout_s=5.0, mesh_reinit=False)
        valid = {0: [0, 3, 6], 1: [0, 3], 2: [0, 3, 6]}
        disjoint = {0: [1], 1: [2], 2: []}
        return (_run_hosts(lambda h: co.elect_restore_step(
                    h, valid[h], name="r1"), 3),
                _run_hosts(lambda h: co.elect_restore_step(
                    h, valid[h], name="r2", quorum=2), 3),
                _run_hosts(lambda h: co.elect_restore_step(
                    h, disjoint[h], name="r3"), 3),
                sorted((e["step"], e["quorum"])
                       for e in _events(res, "consensus")))
    all_q, two_q, none_q, consensus = _both(scenario)
    assert all_q == ({0: 3, 1: 3, 2: 3}, {})
    assert two_q == ({0: 6, 1: 6, 2: 6}, {})
    assert none_q == ({}, {h: "NoQuorumError" for h in range(3)})
    assert consensus == [(3, 3)] * 3 + [(6, 2)] * 3


def test_local_loss_detection_fires_mesh_hooks_on_a_size1_mesh():
    def scenario(coord, res, mesh):
        mesh.init_mesh({"dp": 1})
        hooks = []
        mesh.add_reinit_hook(
            lambda lost, live, m: hooks.append((lost, live,
                                                dict(m.shape))))
        co = coord.LocalCoordinator(3, timeout_s=0.3)
        out = _run_hosts(
            lambda h: co.all_gather("g", h, h) if h < 2 else None, 3)
        lost, live = co.lost_hosts(), co.live_hosts()
        try:
            co.all_gather("g2", 2, None)
            fenced = None
        except coord.HostLostError as e:
            fenced = "fenced" in str(e)
        after = _run_hosts(
            lambda h: co.barrier("after", h) if h < 2 else None, 3)
        return (out, lost, live, hooks, fenced, after,
                _events(res, "host_lost", "mesh_reinit"))
    out, lost, live, hooks, fenced, after, evs = _both(scenario)
    assert out[0][0] == out[0][1] == {0: 0, 1: 1}
    assert lost == {2: "missed round 'g'"} and live == [0, 1]
    assert hooks == [([2], [0, 1], {"dp": 1})]
    assert fenced is True and after[0][0] == [0, 1]
    assert [e["kind"] for e in evs] == ["host_lost", "mesh_reinit"]


def test_mesh_absorb_and_reshard_on_a_size1_mesh():
    def scenario(coord, res, mesh):
        mesh.init_mesh({"dp": 1})
        calls = []
        mesh.add_reinit_hook(lambda lost, live, m: calls.append(
            (tuple(lost), tuple(live), dict(m.shape))))
        mesh.handle_host_loss([3], [0, 1, 2])
        mesh.handle_host_loss([0, 3], [1, 2])
        mesh.absorb_hosts([0, 3], [0, 1, 2, 3])
        m = mesh.get_mesh()
        state = {"w": np.arange(4.0)}
        moved = mesh.reshard_state(state, m, m)
        return (calls, mesh.mesh_axes(),
                np.array_equal(moved["w"], state["w"]),
                _events(res, "mesh_reinit", "mesh_absorb", "reshard"))
    calls, axes, same, evs = _both(scenario)
    assert calls == [((3,), (0, 1, 2), {"dp": 1}),
                     ((0, 3), (1, 2), {"dp": 1}),
                     ((), (0, 1, 2, 3), {"dp": 1})]
    assert axes == ("dp",) and same
    assert evs[2]["capacity"] == "4/4" and evs[3]["moved"] == 0


def test_local_timeout_without_detection_and_duplicates():
    def scenario(coord, res, mesh):
        co = coord.LocalCoordinator(2, timeout_s=0.2, detect_loss=False)
        try:
            co.all_gather("never", 0, None)
            timeout = None
        except coord.BarrierTimeoutError as e:
            timeout = "timed out" in str(e)
        co = coord.LocalCoordinator(2, timeout_s=10.0)
        box = {}
        t = threading.Thread(
            target=lambda: box.update(got=co.all_gather("r", 0, "first")))
        t.start()
        for _ in range(2000):
            if co._rounds.get("r", {}).get("values"):
                break
            time.sleep(0.005)
        try:
            co.all_gather("r", 0, "imposter")
            dup = None
        except coord.CoordinationError as e:
            dup = "already contributed" in str(e)
        co.all_gather("r", 1, "second")
        t.join(timeout=10)
        return timeout, co.lost_hosts(), dup, box["got"]
    assert _both(scenario) == (True, {}, True, {0: "first", 1: "second"})


def test_local_rejoin_round_trip_and_abandoned_admission():
    def scenario(coord, res, mesh):
        co = coord.LocalCoordinator(3, timeout_s=10.0, mesh_reinit=False)
        try:
            co.announce_join(1, 1)
            refused = None
        except coord.CoordinationError as e:
            refused = "not fenced" in str(e)
        co.mark_lost(2, "preempted")
        co.announce_join(2, 1)
        pending = co.pending_joins()

        def party(h):
            if h == 2:
                return co.join(2, 1)
            return co.admit(h, 2, 1, [7, 3, 0])
        joined = _run_hosts(party, 3)
        state = (co.live_hosts(), co.pending_joins())
        co2 = coord.LocalCoordinator(3, timeout_s=0.3, mesh_reinit=False)
        co2.mark_lost(2, "gone")
        co2.announce_join(2, 1)
        abandoned = _run_hosts(
            lambda h: co2.admit(h, 2, 1, [5, 2, 0]) if h < 2 else None, 3)
        return (refused, pending, joined, state, abandoned,
                2 in co2.lost_hosts(),
                [(e["kind"], e.get("hosts"))
                 for e in _events(res, "host_join", "join_abort")])
    refused, pending, joined, state, abandoned, refenced, evs = \
        _both(scenario)
    assert refused is True and pending == {2: 1}
    assert joined == ({0: [7, 3, 0], 1: [7, 3, 0], 2: [7, 3, 0]}, {})
    assert state == ([0, 1, 2], {})
    assert abandoned == ({0: None, 1: None, 2: None}, {}) and refenced
    assert evs[0] == ("host_join", [2]) and evs[-1][0] == "join_abort"


def test_local_resize_fences_grown_slots_and_refuses_live_shrink():
    def scenario(coord, res, mesh):
        co = coord.LocalCoordinator(2, timeout_s=10.0, mesh_reinit=False)
        grown = co.resize(3)
        lost = co.lost_hosts()
        try:
            co.resize(1)
            refused = None
        except coord.CoordinationError as e:
            refused = "still live" in str(e)
        try:
            co.resize(0)
            bad = None
        except ValueError:
            bad = True
        return (grown, lost, refused, bad,
                [e["n_hosts"] for e in _events(res, "group_resize")])
    grown, lost, refused, bad, sizes = _both(scenario)
    assert grown == 3 and lost == {2: jax_coord.GROW_FENCE_REASON}
    assert refused is True and bad is True and sizes == [3]


def test_agreed_pending_is_the_lowest_hosts_first_common_pair():
    verdicts = {0: ["ok", [[2, 1], [3, 1]]], 1: ["ok", [[3, 1], [2, 1]]],
                3: ["ok", [[3, 1]]]}
    assert pt_coord.agreed_pending(verdicts) == \
        jax_coord.agreed_pending(verdicts) == [3, 1]
    assert pt_coord.agreed_pending({}) is None


def test_file_coordinator_round_trip_cleanup_and_duplicates(tmp_path):
    def scenario(coord, res, mesh, root):
        cos = [coord.FileCoordinator(root, 3, timeout_s=10.0,
                                     poll_s=0.002, mesh_reinit=False)
               for _ in range(3)]
        g = _run_hosts(lambda h: cos[h].all_gather("g1", h, {"host": h}),
                       3)
        valid = {0: [0, 3, 6], 1: [0, 3], 2: [0, 3, 6]}
        e = _run_hosts(lambda h: cos[h].elect_restore_step(
            h, valid[h], name="e1"), 3)
        left = os.listdir(os.path.join(root, "rounds"))
        again = _run_hosts(lambda h: cos[h].all_gather("g1", h, 10 + h),
                           3)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            got=cos[0].all_gather("dup", 0, "real")))
        t.start()
        rd = os.path.join(root, "rounds", "dup")
        for _ in range(2000):
            if os.path.exists(os.path.join(rd, "host_0.json")):
                break
            time.sleep(0.005)
        try:
            cos[0].all_gather("dup", 0, "imposter")
            dup = None
        except coord.CoordinationError as err:
            dup = "already contributed" in str(err)
        names = {1: "second", 2: "third"}
        _run_hosts(lambda h: cos[h].all_gather("dup", h, names[h])
                   if h else None, 3)
        t.join(timeout=10)
        return g, e, left, again[0][0], dup, box["got"]
    got = {name: scenario(*mods, str(tmp_path / name))
           for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    g, e, left, again, dup, final = got["torch"]
    assert g[0][2] == {0: {"host": 0}, 1: {"host": 1}, 2: {"host": 2}}
    assert e == ({0: 3, 1: 3, 2: 3}, {}) and left == []
    assert again == {0: 10, 1: 11, 2: 12} and dup is True
    assert final == {0: "real", 1: "second", 2: "third"}


def test_file_coordinator_tombstones_and_rejoin(tmp_path):
    def scenario(coord, res, mesh, root):
        cos = [coord.FileCoordinator(root, 3, timeout_s=0.4, poll_s=0.002,
                                     mesh_reinit=False) for _ in range(3)]
        fired = {0: [], 1: [], 2: []}
        for h, co in enumerate(cos):
            co.add_host_loss_hook(
                lambda lost, live, h=h: fired[h].append(lost))
        g = _run_hosts(
            lambda h: cos[h].all_gather("g", h, h) if h < 2 else None, 3)
        seen = [2 in co.lost_hosts() for co in cos]
        try:
            cos[2].all_gather("g2", 2, None)
            fenced = None
        except coord.HostLostError:
            fenced = True
        _run_hosts(
            lambda h: cos[h].all_gather("g3", h, h) if h < 2 else None, 3)
        for co in cos:
            co.timeout_s = 10.0
        cos[2].announce_join(2, 1)

        def party(h):
            if h == 2:
                return cos[2].join(2, 1)
            return cos[h].admit(h, 2, 1, [4, 2, 1])
        joined = _run_hosts(party, 3)
        return (g, seen, fenced, fired, joined,
                [co.live_hosts() for co in cos])
    got = {name: scenario(*mods, str(tmp_path / name))
           for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    g, seen, fenced, fired, joined, live = got["torch"]
    assert g[0][0] == {0: 0, 1: 1} and seen == [True] * 3 and fenced
    assert fired == {0: [[2]], 1: [[2]], 2: []}
    assert joined == ({0: [4, 2, 1], 1: [4, 2, 1], 2: [4, 2, 1]}, {})
    assert live == [[0, 1, 2]] * 3


def test_file_coordinator_heartbeat_deadline_and_poll_backoff(tmp_path,
                                                              monkeypatch):
    def scenario(coord, res, mesh, root):
        cos = [coord.FileCoordinator(root, 3, timeout_s=30.0,
                                     poll_s=0.002, poll_max_s=0.05,
                                     mesh_reinit=False, hb_deadline_s=0.5)
               for _ in range(3)]
        cos[2]._touch_hb(2)
        t0 = time.monotonic()
        g = _run_hosts(
            lambda h: cos[h].all_gather("g", h, h) if h < 2 else None, 3)
        quick = time.monotonic() - t0 < 10.0
        lost = cos[0].lost_hosts()
        co = coord.FileCoordinator(root + "2", 2, timeout_s=0.5,
                                   poll_s=0.01, poll_max_s=0.08,
                                   detect_loss=False, mesh_reinit=False)
        sleeps = []
        real = time.sleep
        monkeypatch.setattr(coord.time, "sleep", lambda s: (
            sleeps.append(s), real(min(s, 0.01))))
        try:
            co.all_gather("never", 0, None)
            timed_out = None
        except coord.BarrierTimeoutError:
            timed_out = True
        finally:
            monkeypatch.setattr(coord.time, "sleep", real)
        try:
            coord.FileCoordinator(root + "3", 2, poll_s=0.2,
                                  hb_deadline_s=0.5)
            tight = None
        except ValueError:
            tight = True
        return (g[0][0], quick, sorted(lost),
                "missed heartbeat" in lost.get(2, ""), timed_out,
                [round(s, 6) for s in sleeps[:4]],
                max(sleeps) <= 0.08 + 1e-9, tight)
    got = {name: scenario(*mods, str(tmp_path / name))
           for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"] == ({0: 0, 1: 1}, True, [2], True, True,
                            [0.01, 0.02, 0.04, 0.08], True, True)


def test_socket_coordinator_and_multi_device_mesh_are_not_ported():
    with pytest.raises(NotPortedError, match="transport"):
        pt_coord.SocketCoordinator("127.0.0.1:1", 2, 0)
    with pytest.raises(NotPortedError, match="torch.distributed"):
        pt_mesh.init_mesh({"dp": 2}, devices=[0, 1])
    with pytest.raises(ValueError, match="needs 4 devices"):
        pt_mesh.init_mesh({"dp": 4})
    assert pt_mesh.get_mesh() is None
    m = pt_mesh.init_mesh({"dp": 1, "mp": 1})
    assert m.shape == {"dp": 1, "mp": 1} and pt_mesh.get_mesh() is m
