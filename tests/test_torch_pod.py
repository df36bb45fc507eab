"""PodResilientTrainer and ElasticTrainer of paddle_tpu_torch held to the
JAX package's, on the small fc program of tests/test_pod_recovery.py.

Every host of a pod (a thread on a LocalCoordinator with its own
Executor, Scope and checkpoint dir) starts from the same weights, copied
from one JAX startup. Each scenario runs the same seeded feeds through
both packages' pods and compares:

- the recovery events (kind with its ``step``, ``capacity``,
  ``outcome``, ``batch`` and ``reason`` fields, as a multiset over the
  hosts): equal;
- each host's per-step fetches and final parameters: within
  ``RTOL = 1e-6`` of the JAX pod's (f32 Adam on the same ops, as
  tests/test_torch_resilience.py states);
- the port's faulted pod against its own uninterrupted pod: bit for bit.

All on CPUPlace; no test binds a port or spawns a process.
"""
import contextlib
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import coordination as jcoord
from paddle_tpu.framework import faultinject as jfi
from paddle_tpu.framework import resilience as jres
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu_torch.framework import coordination as tcoord
from paddle_tpu_torch.framework import faultinject as tfi
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.ops.registry import NotPortedError

RTOL = 1e-6
POD_TIMEOUT_S = 300.0
PKGS = {"jax": (pt, jcoord, jres, jfi), "torch": (ptt, tcoord, tres, tfi)}
FIELDS = ("step", "capacity", "outcome", "batch", "reason")


@pytest.fixture(autouse=True)
def _clean():
    for _, _, res, fi in PKGS.values():
        res.install(None)
        res.clear_events()
        fi.disarm()
    yield
    for _, _, res, fi in PKGS.values():
        res.install(None)
        res.clear_events()
        fi.disarm()


def _program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [1], dtype="float32")
        pred = L.fc(x, size=1, param_attr=pkg.ParamAttr(name="pod_w"),
                    bias_attr=pkg.ParamAttr(name="pod_b"))
        loss = L.reduce_mean(L.square(pred - y))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=0, batch=4):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        xv = rng.randn(batch, 4).astype(np.float32)
        out.append({"x": xv, "y": (xv @ w).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def weights():
    main, startup, _ = _program(pt)
    sc = JScope()
    with jscope_guard(sc):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {v.name: np.asarray(sc.find_var(v.name))
            for v in main.list_vars() if v.persistable}


def _host(pkg, weights, main, startup):
    """(scope, executor) of one host holding ``weights``."""
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is pt:
        import jax.numpy as jnp
        sc = JScope()
        with jscope_guard(sc):
            exe.run(startup)
        for n, a in weights.items():
            sc.set_var(n, jnp.asarray(a))
    else:
        sc = ptt.Scope()
        exe.run(startup, scope=sc)
        ptt.set_params_from_numpy(weights, main, sc, ptt.CPUPlace())
    return sc, exe


def _pod(name, weights, root, n_hosts, elastic=False, policy=None,
         compiled=False, checkpoint_every=3, **pod_kw):
    pkg, coord, res, _ = PKGS[name]
    main, startup, loss = _program(pkg)
    target = main
    if policy is not None or compiled:
        bs = pkg.BuildStrategy()
        bs.mesh_axes = {"dp": 1}
        if policy is not None:
            bs.numeric_policy = policy
        target = pkg.CompiledProgram(main, bs)
    trainers = []
    for h in range(n_hosts):
        sc, exe = _host(pkg, weights, main, startup)
        trainers.append(res.ResilientTrainer(
            exe, target, os.path.join(root, name, "h%d" % h),
            fetch_list=[loss], checkpoint_every=checkpoint_every,
            scope=sc, retry_policy=res.RetryPolicy(
                base_delay_s=0.0, jitter=0.0, sleep=lambda s: None)))
    cls = coord.ElasticTrainer if elastic else coord.PodResilientTrainer
    pod = cls(trainers, coord.LocalCoordinator(n_hosts,
                                               timeout_s=POD_TIMEOUT_S),
              **pod_kw)
    return pod, trainers


def _param(trainer, name="pod_w"):
    v = trainer._scope.find_var(name)
    return v.numpy().copy() if hasattr(v, "numpy") else np.asarray(v)


def _signature(res, kinds):
    return sorted(tuple([e["kind"]] + [str(e.get(f)) for f in FIELDS])
                  for e in res.events() if e["kind"] in kinds)


def _fetches(out):
    return [[None if o is None else float(np.ravel(np.asarray(o[0]))[0])
             for o in host] for host in out]


def _run(name, weights, root, feeds, fault=None, failpoint=None,
         kinds=(), run_feeds=None, mutate=None, **pod_kw):
    """One pod run in package ``name``: (per-host fetches, per-host
    final pod_w, the event signature, the pod, its trainers)."""
    _, _, res, fi = PKGS[name]
    res.clear_events()
    pod, trainers = _pod(name, weights, root, **pod_kw)
    if mutate is not None:
        mutate(pod)
    ctx = contextlib.ExitStack()
    if fault:
        ctx.enter_context(res.inject(fault))
    if failpoint:
        ctx.enter_context(fi.failpoints(failpoint))
    with ctx:
        out = pod.run(feeds if run_feeds is None else run_feeds)
    return (_fetches(out), [_param(t) for t in trainers],
            _signature(res, kinds), pod, trainers)


def _close(port, jax):
    """Per-host fetches and params of the port within RTOL of the JAX
    pod's (None where a host missed a step). Hosts pair up by the steps
    they missed: which thread a fault lands on is a race in either
    package."""
    def hosts(run):
        return sorted(zip(run[0], run[1]),
                      key=lambda hp: [x is None for x in hp[0]])
    for (fa, pa), (fb, pb) in zip(hosts(port), hosts(jax)):
        assert [x is None for x in fa] == [y is None for y in fb]
        np.testing.assert_allclose(
            [x for x in fa if x is not None],
            [y for y in fb if y is not None], rtol=RTOL)
        np.testing.assert_allclose(pa, pb, rtol=RTOL)


RESTORE_KINDS = ("pod_restore", "pod_restart", "consensus",
                 "buddy_restore", "fault", "restore")


@pytest.mark.parametrize("buddy", [True, False])
def test_preempt_consensus_restore_with_and_without_buddy(tmp_path,
                                                          weights, buddy):
    feeds = _feeds(12)
    ref = _run("torch", weights, str(tmp_path / "ref"), feeds, n_hosts=4,
               buddy=buddy)
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=4,
                      buddy=buddy, fault="step:preempt@7",
                      kinds=RESTORE_KINDS)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    _close(got["torch"], got["jax"])
    assert got["torch"][0] == ref[0] and all(
        np.array_equal(a, b) for a, b in zip(got["torch"][1], ref[1]))
    restores = {e[1] for e in got["torch"][2] if e[0] == "pod_restore"}
    outcomes = {e[3] for e in got["torch"][2] if e[0] == "buddy_restore"}
    # fire 7 lands in window 2: the buddy tier restores its boundary
    # (step 1), the disk rewind the step-0 baseline
    assert restores == ({"1"} if buddy else {"0"})
    assert outcomes == ({"ok"} if buddy else set())


@pytest.mark.parametrize("fault,failpoint", [
    ("ckpt_write:io_error@6", None), (None, "io.manifest_write:raise@6")])
def test_torn_checkpoint_lowers_the_consensus(tmp_path, weights, fault,
                                              failpoint):
    feeds = _feeds(6)
    ref = _run("torch", weights, str(tmp_path / "ref"), feeds, n_hosts=4,
               buddy=False)
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=4,
                      buddy=False, fault=fault, failpoint=failpoint,
                      kinds=RESTORE_KINDS)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    _close(got["torch"], got["jax"])
    assert got["torch"][0] == ref[0]
    assert {e[1] for e in got["torch"][2]
            if e[0] in ("pod_restore", "consensus")} == {"0"}


def test_fatal_error_aborts_every_host(tmp_path, weights):
    feeds = [_feeds(4), _feeds(4)]
    feeds[1][2] = dict(feeds[1][2], x=np.zeros((4, 4, 9), np.float32))
    for name in PKGS:
        with pytest.raises(ValueError):
            _run(name, weights, str(tmp_path), None, n_hosts=2,
                 run_feeds=feeds)
        res = PKGS[name][2]
        assert res.events("fatal") and not res.events("pod_restore")


def test_shared_restart_budget_exhausts_together(tmp_path, weights):
    sigs = {}
    for name in PKGS:
        res = PKGS[name][2]
        res.clear_events()
        pod, _ = _pod(name, weights, str(tmp_path), n_hosts=2)
        pod._max_restarts = 2
        with res.inject("step:preempt~1.0"):
            with pytest.raises(res.RestartBudgetExceededError,
                               match="pod restart budget"):
                pod.run(_feeds(4))
        sigs[name] = _signature(res, ("pod_restart", "giveup"))
    assert sigs["torch"] == sigs["jax"]
    assert [e[0] for e in sigs["torch"]].count("pod_restart") == 4
    assert [e[0] for e in sigs["torch"]].count("giveup") == 2


def test_poisoned_batch_rewind_skips_it_on_every_host(tmp_path, weights):
    feeds = _feeds(9)
    clean = [f for i, f in enumerate(feeds) if i != 4]
    ref = _run("torch", weights, str(tmp_path / "ref"), clean, n_hosts=3,
               policy="rewind", buddy=False)
    kinds = ("pod_restore", "poison_batch", "poison_skip")
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=3,
                      policy="rewind", buddy=False,
                      failpoint="executor.step:corrupt=x@5^1",
                      kinds=kinds)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    _close(got["torch"], got["jax"])
    assert [e[1] for e in got["torch"][2] if e[0] == "pod_restore"] \
        == ["3"] * 3
    assert {e[4] for e in got["torch"][2] if e[0] == "poison_skip"} \
        == {"4"}
    for h in range(3):
        assert got["torch"][0][h][4] is None
        assert got["torch"][0][h][:4] + got["torch"][0][h][5:] \
            == ref[0][h]
        np.testing.assert_array_equal(got["torch"][1][h], ref[1][h])


ELASTIC_KINDS = ("elastic_shrink", "elastic_grow", "rejoin", "host_exit",
                 "host_death", "pod_restore", "restore", "sync_ship")


def _no_step(sig):
    """An elastic signature without the grow and rejoin steps: which
    window re-admits the joiner depends on when its announcement lands
    against the survivors' next exchange, in either package."""
    return sorted((e[0], e[2]) for e in sig)


def test_elastic_continue_and_reabsorb(tmp_path, weights):
    feeds = _feeds(6)
    ref = _run("torch", weights, str(tmp_path / "ref"), feeds, n_hosts=1,
               elastic=True, compiled=True)
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=4,
                      elastic=True, compiled=True, fault="step:die@14",
                      kinds=ELASTIC_KINDS)
           for name in PKGS}
    assert _no_step(got["torch"][2]) == _no_step(got["jax"][2])
    sig = got["torch"][2]
    # continue, do not rewind: shrink at 3/4 at the dying window's step,
    # grow back at 4/4, no restore of any kind
    assert [e[0] for e in sig].count("host_death") == 1
    assert {(e[1], e[2]) for e in sig if e[0] == "elastic_shrink"} \
        == {("3", "3/4")}
    assert {e[2] for e in sig if e[0] == "elastic_grow"} == {"4/4"}
    assert not [e for e in sig if e[0] in ("pod_restore", "restore")]
    for h in range(4):
        np.testing.assert_array_equal(got["torch"][1][h], ref[1][0])
        np.testing.assert_allclose(got["torch"][1][h], got["jax"][1][h],
                                   rtol=RTOL)
        if None not in got["torch"][0][h]:
            assert got["torch"][0][h] == ref[0][0]
    pod, trainers = got["torch"][3], got["torch"][4]
    assert all(t._target._build_strategy.mesh_axes == {"dp": 1}
               for t in trainers)
    assert all(a == {"dp": 1} for a in pod._frozen_axes.values())


def test_elastic_shrink_without_rejoin_finishes_reduced(tmp_path,
                                                        weights):
    feeds = _feeds(6)
    ref = _run("torch", weights, str(tmp_path / "ref"), feeds, n_hosts=3,
               elastic=True, rejoin=False)
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=3,
                      elastic=True, rejoin=False, fault="step:die@5",
                      kinds=ELASTIC_KINDS)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    kinds = {e[0] for e in got["torch"][2]}
    assert kinds == {"elastic_shrink", "host_exit", "host_death"}
    for h in range(3):
        if None in got["torch"][0][h]:
            continue
        assert got["torch"][0][h] == ref[0][h]
    _close(got["torch"], got["jax"])


def test_elastic_rejoin_ships_state_through_sync_dir(tmp_path, weights):
    feeds = _feeds(6)
    got = {name: _run(name, weights, str(tmp_path / name), feeds,
                      n_hosts=2, elastic=True,
                      sync_dir=str(tmp_path / name / "sync"),
                      fault="step:die@3", kinds=ELASTIC_KINDS)
           for name in PKGS}
    assert _no_step(got["torch"][2]) == _no_step(got["jax"][2])
    sig = got["torch"][2]
    assert "sync_ship" in {e[0] for e in sig}
    assert "pod_restore" not in {e[0] for e in sig}
    np.testing.assert_array_equal(got["torch"][1][0], got["torch"][1][1])
    _close(got["torch"], got["jax"])
    sync_step = int([e[1] for e in sig if e[0] == "rejoin"][0])
    for h in range(2):
        report = ptt.io.scrub_checkpoint(
            str(tmp_path / "torch" / "torch" / ("h%d" % h)))
        assert sync_step in report["valid_steps"]


def test_elastic_transient_fault_still_rewinds(tmp_path, weights):
    feeds = _feeds(6)
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=2,
                      elastic=True, fault="step:preempt@5",
                      kinds=ELASTIC_KINDS + RESTORE_KINDS)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    assert "pod_restore" in {e[0] for e in got["torch"][2]}
    assert "elastic_shrink" not in {e[0] for e in got["torch"][2]}
    _close(got["torch"], got["jax"])


def _systemic_then_host2(pod):
    calls = {0: 0, 1: 0, 2: 0}

    def flag(hid):
        calls[hid] += 1
        return calls[hid] <= 2 or (hid == 2 and calls[hid] <= 5)
    pod._straggler_flag = flag


def _lagging_host2(pod):
    """Host 2's heartbeat lag 2 s, no compute latch anywhere (the JAX
    package's test_drain_weighs_heartbeat_lag_not_just_compute)."""
    pod._straggler_flag = lambda hid: False
    pod._hb_lag = lambda hid: 2.0 if hid == 2 else 0.0


@pytest.mark.parametrize("case", ["drain", "floor", "cooldown", "hb_lag"])
def test_straggler_drain_floor_and_cooldown(tmp_path, weights, case):
    kw = {"drain": dict(n_hosts=3, drain_after=2,
                        mutate=_systemic_then_host2),
          "hb_lag": dict(n_hosts=3, drain_after=2, drain_hb_lag_s=0.5,
                         mutate=_lagging_host2),
          "floor": dict(n_hosts=2, drain_after=1, drain_floor=2,
                        mutate=lambda p: setattr(
                            p, "_straggler_flag", lambda h: h == 1)),
          "cooldown": dict(n_hosts=3, drain_after=1, drain_cooldown=50,
                           mutate=lambda p: setattr(
                               p, "_straggler_flag", lambda h: h >= 1))}[case]
    kinds = ("elastic_drain", "elastic_shrink", "drain_deferred",
             "host_exit", "pod_restore")
    got = {name: _run(name, weights, str(tmp_path), _feeds(6),
                      elastic=True, rejoin=False, kinds=kinds, **kw)
           for name in PKGS}
    assert got["torch"][2] == got["jax"][2]
    _close(got["torch"], got["jax"])
    sig = got["torch"][2]
    drains = [e for e in sig if e[0] == "elastic_drain"]
    if case == "floor":
        assert not drains and {e[5] for e in sig} == {"floor"}
    elif case == "cooldown":
        assert len({e[1] for e in drains}) == 1
        assert "cooldown" in {e[5] for e in sig}
    else:
        assert drains and "pod_restore" not in {e[0] for e in sig}
    if case == "hb_lag":
        assert {int(e["drained"]) for e in tres.events("elastic_drain")} \
            == {2}
    lost = got["torch"][3].coordinator.lost_hosts()
    assert lost == got["jax"][3].coordinator.lost_hosts()


def test_sdc_suspect_drains_and_survivors_stay_bit_equal(tmp_path,
                                                         weights):
    feeds = _feeds(18)
    ref = _run("torch", weights, str(tmp_path / "ref"), feeds, n_hosts=3,
               elastic=True, rejoin=False)
    kinds = ("sdc_suspect", "elastic_drain", "elastic_shrink")
    got = {name: _run(name, weights, str(tmp_path), feeds, n_hosts=3,
                      elastic=True, rejoin=False, drain_after=1,
                      sdc_detect={"consecutive": 2, "threshold": 6.0},
                      failpoint="executor.step:flip=x@5+^1", kinds=kinds)
           for name in PKGS}
    # the step a suspect is flagged at differs: the port's flip takes
    # the element's own width, the JAX package's another bit
    assert _no_step(got["torch"][2]) == _no_step(got["jax"][2])
    assert {e[2] for e in got["torch"][2]
            if e[0] != "sdc_suspect"} == {"2/3"}
    assert {e["host_suspect"] for e in tres.events("sdc_suspect")} \
        == {"1"}
    assert "suspected SDC" in got["torch"][3].coordinator.lost_hosts()[1]
    for h in (0, 2):
        np.testing.assert_array_equal(got["torch"][1][h], ref[1][h])
        np.testing.assert_allclose(got["torch"][1][h], got["jax"][1][h],
                                   rtol=RTOL)


def test_configurations_refused_alike(tmp_path, weights):
    for name, (pkg, coord, res, _) in PKGS.items():
        pod, trainers = _pod(name, weights, str(tmp_path / name),
                             n_hosts=2, elastic=True)
        with pytest.raises(ValueError, match="replicated feed shape"):
            pod.run([_feeds(2), _feeds(2)])
        with pytest.raises(ValueError, match="sdc_detect"):
            coord.ElasticTrainer([trainers[0]], coord.LocalCoordinator(1),
                                 host_id=0, sync_dir=str(tmp_path),
                                 sdc_detect="yes")
        with pytest.raises(ValueError, match="sync_dir"):
            coord.ElasticTrainer([trainers[0]], coord.LocalCoordinator(2),
                                 host_id=0)
        with pytest.raises(ValueError, match="drain_after"):
            coord.ElasticTrainer(trainers, coord.LocalCoordinator(2),
                                 drain_after=0)
        with pytest.raises(ValueError, match="out of range"):
            coord.PodResilientTrainer([trainers[0]],
                                      coord.LocalCoordinator(2), host_id=5)
        assert res.ElasticTrainer is coord.ElasticTrainer


def test_pipeline_recut_and_sharded_feeds_are_not_ported(tmp_path,
                                                         weights):
    pod, trainers = _pod("torch", weights, str(tmp_path), n_hosts=2,
                         elastic=True)
    with pytest.raises(NotPortedError, match="ShardedFeed"):
        pod.run(None, steps=2)
    main, _, _ = _program(ptt)
    bs = ptt.BuildStrategy()
    bs.mesh_axes = {"pp": 2}
    for t in trainers:
        t._target = ptt.CompiledProgram(main, bs)
    with pytest.raises(NotPortedError, match="re-cut"):
        pod.run(_feeds(2))


@pytest.mark.parametrize("option,slice_", [
    ("drain_stream_lag", "ShardedFeed")])
def test_lag_drains_are_not_ported(tmp_path, weights, option, slice_):
    """The stream-lag drain reads per-host ShardedFeed cursors, which do
    not exist on one card, so asking for it is refused, not silently
    ignored."""
    _, trainers = _pod("torch", weights, str(tmp_path), n_hosts=2,
                       elastic=True)
    with pytest.raises(NotPortedError, match=slice_):
        tcoord.ElasticTrainer(trainers, tcoord.LocalCoordinator(2),
                              drain_after=1, **{option: 1.0})


def test_host_id_mode_on_file_coordinators(tmp_path, weights):
    """One PodResilientTrainer a simulated process, each holding its own
    trainer and host_id, meeting on FileCoordinators: a preemption
    rewinds both hosts, bit-equal to the fault-free run."""
    import threading
    feeds = _feeds(6)

    def run_pod(tag, spec=None):
        main, startup, loss = _program(ptt)
        root = str(tmp_path / tag)
        pods, scopes = [], []
        for h in range(2):
            sc, exe = _host(ptt, weights, main, startup)
            tr = tres.ResilientTrainer(
                exe, main, os.path.join(root, "h%d" % h), fetch_list=[loss],
                checkpoint_every=3, scope=sc,
                retry_policy=tres.RetryPolicy(base_delay_s=0.0, jitter=0.0,
                                              sleep=lambda s: None))
            co = tcoord.FileCoordinator(os.path.join(root, "coord"), 2,
                                        timeout_s=POD_TIMEOUT_S,
                                        poll_s=0.002, mesh_reinit=False)
            pods.append(tcoord.PodResilientTrainer([tr], co, host_id=h))
            scopes.append(sc)
        out = {}
        ctx = tres.inject(spec) if spec else contextlib.nullcontext()
        with ctx:
            ts = [threading.Thread(target=lambda h=h: out.__setitem__(
                h, pods[h].run(feeds))) for h in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        return _fetches([out[0], out[1]]), [
            sc.find_var("pod_w").numpy() for sc in scopes]
    ref, chaos = run_pod("ref"), run_pod("chaos", "step:preempt@5")
    assert ref[0] == chaos[0]
    for a, b in zip(ref[1], chaos[1]):
        np.testing.assert_array_equal(a, b)
    assert tres.events("pod_restore")


def test_executor_steps_one_at_a_time_and_counts_its_own_launches(
        monkeypatch, weights):
    """The step lock the pod's threads share one card under: 16 threads
    (more than cores) each stepping its own Executor, with a racy
    read-modify-write of a launch counter inside every step and a tiny
    switch interval. No step overlaps another, no count is lost, and a
    caller holding the step lock around its own steps reads exactly
    their launches from the global counters."""
    import sys
    import threading
    import time as time_mod
    from paddle_tpu_torch.framework import executor as ex
    from paddle_tpu_torch.ops.kernels import layer_norm
    inside, seen, own = [0], [], [0] * 16
    real_step = ex.Executor._step

    def racy_step(self, *a, **k):
        inside[0] += 1
        seen.append(inside[0])
        n = layer_norm.launches
        time_mod.sleep(0)
        layer_norm.launches = n + 1
        try:
            return real_step(self, *a, **k)
        finally:
            inside[0] -= 1
    monkeypatch.setattr(ex.Executor, "_step", racy_step)
    main, startup, loss = _program(ptt)
    feed = _feeds(1)[0]
    start = layer_norm.launches
    exes = [_host(ptt, weights, main, startup) for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def steps(i):
            sc, exe = exes[i]
            for _ in range(5):
                with ex._STEP_LOCK:
                    before = layer_norm.launches
                    exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
                    own[i] += layer_norm.launches - before
        ts = [threading.Thread(target=steps, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        launched = layer_norm.launches - start
        # every host took the same five steps: the same sixth loss
        outs = {float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=sc)[0])[0])
                for sc, exe in exes}
    finally:
        sys.setswitchinterval(old)
        layer_norm.launches = start
    assert max(seen) == 1 and len(seen) == 96
    assert launched == 80 and len(outs) == 1
    assert own == [5] * 16
