"""The buddy-checkpoint tier and the state-blob codec of paddle_tpu_torch
held to the JAX package's (framework/buddy.py, io.encode_state_blob).

Each scenario runs through both packages on the same seeded numpy state
and must reach the same verdicts: ring assignments, mailbox acks and
typed refusals, restore plans, the agreed verdicts and adopted values.
Blobs encoded by either package decode in the other to the same arrays,
and equal f32 state has equal leaf and state digests. Tolerance: exact
(the zlib codec is lossless; q8 is held to the JAX package's own decode
of the same blob, bit for bit).
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jax_io
from paddle_tpu.framework import buddy as jax_buddy
from paddle_tpu.framework import coordination as jax_coord
from paddle_tpu.framework import faultinject as jax_fi
from paddle_tpu.framework import resilience as jax_res
import paddle_tpu_torch.io as pt_io
from paddle_tpu_torch.framework import buddy as pt_buddy
from paddle_tpu_torch.framework import coordination as pt_coord
from paddle_tpu_torch.framework import faultinject as pt_fi
from paddle_tpu_torch.framework import resilience as pt_res
from paddle_tpu_torch.framework.scope import Scope

PKGS = {"jax": (jax_buddy, jax_io, jax_coord, jax_res, jax_fi),
        "torch": (pt_buddy, pt_io, pt_coord, pt_res, pt_fi)}


@pytest.fixture(autouse=True)
def _clean():
    for *_, res, fi in PKGS.values():
        res.install(None)
        res.clear_events()
        fi.disarm()
    yield
    for *_, res, fi in PKGS.values():
        res.install(None)
        res.clear_events()
        fi.disarm()


def _arrays(seed=0, names=("w", "nested/b")):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(3, 4).astype(np.float32) for n in names}


def _run_hosts(fn, n):
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


def _both(scenario):
    got = {name: scenario(*mods) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_ring_buddies():
    for b in (jax_buddy, pt_buddy):
        assert b.ring_buddies([2, 0, 2, 1]) == {0: 1, 1: 2, 2: 0}
        assert b.ring_buddies([1, 5, 9]) == {1: 5, 5: 9, 9: 1}
        assert b.ring_buddies([4]) == {} and b.ring_buddies([]) == {}
        assert b.buddy_of(5, [1, 5, 9]) == 9
        assert b.buddy_of(6, [1, 5, 9]) is None
        assert b.ring_buddies([0, 2, 3]) == {0: 2, 2: 3, 3: 0}


@pytest.mark.parametrize("compress", [None, "zlib", "q8"])
def test_state_blobs_cross_decode(compress):
    arrays = _arrays(seed=3, names=("w", "nested/b", "big"))
    arrays["big"] = np.random.RandomState(1).randn(40, 30).astype(
        np.float32)
    arrays["i"] = np.arange(7, dtype=np.int64)
    arrays["s"] = np.asarray(5)
    fs = {"cursor": [1, 2]}
    blobs = {name: io.encode_state_blob(arrays, 9, compress=compress,
                                        feed_state=fs)
             for name, (_, io, *_) in PKGS.items()}
    # raw bytes are the state's; the npz differs only in its container
    assert blobs["jax"][1] == blobs["torch"][1] == sum(
        a.nbytes for a in arrays.values())
    want, _, _ = jax_io.decode_state_blob(blobs["jax"][0])
    for blob, _, _ in blobs.values():
        for dec in (jax_io.decode_state_blob, pt_io.decode_state_blob):
            got, step, feed_state = dec(blob)
            assert step == 9 and feed_state == fs
            assert sorted(got) == sorted(arrays)
            for n in arrays:
                assert got[n].dtype == want[n].dtype
                np.testing.assert_array_equal(got[n], want[n])
                if compress != "q8":
                    np.testing.assert_array_equal(got[n], arrays[n])


def test_digests_equal_across_packages_and_torch_values():
    arrays = _arrays(seed=4)
    arrays["c"] = np.arange(5, dtype=np.int64)
    arrays["s"] = np.asarray(2.5, np.float32)
    assert pt_io.leaf_digests(arrays) == jax_io.leaf_digests(arrays)
    assert pt_io.state_digest(arrays) == jax_io.state_digest(arrays)
    assert pt_io.leaf_digest(arrays["w"]) == jax_io.leaf_digest(
        arrays["w"])
    tensors = {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}
    assert pt_io.state_digest(tensors) == jax_io.state_digest(arrays)
    flipped = dict(arrays, w=arrays["w"].copy())
    flipped["w"].view(np.int32)[0, 0] ^= 1
    assert pt_io.state_digest(flipped) != pt_io.state_digest(arrays)
    # bfloat16 travels as its uint16 bits
    bf = torch.randn(4, 3).to(torch.bfloat16)
    blob, raw, _ = pt_io.encode_state_blob({"b": bf}, 0)
    got = pt_io.decode_state_blob(blob)[0]["b"]
    assert raw == 24 and got.dtype == np.uint16
    assert torch.equal(torch.from_numpy(got.view(np.int16)).view(
        torch.bfloat16), bf)


def _full_payload(io, arrays, gen, reset=False):
    blob, _, _ = io.encode_state_blob(arrays, gen, compress="zlib")
    p = {"kind": "full", "gen": gen, "digest": io.state_digest(arrays),
         "blob": blob}
    if reset:
        p["reset"] = True
    return p


def _delta_payload(io, changed, gen, prev_gen, prev_digest, full_arrays):
    blob, _, _ = io.encode_state_blob(changed, gen, compress="zlib")
    return {"kind": "delta", "gen": gen, "prev_gen": prev_gen,
            "prev_digest": prev_digest,
            "digest": io.state_digest(full_arrays), "removed": [],
            "blob": blob}


def test_mailbox_generation_fence_reset_and_delta_refusals():
    def scenario(buddy, io, coord, res, fi):
        mb = buddy.BuddyMailbox(host_id=1, max_chain=2)
        base = _arrays(seed=0)
        verdicts = [mb.deposit(4, _delta_payload(
            io, {"w": base["w"]}, 1, 0, "x", base))["refused"]]
        ack = mb.deposit(4, _full_payload(io, base, 1))
        verdicts.append((ack["ok"], ack["gen"], ack["chain_len"]))
        d1 = dict(base, w=base["w"] + 1)
        for prev_gen, prev_digest, gen in ((0, ack["digest"], 2),
                                           (1, "not-the-digest", 2),
                                           (1, ack["digest"], 1)):
            verdicts.append(mb.deposit(4, _delta_payload(
                io, {"w": d1["w"]}, gen, prev_gen, prev_digest, d1)))
        ack1 = mb.deposit(4, _delta_payload(io, {"w": d1["w"]}, 2, 1,
                                            ack["digest"], d1))
        d2 = dict(d1, w=d1["w"] + 1)
        ack2 = mb.deposit(4, _delta_payload(io, {"w": d2["w"]}, 3, 2,
                                            ack1["digest"], d2))
        d3 = dict(d2, w=d2["w"] + 1)
        capped = mb.deposit(4, _delta_payload(io, {"w": d3["w"]}, 4, 3,
                                              ack2["digest"], d3))
        rec = mb.reconstruct(4)
        got, step, _ = io.decode_state_blob(rec["blob"])
        rewind = mb.deposit(4, _full_payload(io, base, 2))
        reset = mb.deposit(4, _full_payload(io, base, 2, reset=True))
        resident = res.buddy_resident()["1"] == mb.resident_bytes()
        mb.drop(4)
        return (verdicts, (ack1["chain_len"], ack2["chain_len"]),
                capped["refused"], step, rec["digest"] == ack2["digest"],
                got["w"].tolist(), rewind, reset["gen"], resident,
                mb.meta(4), mb.resident_bytes())
    out = _both(scenario)
    assert out[0][0] == "delta_chain_broken" and out[0][1] == (True, 1, 0)
    assert out[0][2]["refused"] == "delta_chain_broken"
    assert out[0][3]["refused"] == "digest_mismatch"
    assert out[0][4]["refused"] == "gen_rewind"
    assert out[1] == (1, 2) and out[2] == "delta_chain_broken"
    assert out[3] == 3 and out[4] is True
    assert out[6] == {"ok": False, "refused": "gen_rewind", "gen": 3}
    assert out[7] == 2 and out[8] is True and out[9] is None
    assert out[10] == 0


def test_delta_sends_skip_unchanged_leaves_and_rebase():
    def scenario(buddy, io, coord, res, fi):
        co = coord.LocalCoordinator(2, timeout_s=5.0)
        tracker = buddy.DeltaTracker(rebase_every=2)
        rng = np.random.RandomState(0)
        scope = {"static/table": rng.randn(64, 32).astype(np.float32),
                 "churn/w": rng.randn(3, 4).astype(np.float32)}
        sent = [buddy.send_snapshot(co, 0, [0, 1], 0, scope,
                                    tracker=tracker)]
        chains, ratios = [tracker.chain_len], []
        for gen in (1, 2, 3):
            scope = dict(scope, **{"churn/w": rng.randn(3, 4).astype(
                np.float32)})
            sent.append(buddy.send_snapshot(co, 0, [0, 1], gen, scope,
                                            tracker=tracker))
            chains.append(tracker.chain_len)
            ratios.append(res.buddy_delta_ratio() < 0.5)
        got, _ = buddy.fetch_and_decode(co, 0, 3)
        same = all(np.array_equal(got[n], scope[n]) for n in scope)
        return (sent, chains, ratios, same, co.buddy_meta(0)["gen"],
                co.mailbox_of(1).meta(0)["chain_len"],
                res.buddy_gens(), sorted(res.bytes_totals()))
    sent, chains, ratios, same, gen, chain, gens, channels = \
        _both(scenario)
    assert sent == [True] * 4 and chains == [0, 1, 2, 0]
    assert ratios == [True, True, False] and same and gen == 3
    assert chain == 0 and gens == {0: 3} and channels == ["buddy_snapshot"]


def _seeded_co(coord, buddy, n, gen, members=None):
    co = coord.LocalCoordinator(n, timeout_s=30.0)
    members = list(range(n)) if members is None else members
    for h in members:
        assert buddy.send_snapshot(co, h, members, gen,
                                   _arrays(seed=100 + h))
    return co


def test_plan_restore_and_agree_plan_verdicts():
    def scenario(buddy, io, coord, res, fi):
        plans = []
        for live, lost, gen, members in (
                ([0, 1, 2, 3], [], 5, None), ([0, 2, 3], [1], 5, None),
                ([0, 3], [1, 2], 5, None), ([0, 2, 3], [1], 6, None),
                ([0, 1, 2, 3], [], 5, [0, 1, 2])):
            co = _seeded_co(coord, buddy, 4, 5, members)
            plans.append(buddy.plan_restore(co, live, lost, [0, 1, 2, 3],
                                            gen))
        co = _seeded_co(coord, buddy, 2, 1)
        agreed = _run_hosts(lambda h: buddy.agree_plan(
            co, h, "a", [0, 1], [], [0, 1], 1 if h == 0 else 2), 2)
        return plans, agreed
    plans, agreed = _both(scenario)
    assert plans == [None, None, "buddy_and_host_lost", "buddy_stale",
                     "buddy_missing"]
    assert agreed == ({0: "buddy_stale", 1: "buddy_stale"}, {})


def test_restore_agreed_adopts_bitwise_and_a_torn_snapshot_adopts_nothing():
    def scenario(buddy, io, coord, res, fi):
        port = buddy is pt_buddy

        def scope():
            sc = Scope() if port else jax_scope()
            for n in ("w", "nested/b"):
                sc.set_var(n, torch.full((3, 4), -1.0) if port
                           else np.full((3, 4), -1.0, np.float32))
            return sc
        co = _seeded_co(coord, buddy, 2, 4)
        scopes = {h: scope() for h in range(2)}
        ok = _run_hosts(lambda h: buddy.restore_agreed(
            co, h, "r", 4, scopes[h])[0], 2)
        adopted = {h: {n: _np(scopes[h].find_var(n)).tolist()
                       for n in ("w", "nested/b")} for h in range(2)}
        co = _seeded_co(coord, buddy, 2, 4)
        for at in (0, 1):
            mb = co.mailbox_of(at)
            with mb._lock:
                slot = mb._slots[1]
                slot["base"] = dict(slot["base"], npz="!not-base64!")
        scopes = {h: scope() for h in range(2)}
        torn = _run_hosts(lambda h: buddy.restore_agreed(
            co, h, "t", 4, scopes[h]), 2)
        untouched = all((_np(scopes[h].find_var("w")) == -1).all()
                        for h in range(2))
        return (ok, adopted, torn, untouched,
                sorted((e["kind"], e["host"]) for e in res.events()
                       if e["kind"] in ("buddy_adopt",
                                        "buddy_decode_fail")))
    ok, adopted, torn, untouched, evs = _both(scenario)
    assert ok == ({0: True, 1: True}, {})
    for h in range(2):
        want = _arrays(seed=100 + h)
        assert adopted[h] == {n: want[n].tolist() for n in want}
    assert torn == ({0: (False, None), 1: (False, None)}, {}) and untouched
    assert evs == [("buddy_adopt", 0), ("buddy_adopt", 1),
                   ("buddy_decode_fail", 1)]


def jax_scope():
    from paddle_tpu.framework.scope import Scope as JaxScope
    return JaxScope()


@pytest.mark.parametrize("site", ["buddy.send", "buddy.p2p_send",
                                  "buddy.p2p_fetch", "buddy.restore"])
def test_failpoints_keep_the_previous_generation(site):
    def scenario(buddy, io, coord, res, fi):
        co = _seeded_co(coord, buddy, 2, 1)
        send_ok = fetched = None
        with fi.failpoints(site + ":raise^0"):
            if site in ("buddy.send", "buddy.p2p_send"):
                send_ok = buddy.send_snapshot(co, 0, [0, 1], 2,
                                              _arrays(seed=7))
            else:
                if site == "buddy.p2p_fetch":
                    co.mailbox_of(0).drop(0)    # force the remote hop
                try:
                    buddy.fetch_and_decode(co, 0, 1)
                    fetched = True
                except Exception as e:
                    fetched = type(e).__name__
        return (send_ok, fetched, co.buddy_meta(0)["gen"],
                [e["kind"] for e in res.events()
                 if e["kind"].startswith("buddy_")])
    send_ok, fetched, gen, kinds = _both(scenario)
    assert gen == 1
    if site in ("buddy.send", "buddy.p2p_send"):
        assert send_ok is False and kinds == ["buddy_send_fail"]
    else:
        assert fetched in ("ConnectionError", "RuntimeError")


def test_adopt_arrays_binds_tensors_of_the_scope_values_dtype():
    sc = Scope()
    sc.set_var("w", torch.zeros(2, 3, dtype=torch.bfloat16))
    sc.set_var("f", torch.zeros(4))
    sc.set_var("@EAGER_SALT@", 3)
    old = sc.find_var("f")
    src = {"w": torch.randn(2, 3).to(torch.bfloat16),
           "f": torch.arange(4.0), "@EAGER_SALT@": 11}
    blob, _, _ = pt_io.encode_state_blob(src, 2)
    arrays, _, _ = pt_io.decode_state_blob(blob)
    pt_buddy.adopt_arrays(sc, arrays)
    assert torch.equal(sc.find_var("w"), src["w"])
    assert sc.find_var("w").dtype == torch.bfloat16
    assert torch.equal(sc.find_var("f"), src["f"])
    assert sc.find_var("f") is not old
    assert sc.find_var("@EAGER_SALT@") == 11
    with pytest.raises(Exception, match="torch.distributed"):
        pt_buddy.adopt_arrays(sc, arrays, shardings={"w": object()})
