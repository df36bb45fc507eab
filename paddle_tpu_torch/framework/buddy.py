"""Peer-to-peer buddy checkpointing: warm recovery without a memory
single point of failure (counterpart of paddle_tpu/framework/buddy.py,
whole).

* **Ring.** ``buddy(i)`` is the next live host after ``i`` on the sorted
  frozen membership (:func:`ring_buddies`), re-derived from the verdicts
  every host already agrees on.
* **Mailboxes.** At each committed window boundary host *i* deposits its
  encoded scope (``io.encode_state_blob``) into its own
  :class:`BuddyMailbox` and into its ring buddy's; a slot holds one
  reconstructible generation per owner and refuses a generation rewind.
  The coordinator keeps only the metadata row ``{gen, buddy, digest,
  nbytes}``, published after the buddy's mailbox acked
  (ack-before-commit), so a torn stream is never elected.
* **Deltas.** With a :class:`DeltaTracker` a send ships only the leaves
  whose digest changed since the last acked generation, re-based to a
  full send every ``rebase_every`` sends; a receiver that cannot extend
  its chain refuses typed (``delta_chain_broken`` / ``digest_mismatch``)
  and the sender falls back to a full send. Deltas need a bitwise codec
  (zlib or None); q8 sends are full and unverified.
* **Restore.** Every live host plans from metadata only, one gather
  agrees the verdict (any doubt falls the pod back to the disk rewind
  under a typed reason: ``buddy_missing``, ``buddy_stale``,
  ``buddy_and_host_lost``), each host fetches and decodes its snapshot
  without touching its scope and verifies its digest, a second gather
  confirms every decode, and only then does anyone adopt
  (``snapshot_torn`` otherwise). A zlib buddy restore loses at most one
  window and equals the uninterrupted run bit for bit.

The mailboxes live where the coordinator keeps them: in the
coordinator object's in-process registry for
:class:`~.coordination.LocalCoordinator` (its threads share it), or in
each host's own :class:`~.transport.MailboxServer` endpoint for
:class:`~.coordination.SocketCoordinator`, whose newline-JSON wire
carries blobs as base64 text (``co.blob_text``). A host copy goes
through ``io._host_array`` (a CUDA tensor copied
to the host; bfloat16 as its uint16 bits), and :func:`adopt_arrays`
binds new tensors on the trainer's device, which the next replay copies
into its static inputs, as a checkpoint restore does.
"""

import threading
import time

from ..ops.registry import NotPortedError
from . import faultinject, obs, resilience
from .resilience import record_event

__all__ = ["ring_buddies", "buddy_of", "send_snapshot", "plan_restore",
           "agree_plan", "restore_agreed", "fetch_and_decode",
           "adopt_arrays", "FALLBACK_REASONS", "DELTA_REFUSALS",
           "BuddyMailbox", "DeltaTracker"]

# typed disk-fallback reasons, in conservative-merge precedence order:
# when hosts disagree (e.g. a racing eviction made one host see a miss
# where another saw the double loss), the pod adopts the FIRST reason
# by this ranking so every host records the same label
FALLBACK_REASONS = ("buddy_and_host_lost", "buddy_missing",
                    "buddy_stale", "snapshot_torn")

# typed mailbox-deposit refusals that force the sender's NEXT attempt
# to a full snapshot (the receiver's chain state cannot extend)
DELTA_REFUSALS = ("delta_chain_broken", "digest_mismatch")

# compress modes whose decode is bitwise (deltas and digest
# verification are only sound over a lossless codec; q8 is lossy)
_BITWISE_COMPRESS = (None, "zlib")


# -- ring assignment --------------------------------------------------------
def ring_buddies(members):
    """``{host: buddy}`` over the sorted membership ring —
    ``buddy(i) = (i+1) % n`` in ring position, so every host has
    exactly one buddy and is exactly one host's buddy. Empty for
    fewer than two members (a ring of one would buddy a host to
    itself, which replicates nothing)."""
    ring = sorted({int(m) for m in members})
    if len(ring) < 2:
        return {}
    return {h: ring[(i + 1) % len(ring)] for i, h in enumerate(ring)}


def buddy_of(host, members):
    """``host``'s buddy under ``members``' ring, or None."""
    return ring_buddies(members).get(int(host))


# -- mailbox (one per host; payloads live HERE, not on the coordinator) -----
def _payload_wire_bytes(payload):
    """Resident size of one deposited payload: its npz (bytes, or base64
    text) is the dominant term (the envelope is noise)."""
    blob = payload.get("blob") or {}
    return len(blob.get("npz", ""))


class BuddyMailbox(object):
    """One host's in-RAM buddy mailbox: ``{owner: slot}`` where a slot
    is the owner's last FULL snapshot plus a bounded chain of delta
    payloads that reconstruct exactly ONE generation. Thread-safe (the
    socket endpoint serves deposits and fetches concurrently).

    Deposit semantics mirror the coordinator's legacy blob fence:
    generation rewinds are refused (``reset=True`` on a full deposit
    bypasses, for post-restore re-seeds), an equal-generation full
    deposit replaces (idempotent resend / forced-full correction), and
    a delta must name the exact ``(prev_gen, prev_digest)`` the slot
    currently reconstructs to — anything else is a typed refusal, not
    an exception."""

    def __init__(self, host_id=None, max_chain=64):
        self._host = None if host_id is None else int(host_id)
        self._max_chain = max(1, int(max_chain))
        self._slots = {}
        self._lock = threading.RLock()

    @property
    def host_id(self):
        return self._host

    def _record_resident_locked(self):
        if self._host is not None:
            resilience.record_buddy_resident(
                self._host, self._resident_bytes_locked())

    def _resident_bytes_locked(self):
        return sum(s["nbytes"] for s in self._slots.values())

    def resident_bytes(self):
        """Total payload bytes resident across all slots."""
        with self._lock:
            return self._resident_bytes_locked()

    def owners(self):
        with self._lock:
            return sorted(self._slots)

    def meta(self, owner=None):
        """Metadata view (no payloads): one owner's ``{gen, digest,
        nbytes, chain_len}`` (or None), or all owners' when ``owner``
        is None."""
        with self._lock:
            if owner is not None:
                s = self._slots.get(int(owner))
                return None if s is None else self._meta_of(s)
            return {o: self._meta_of(s) for o, s in self._slots.items()}

    @staticmethod
    def _meta_of(s):
        return {"gen": s["gen"], "digest": s["digest"],
                "nbytes": s["nbytes"], "chain_len": len(s["chain"])}

    def drop(self, owner):
        """Evict one owner's slot (membership shrink / double loss)."""
        with self._lock:
            self._slots.pop(int(owner), None)
            self._record_resident_locked()

    def clear(self):
        with self._lock:
            self._slots.clear()
            self._record_resident_locked()

    def deposit(self, owner, payload):
        """Apply one deposited payload; returns an ack dict —
        ``{"ok": True, "gen", "digest", "nbytes", "chain_len"}`` — or
        a typed refusal ``{"ok": False, "refused": reason}``. Protocol
        refusals never raise; only a malformed payload does."""
        owner = int(owner)
        kind = payload.get("kind")
        if kind not in ("full", "delta"):
            raise ValueError("mailbox deposit kind must be full|delta, "
                             "got %r" % (kind,))
        gen = int(payload["gen"])
        nb = _payload_wire_bytes(payload)
        with self._lock:
            slot = self._slots.get(owner)
            if kind == "full":
                if slot is not None and gen < slot["gen"] \
                        and not payload.get("reset"):
                    return {"ok": False, "refused": "gen_rewind",
                            "gen": slot["gen"]}
                self._slots[owner] = {
                    "gen": gen, "digest": payload.get("digest"),
                    "base": payload["blob"], "chain": [], "nbytes": nb}
            else:
                if slot is None \
                        or int(payload["prev_gen"]) != slot["gen"] \
                        or len(slot["chain"]) >= self._max_chain:
                    return {"ok": False, "refused": "delta_chain_broken",
                            "gen": None if slot is None else slot["gen"]}
                if payload.get("prev_digest") != slot["digest"]:
                    return {"ok": False, "refused": "digest_mismatch",
                            "gen": slot["gen"]}
                if gen <= slot["gen"]:
                    return {"ok": False, "refused": "gen_rewind",
                            "gen": slot["gen"]}
                slot["chain"].append(
                    {"gen": gen, "digest": payload.get("digest"),
                     "blob": payload["blob"],
                     "removed": list(payload.get("removed") or ())})
                slot["gen"] = gen
                slot["digest"] = payload.get("digest")
                slot["nbytes"] += nb
            s = self._slots[owner]
            self._record_resident_locked()
            ack = {"ok": True}
            ack.update(self._meta_of(s))
            return ack

    def reconstruct(self, owner):
        """Reconstruct ``owner``'s single resident generation to one
        full wire record ``{gen, digest, blob}``. The chainless common
        case returns the deposited full blob untouched; a chained slot
        decodes the base, applies each delta link (the catalogued
        ``buddy.delta_apply`` failpoint fires per link), verifies the
        reconstructed state digest against the slot's, and re-encodes.
        Raises LookupError on a missing slot and ValueError on any
        chain/digest corruption — the fetching side treats every raise
        as ``snapshot_torn``."""
        from .. import io as io_mod
        with self._lock:
            slot = self._slots.get(int(owner))
            if slot is None:
                raise LookupError(
                    "no mailbox slot for owner %s" % (owner,))
            gen, digest = slot["gen"], slot["digest"]
            base, chain = slot["base"], list(slot["chain"])
        if not chain:
            return {"gen": gen, "digest": digest, "blob": base}
        arrays, step, _ = io_mod.decode_state_blob(base)
        compress = base.get("compress")
        for link in chain:
            faultinject.hit("buddy.delta_apply",
                            {"owner": int(owner), "gen": link["gen"]},
                            host=self._host)
            darr, dstep, _ = io_mod.decode_state_blob(link["blob"])
            if int(dstep) != int(link["gen"]):
                raise ValueError(
                    "delta link for owner %s carries step %d inside a "
                    "gen-%d link" % (owner, int(dstep), int(link["gen"])))
            for name in link["removed"]:
                arrays.pop(name, None)
            arrays.update(darr)
            step = dstep
        if digest is not None \
                and io_mod.state_digest(arrays) != digest:
            raise ValueError(
                "mailbox chain for owner %s reconstructs to a state "
                "that fails digest verification at gen %d"
                % (owner, gen))
        blob, _, _ = io_mod.encode_state_blob(
            arrays, gen, compress=compress,
            text=isinstance(base.get("npz"), str))
        return {"gen": gen, "digest": digest, "blob": blob}


# -- sender-side delta state ------------------------------------------------
class DeltaTracker(object):
    """Per-host sender state for delta snapshots: the last ACKED
    generation/digest, per-leaf content digests (the skip test), the
    chain length since the last full send (re-based to a forced full
    every ``rebase_every`` sends) and the last full send's wire bytes
    (the ``buddy_delta_ratio`` denominator). Reset forces the next
    send full — the safe answer whenever the receiver's chain state is
    unknown (after a failed send, a restore, or a re-seed)."""

    def __init__(self, rebase_every=8):
        self.rebase_every = max(1, int(rebase_every))
        self.reset()

    def reset(self):
        self.gen = None
        self.digest = None
        self.leaves = {}
        self.chain_len = 0
        self.full_wire = None


# -- window-boundary send ---------------------------------------------------
def _encode_payload(io_mod, arrays, gen, compress, tracker, reset,
                    force_full, text=False):
    """Encode one boundary send as a full or delta payload. Returns
    ``(payload, raw_bytes, wire_bytes, leaf_digests, kind)`` — raw is
    always the FULL scope's bytes (what the uncompressed path would
    have moved), so the bytes accounting shows what deltas saved."""
    bitwise = compress in _BITWISE_COMPRESS
    digests = io_mod.leaf_digests(arrays) if bitwise else None
    digest = io_mod.digest_of_leaves(digests) if bitwise else None
    raw_full = sum(int(a.nbytes) for a in arrays.values())
    if bitwise and not reset and not force_full and tracker is not None \
            and tracker.gen is not None \
            and tracker.chain_len < tracker.rebase_every:
        changed = {n: a for n, a in arrays.items()
                   if digests[n] != tracker.leaves.get(n)}
        removed = sorted(set(tracker.leaves) - set(arrays))
    else:
        changed, removed = arrays, ()
    # a delta of every leaf saves nothing and costs the receiver a chain
    # to replay: send it full (AdamW's steps change every leaf)
    if len(changed) < len(arrays) or removed:
        blob, _, wire = io_mod.encode_state_blob(
            changed, gen, compress=compress, text=text)
        return ({"kind": "delta", "gen": gen,
                 "prev_gen": tracker.gen,
                 "prev_digest": tracker.digest,
                 "digest": digest, "removed": removed, "blob": blob},
                raw_full, wire, digests, "delta")
    blob, _, wire = io_mod.encode_state_blob(
        arrays, gen, compress=compress, text=text)
    payload = {"kind": "full", "gen": gen, "digest": digest,
               "blob": blob}
    if reset:
        payload["reset"] = True
    return payload, raw_full, wire, digests, "full"


def _deposit_dual(co, hid, bud, payload):
    """Deposit one payload into the owner's OWN mailbox first (the
    free local replica) and then stream it to the ring buddy's (the
    one that survives the owner's death). Returns ``(buddy_ack,
    refused_reason)`` — exactly one is non-None. The catalogued
    ``buddy.p2p_send`` failpoint fires between the two, modelling a
    stream torn on the wire after the local deposit landed."""
    self_ack = co.mailbox_send(hid, hid, payload)
    if not self_ack.get("ok"):
        return None, self_ack.get("refused", "refused")
    faultinject.hit("buddy.p2p_send",
                    {"gen": payload["gen"], "buddy": bud}, host=hid)
    ack = co.mailbox_send(hid, bud, payload)
    if not ack.get("ok"):
        return None, ack.get("refused", "refused")
    return ack, None


def send_snapshot(co, host_id, members, gen, scope, compress="zlib",
                  reset=False, p2p=True, tracker=None):
    """Encode this host's scope and replicate it under
    generation ``gen`` — p2p (default): deposit into the own + ring
    buddy mailboxes, then publish the metadata row to the coordinator
    ONLY after the buddy acked (ack-before-commit); legacy
    (``p2p=False``): ``put_blob`` the payload onto the coordination
    plane as before.

    With a :class:`DeltaTracker` the p2p payload is a per-leaf delta
    when possible; a typed receiver refusal falls back to ONE forced
    full in the same call. A send failure NEVER fails training: any
    exception (including the catalogued ``buddy.send``/
    ``buddy.p2p_send`` failpoints and a coordinator outage) is
    swallowed into a ``buddy_send_fail`` event, the metadata row keeps
    the PREVIOUS generation (still restorable) and the tracker resets
    so the next attempt is full. Returns True when the snapshot
    committed. Skipped (False) for rings of fewer than two members —
    there is no peer RAM to replicate into."""
    from .. import io as io_mod
    hid, gen = int(host_id), int(gen)
    buds = ring_buddies(members)
    if hid not in buds:
        return False
    try:
        with obs.span("buddy.send", host=hid, gen=gen,
                      buddy=buds[hid]):
            arrays = {}
            for name, val in sorted(scope.items()):
                if val is None:
                    continue
                arrays[name] = io_mod._host_array(val)[0]
            # the failpoint fires BEFORE any deposit: a fault mid-send
            # must leave the previous generation committed
            faultinject.hit("buddy.send", {"gen": gen}, host=hid)
            # a JSON wire (SocketCoordinator) takes the blob as text
            text = bool(getattr(co, "blob_text", False))
            if not p2p:
                blob, raw, wire = io_mod.encode_state_blob(
                    arrays, gen, compress=compress, text=text)
                co.put_blob(hid, gen, buds[hid], blob, reset=reset)
                kind, digests, ack = "full", None, None
            else:
                payload, raw, wire, digests, kind = _encode_payload(
                    io_mod, arrays, gen, compress, tracker, reset,
                    force_full=False, text=text)
                ack, refused = _deposit_dual(co, hid, buds[hid],
                                             payload)
                if ack is None and kind == "delta" \
                        and refused in DELTA_REFUSALS:
                    # the receiver cannot extend its chain — typed
                    # fallback to ONE forced full, same boundary
                    record_event("buddy_delta_refused", host=hid,
                                 gen=gen, reason=refused)
                    payload, raw, wire, digests, kind = \
                        _encode_payload(io_mod, arrays, gen, compress,
                                        tracker, reset, force_full=True,
                                        text=text)
                    ack, refused = _deposit_dual(co, hid, buds[hid],
                                                 payload)
                if ack is None:
                    raise ConnectionError(
                        "buddy mailbox refused deposit: %s" % refused)
                # ack-before-commit: the metadata row moves only now
                co.put_buddy_meta(hid, gen, buds[hid],
                                  payload.get("digest"),
                                  int(ack.get("nbytes", wire)),
                                  reset=reset)
        resilience.record_bytes("buddy_snapshot", raw, wire)
        resilience.record_buddy_gen(hid, gen)
        if p2p and tracker is not None:
            tracker.gen = gen
            tracker.digest = payload.get("digest")
            tracker.leaves = digests or {}
            if kind == "full":
                tracker.chain_len, tracker.full_wire = 0, wire
            else:
                tracker.chain_len += 1
            if tracker.full_wire:
                resilience.record_buddy_delta_ratio(
                    round(float(wire) / float(tracker.full_wire), 6))
        return True
    except Exception as e:
        record_event("buddy_send_fail", host=hid, gen=gen,
                     error=type(e).__name__)
        if tracker is not None:
            tracker.reset()
        return False


# -- restore: verdict, agreement, adoption ----------------------------------
def plan_restore(co, live, lost, prev_members, expected_gen, p2p=True):
    """This host's LOCAL buddy-restore verdict from coordinator
    metadata only (no payload moves): None when a buddy restore at
    ``expected_gen`` looks possible, else the typed fallback reason.

    ``prev_members`` is the membership the last sends were ringed
    over (live + the hosts lost THIS round): a lost owner whose buddy
    under that ring is also gone means the replica's RAM died with it
    (``buddy_and_host_lost``) — in p2p mode the metadata row's
    RECORDED buddy is checked too, in case the last committed send
    pre-dated a membership change. Every owner — live and lost — must
    hold exactly ``expected_gen``: an absent row is ``buddy_missing``,
    any other generation ``buddy_stale``."""
    lost = sorted({int(h) for h in lost})
    owners = sorted({int(h) for h in live} | set(lost))
    buds = ring_buddies(prev_members)
    for o in lost:
        b = buds.get(o)
        if b is None or b in lost:
            return "buddy_and_host_lost"
    for o in owners:
        try:
            meta = co.buddy_meta(o) if p2p \
                else co.get_blob(o, meta_only=True)
        except Exception:
            meta = None
        if meta is None:
            return "buddy_missing"
        if int(meta["gen"]) != int(expected_gen):
            return "buddy_stale"
        if p2p and o in lost and int(meta.get("buddy", -1)) in lost:
            return "buddy_and_host_lost"
    return None


def agree_plan(co, hid, name, live, lost, prev_members, expected_gen,
               p2p=True):
    """Pod-wide buddy-restore election (gather #1): every live host
    publishes its local :func:`plan_restore` verdict and the frozen
    gather merges them CONSERVATIVELY — any host's doubt falls the
    whole pod back, under the first reason by
    :data:`FALLBACK_REASONS` precedence so every host records the
    same label. Returns None (agreed: restore at ``expected_gen``)
    or the agreed reason."""
    local = plan_restore(co, live, lost, prev_members, expected_gen,
                         p2p=p2p)
    verd = co.all_gather(name + "v", hid,
                         "ok" if local is None else local)
    reasons = [r for r in verd.values() if r != "ok"]
    if not reasons:
        return None
    rank = {r: i for i, r in enumerate(FALLBACK_REASONS)}
    return min(reasons, key=lambda r: (rank.get(r, len(rank)), r))


def fetch_and_decode(co, host_id, gen, p2p=True):
    """Pull THIS host's snapshot payload and decode it to host arrays
    WITHOUT touching the scope. P2p pulls local-mailbox-first, then
    host-to-host from the metadata row's recorded buddy (the
    catalogued ``buddy.p2p_fetch`` failpoint fires before the remote
    hop; its latency lands in the ``buddy_p2p_fetch_ms`` gauge), and
    verifies the decoded state's digest against the coordinator row.
    Raises on any tear: a moved generation, a decode or digest failure
    — the caller treats every raise as ``snapshot_torn``. The
    catalogued ``buddy.restore`` failpoint fires between fetch and
    decode. Returns ``(arrays, feed_state)``, the JAX package's shape;
    the port sends no feed cursor, so ``feed_state`` is None for its own
    snapshots."""
    from .. import io as io_mod
    hid, gen = int(host_id), int(gen)
    meta = None
    if p2p:
        meta = co.buddy_meta(hid)
        if meta is None:
            raise LookupError("no buddy metadata for host %d" % hid)
        if int(meta["gen"]) != gen:
            raise LookupError(
                "buddy metadata for host %d moved to gen %d while "
                "restoring gen %d" % (hid, int(meta["gen"]), gen))
        try:
            rec = co.mailbox_fetch(hid, hid)
        except Exception:
            rec = None
        if rec is None or int(rec["gen"]) != gen:
            # local replica gone (host restarted) or already advanced
            # past the agreed generation — pull host-to-host from the
            # buddy's mailbox
            faultinject.hit("buddy.p2p_fetch",
                            {"gen": gen, "buddy": meta["buddy"]},
                            host=hid)
            t0 = time.perf_counter()
            rec = co.mailbox_fetch(hid, int(meta["buddy"]))
            resilience.record_buddy_fetch_ms(
                round((time.perf_counter() - t0) * 1e3, 3))
        if rec is None:
            raise LookupError(
                "no buddy mailbox payload for host %d" % hid)
        if int(rec["gen"]) != gen:
            raise LookupError(
                "buddy mailbox for host %d holds gen %d while "
                "restoring gen %d" % (hid, int(rec["gen"]), gen))
    else:
        rec = co.get_blob(hid)
        if rec is None:
            raise LookupError("no buddy snapshot for host %d" % hid)
        if int(rec["gen"]) != gen:
            raise LookupError(
                "buddy snapshot for host %d moved to gen %d while "
                "restoring gen %d" % (hid, int(rec["gen"]), gen))
    faultinject.hit("buddy.restore", {"gen": gen}, host=hid)
    arrays, got, feed_state = io_mod.decode_state_blob(rec["blob"])
    if int(got) != gen:
        raise ValueError(
            "buddy snapshot for host %d carries step %d inside a "
            "gen-%d mailbox" % (hid, int(got), gen))
    if p2p and meta.get("digest") is not None \
            and io_mod.state_digest(arrays) != meta["digest"]:
        raise ValueError(
            "buddy snapshot for host %d fails digest verification "
            "at gen %d" % (hid, gen))
    return arrays, feed_state


def adopt_arrays(scope, arrays, shardings=None, device=None):
    """Install decoded host arrays into the scope, each as a new tensor on
    the device (and in the dtype) of the value it replaces, or on
    ``device``; a bfloat16 value from its uint16 bits, the run counter
    as a Python int. ``shardings``: a size-1 mesh has nothing to
    re-shard, so only None or an empty map is accepted. Called only after
    the pod agreed that every host's decode succeeded."""
    import torch
    from .. import io as io_mod
    from .executor import _SALT_VAR
    if shardings:
        raise NotPortedError(
            "adopt_arrays(shardings=) re-shards onto a device mesh; it "
            "arrives with the torch.distributed slice of paddle_tpu_torch")
    for name, host_arr in sorted(arrays.items()):
        cur = scope.find_var(name)
        if name == _SALT_VAR and not isinstance(cur, torch.Tensor):
            scope.set_var(name, int(host_arr))
            continue
        dtype = None
        if isinstance(cur, torch.Tensor):
            dtype = "bfloat16" if cur.dtype == torch.bfloat16 \
                else host_arr.dtype.name
            dev = cur.device
        else:
            dev = device if device is not None else torch.device("cpu")
        t = io_mod._decode(host_arr, dtype)
        if isinstance(cur, torch.Tensor) and t.dtype != cur.dtype:
            t = t.to(cur.dtype)
        scope.set_var(name, t.to(dev, copy=True))


def restore_agreed(co, hid, name, gen, scope, shardings=None, p2p=True,
                   device=None):
    """Stage 2, after :func:`agree_plan` said ok: fetch + decode this
    host's snapshot (scope untouched), agree every host's decode
    outcome on gather #2, and only then adopt. Returns
    ``(True, feed_state)`` on success, ``(False, None)`` when any
    host's decode tore — nobody adopted anything, the caller takes
    the disk rewind with ``snapshot_torn``."""
    t0 = time.perf_counter()
    ok, arrays, feed_state = True, None, None
    try:
        with obs.span("buddy.restore", host=int(hid), gen=int(gen)):
            arrays, feed_state = fetch_and_decode(co, hid, gen, p2p=p2p)
    except Exception as e:
        ok = False
        record_event("buddy_decode_fail", host=int(hid), gen=int(gen),
                     error=type(e).__name__)
    outs = co.all_gather(name + "d", hid, bool(ok))
    if not all(outs.values()):
        return False, None
    adopt_arrays(scope, arrays, shardings=shardings, device=device)
    record_event("buddy_adopt", host=int(hid), gen=int(gen),
                 latency_s=round(time.perf_counter() - t0, 6))
    return True, feed_state
