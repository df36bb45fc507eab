"""Socket-backed pod rendezvous — the network transport under
:class:`~.coordination.SocketCoordinator` (counterpart of
paddle_tpu/framework/transport.py, whole: the same ops, wire and
replication, so a client of either package talks to a server of the
other). Pure Python over the stdlib; it holds no tensors.

Reference parity: the reference pod coordinates over the network (the
pserver/brpc RPC tier — trainers and pservers share no filesystem, only
sockets). FileCoordinator ports the *protocol* but not the transport: it
assumes a shared directory, and it only learns a host died when someone
*declares* it. This module supplies the real thing with nothing but the
stdlib:

  * :class:`CoordServer` — one small TCP service holding the
    coordination KV state: gather rounds (with the STICKY completion
    semantics of Local/FileCoordinator: the first completion freezes the
    member snapshot for every participant), tombstones (fencing), join
    announcements, and per-host heartbeats. A background monitor
    tombstones any registered host whose heartbeat goes stale past
    ``hb_deadline_s`` — liveness becomes a property of the transport,
    not of someone calling ``mark_lost``. Runnable in-process for tests
    (``CoordServer(n).start()``) or standalone via
    ``python -m paddle_tpu_torch.tools.coordsvc``.
  * :class:`CoordClient` — a tiny request/response client. Transient
    socket errors are retried through the shared
    :class:`~.resilience.RetryPolicy` (reconnect, then re-send — every
    server op is idempotent, round contributions keyed by
    ``(name, host_id)`` plus a client token so a replay after a broken
    pipe never double-counts and an imposter never overwrites). A
    daemon heartbeat thread keeps this host live and feeds the
    observability gauges.

Replication (coordination-plane HA): the service itself is no longer a
single point of failure. A *replication group* is an ordered list of
endpoints — one PRIMARY plus N warm STANDBYS, wired by
``configure_replication(index, peers, standby=)`` (or ``coordsvc
--peers/--repl-index/--standby``). The group is TERM-numbered:

  * the primary streams every state-mutating op (hello, gather
    contributions, tombstones, unfence, join announcements, put_info,
    heartbeat leases) to each standby over the same newline-JSON wire
    discipline, bootstrapping a late/behind standby from a full state
    snapshot; round-freezing ops are replicated SYNCHRONOUSLY (bounded
    by ``repl_sync_timeout_s`` — a dead standby is dropped from the
    wait set, availability over lockstep) so a promoted standby never
    rewinds a contribution a client was told landed;
  * on primary loss — judged by the SAME ``hb_deadline_s`` staleness
    bound the monitor fences hosts by — the lowest-index live standby
    promotes with a bumped term and refreshes every liveness lease
    (failover grace: clients must not be fenced for the primary's
    death);
  * every response carries the term, so a stale ex-primary that wakes
    up is fenced by CLIENTS (a lower term than one already observed is
    refused and the client fails over), and by PEERS (its replication
    stream is rejected with the higher term and it demotes itself to
    standby).

:class:`CoordClient` (and therefore ``SocketCoordinator`` and the whole
serving fleet) accepts a LIST of endpoints — "h:p1,h:p2" or a list —
and fails over transparently inside its retry budget: round
re-submission is idempotent keyed by ``(name, host_id)`` + token, so a
contribution replayed against the promoted standby is a no-op.

Single-node durability: ``snapshot_path=`` (``coordsvc
--snapshot-path``) persists periodic state snapshots and reloads on
start, so a SUPERVISED RESTART resumes in-flight rounds instead of
aborting them (liveness leases are refreshed on load — restart grace).

Wire protocol: newline-delimited JSON, one request object per line, one
response object per line, connections long-lived. Values are anything
JSON encodes — the same envelope FileCoordinator already writes to its
round files.

Observability (rides ``resilience.metrics()``):
  transport_reconnects_total   counter — client reconnect attempts
  transport_failovers_total    counter — client endpoint failovers that
                               reached a serving (promoted) member
  transport_heartbeat_lag      per-host gauge — seconds a host's
                               heartbeat cadence is running behind
                               (0 when healthy; grows during stalls)
  transport_term               gauge — the replication term last
                               observed (clients per host; the server
                               on every promote/demote)
  transport_replication_lag    gauge — ops the furthest-behind in-sync
                               standby trails the primary
"""
import collections
import json
import os
import socket
import socketserver
import threading
import time

from . import faultinject
from .coordination import GROW_FENCE_REASON
from .resilience import RetryPolicy, record_buddy_resident, record_event

__all__ = ["TransportError", "CoordServer", "CoordClient",
           "replicated_group", "MailboxServer", "mailbox_request"]

_DEFAULT_HB_INTERVAL_S = 0.5
# ops the primary must confirm on the standbys before answering the
# client (round contributions, tombstones, membership): everything a
# promoted standby must never rewind. hb/ack are ASYNC — leases are
# refreshed at promotion anyway, and a lost ack only delays cleanup.
_SYNC_CMDS = frozenset(("hello", "mark_lost", "announce_join",
                        "unfence", "put", "put_info", "put_blob",
                        "put_buddy_meta", "mailbox_hello",
                        "resize"))
_MUTATING_CMDS = _SYNC_CMDS | frozenset(("hb", "ack"))
_REPL_CMDS = frozenset(("repl_sync", "repl_apply", "repl_snapshot",
                        "repl_hb"))


class TransportError(ConnectionError):
    """The coordination service could not be reached (after retries).
    Subclasses ConnectionError so resilience.classify treats it as
    transient — the caller's RetryPolicy decides when to give up."""


def _split_addr(address):
    host, _, port = str(address).rpartition(":")
    return (host or "127.0.0.1", int(port))


def _blob_nbytes(blob):
    """Resident size of one legacy put_blob payload (the base64 npz
    text dominates; non-dict payloads are sized by their repr)."""
    if isinstance(blob, dict):
        return len(blob.get("npz", ""))
    return 0 if blob is None else len(str(blob))


def _record_coord_resident(state):
    """Export what THIS coordinator process holds for the buddy tier
    (legacy blob payloads + the p2p metadata table) as the
    ``buddy_resident_bytes{host="coord"}`` gauge — the memory-ceiling
    regression gate serving_probe --strict enforces. Callers hold
    ``state.lock``."""
    n = sum(_blob_nbytes(rec.get("blob"))
            for rec in state.blobs.values())
    n += len(json.dumps(
        {str(h): rec for h, rec in state.buddy_meta.items()}))
    record_buddy_resident("coord", n)


def _probe_status(address, timeout_s=1.0):
    """One-shot ``status`` probe against a group member; None when the
    member is unreachable (the promotion dance treats that as dead)."""
    try:
        with socket.create_connection(_split_addr(address),
                                      timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            s.sendall(json.dumps({"cmd": "status"}).encode() + b"\n")
            line = s.makefile("rb").readline()
        return json.loads(line) if line else None
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class _PodState(object):
    """The coordination KV state, guarded by one lock.

    Mirrors FileCoordinator's directory layout in memory:
      lost:   {host_id: reason}           tombstones (fencing)
      joins:  {host_id: nonce}            fenced hosts asking back in
      rounds: {name: {"values", "tokens", "done", "acks"}}
      hb:     {host_id: last monotonic}   heartbeats (hello/hb)
      info:   {host_id: blob}             member-published JSON blobs
                                          (serving address, generation —
                                          see ``put_info``/``members``)
    ``completed`` keeps the most recent frozen round names (bounded
    deque — a long-running service must not grow by one string per
    round forever) for test and tooling introspection.

    Replication metadata lives here too, under the same lock:
    ``role`` ("primary"/"standby" — solo servers are always primary),
    ``term`` (bumped on every promotion; every response carries it) and
    ``applied_seq`` (the replication stream position — on the primary
    the next op gets ``applied_seq + 1``; a standby applies in exactly
    that order or asks for a snapshot).

    ``n_hosts=None`` starts the service in AUTO-SIZE mode: the pod size
    is learned from the first ``hello`` that carries ``n_hosts`` (every
    SocketCoordinator sends it), and every later hello must agree.
    Until then only ``hello`` is served — any other op would need the
    size for range checks and round completion.
    """

    def __init__(self, n_hosts, hb_deadline_s=None):
        self.n_hosts = None if n_hosts is None else int(n_hosts)
        self.hb_deadline_s = None if hb_deadline_s is None \
            else float(hb_deadline_s)
        self.lock = threading.Lock()
        self.lost = {}
        # bumped on EVERY membership mutation (tombstone and unfence):
        # clients order the lost maps they observe by it, so a stale
        # response processed late can never resurrect a cleared
        # tombstone (or re-fire loss hooks for a readmitted host)
        self.lost_version = 0
        # bumped on every accepted ``resize``: the hello mismatch error
        # names a resized group explicitly (a stale-size client must
        # relaunch with the current size, never land phantom state)
        self.resize_version = 0
        self.joins = {}
        self.rounds = {}
        self.hb = {}
        self.info = {}
        # buddy-checkpoint mailboxes: {owner: {"gen", "buddy", "blob"}}.
        # Bounded by construction — ONE generation per owner, overwritten
        # in place every window (put_blob refuses a gen rewind). An
        # entry models a replica living in the buddy host's RAM, so it
        # is evicted only when owner AND buddy are both tombstoned —
        # the one case where nobody holds the bytes anymore.
        self.blobs = {}
        # legacy-mailbox payload ceiling: put_blob refuses a single
        # payload above this many bytes with a NAMED error instead of
        # letting a misconfigured legacy-mode pod grow the coordinator
        # until the OOM killer arrives. None disables the check.
        self.blob_max_bytes = None
        # p2p buddy tier: the coordinator holds only this METADATA
        # table — {owner: {"gen", "buddy", "digest", "nbytes"}} — while
        # payloads live in the hosts' own MailboxServer endpoints,
        # registered in mailbox_addrs ({host: "ip:port"}). Same
        # generation fence and double-tombstone eviction as blobs.
        self.buddy_meta = {}
        self.mailbox_addrs = {}
        self.completed = collections.deque(maxlen=2048)
        self.role = "primary"
        self.term = 0
        self.applied_seq = 0
        # heartbeat scans are HELD OFF until this monotonic instant: a
        # freshly promoted (or snapshot-restored) member must give
        # every client a full deadline of grace to re-dial before it
        # may fence anyone — their silence was the OLD primary's
        # death, not theirs
        self.scan_holdoff = 0.0

    # -- callers hold self.lock ------------------------------------------
    def _mark_lost(self, host_id, reason):
        if host_id in self.lost:
            return False
        self.lost[host_id] = str(reason)
        self.lost_version += 1
        self.joins.pop(host_id, None)
        self._evict_orphan_blobs()
        return True

    def _evict_orphan_blobs(self):
        """Drop buddy snapshots whose owner AND recorded buddy are both
        tombstoned: in the physical system those bytes lived in the
        buddy's RAM, so a double failure loses them — keeping the
        mailbox would let a restore adopt state no live host vouches
        for. A dead owner whose buddy is alive keeps its mailbox:
        that IS the buddy-restore case."""
        for owner in [o for o, rec in self.blobs.items()
                      if o in self.lost and rec["buddy"] in self.lost]:
            del self.blobs[owner]
        for owner in [o for o, rec in self.buddy_meta.items()
                      if o in self.lost and rec["buddy"] in self.lost]:
            del self.buddy_meta[owner]

    def _scan_heartbeats(self, now):
        """Tombstone every registered, un-fenced host whose heartbeat is
        older than the deadline. Returns the newly lost ids."""
        if self.hb_deadline_s is None or now < self.scan_holdoff:
            return []
        newly = []
        for hid, last in list(self.hb.items()):
            if hid in self.lost:
                continue
            age = now - last
            if age > self.hb_deadline_s:
                if self._mark_lost(hid, "missed heartbeat (%.2fs > %.2fs)"
                                   % (age, self.hb_deadline_s)):
                    newly.append(hid)
        return newly

    def _freeze_if_complete(self, name):
        """STICKY completion (Local/FileCoordinator parity): the first
        observation of every live host present freezes the member
        snapshot; later membership changes cannot re-open the round."""
        r = self.rounds.get(name)
        if r is None or r["done"] is not None:
            return
        present = set(r["values"])
        waiting = [i for i in range(self.n_hosts)
                   if i not in self.lost and i not in present]
        if waiting:
            return
        r["done"] = sorted(present - set(self.lost))
        self.completed.append(name)

    # -- snapshot ser/de (callers hold self.lock) -------------------------
    def to_snapshot(self):
        """JSON-ready full-state snapshot: the standby bootstrap payload
        AND the on-disk restart format (one encoding, two consumers).
        Heartbeat leases travel as the SET of leased hosts, not their
        ages — monotonic clocks do not cross processes, and the loader
        refreshing every lease to its own ``now`` is exactly the
        restart/failover grace clients need to re-dial."""
        return {
            "v": 1,
            "n_hosts": self.n_hosts,
            "term": self.term,
            "seq": self.applied_seq,
            "lost": {str(h): r for h, r in self.lost.items()},
            "lost_version": self.lost_version,
            "resize_version": self.resize_version,
            "joins": {str(h): n for h, n in self.joins.items()},
            "rounds": {
                name: {"values": {str(h): v
                                  for h, v in r["values"].items()},
                       "tokens": {str(h): t
                                  for h, t in r["tokens"].items()},
                       "done": r["done"],
                       "acks": sorted(r["acks"])}
                for name, r in self.rounds.items()},
            "info": {str(h): v for h, v in self.info.items()},
            "blobs": {str(h): rec for h, rec in self.blobs.items()},
            "buddy_meta": {str(h): rec
                           for h, rec in self.buddy_meta.items()},
            "mailbox_addrs": {str(h): a
                              for h, a in self.mailbox_addrs.items()},
            "hb_hosts": sorted(self.hb),
            "completed": list(self.completed),
        }

    def load_snapshot(self, snap, now):
        """Adopt a full snapshot (standby bootstrap / restart resume).
        Every leased host's heartbeat is refreshed to ``now`` so the
        grace period for clients to re-dial starts here, not at some
        other process's epoch."""
        self.n_hosts = None if snap.get("n_hosts") is None \
            else int(snap["n_hosts"])
        self.term = int(snap.get("term", 0))
        self.applied_seq = int(snap.get("seq", 0))
        self.lost = {int(h): r for h, r in snap.get("lost", {}).items()}
        self.lost_version = int(snap.get("lost_version", 0))
        # absent in snapshots written before resizes existed: groups
        # that never resize stay wire-compatible (0 == never resized)
        self.resize_version = int(snap.get("resize_version", 0))
        self.joins = {int(h): int(n)
                      for h, n in snap.get("joins", {}).items()}
        self.rounds = {
            name: {"values": {int(h): v
                              for h, v in r.get("values", {}).items()},
                   "tokens": {int(h): t
                              for h, t in r.get("tokens", {}).items()},
                   "done": r.get("done"),
                   "acks": set(r.get("acks", ()))}
            for name, r in snap.get("rounds", {}).items()}
        self.info = {int(h): v for h, v in snap.get("info", {}).items()}
        # absent in pre-buddy snapshots (default: no mailboxes)
        self.blobs = {int(h): rec
                      for h, rec in snap.get("blobs", {}).items()}
        # absent in pre-p2p snapshots (default: no p2p metadata)
        self.buddy_meta = {int(h): rec
                           for h, rec in
                           snap.get("buddy_meta", {}).items()}
        self.mailbox_addrs = {int(h): a
                              for h, a in
                              snap.get("mailbox_addrs", {}).items()}
        self.hb = {int(h): now for h in snap.get("hb_hosts", ())}
        if self.hb_deadline_s is not None:
            # restart grace, same reasoning as the promotion holdoff
            self.scan_holdoff = now + self.hb_deadline_s
        self.completed = collections.deque(snap.get("completed", ()),
                                           maxlen=2048)


# ---------------------------------------------------------------------------
# replication engine (primary streaming + standby promotion)
# ---------------------------------------------------------------------------

class _Replication(object):
    """The warm-standby engine of one group member.

    Owns the per-peer sender threads (primary side: stream ops, push
    snapshots, collect acks) and the promotion watcher (standby side:
    judge the primary dead by the heartbeat staleness bound, defer to
    lower-index live standbys, promote with a bumped term). Role and
    term live on the shared ``_PodState`` under ITS lock; the op log
    and ack bookkeeping live here under ``self.cond``. Lock order:
    ``state.lock`` may be held when taking ``self.cond``, NEVER the
    reverse."""

    LOG_CAP = 4096

    def __init__(self, server, index, peers, standby,
                 sync_timeout_s=2.0):
        self.server = server
        self.state = server._state
        self.index = int(index)
        if isinstance(peers, dict):
            all_peers = {int(i): str(a) for i, a in peers.items()}
        else:
            all_peers = {i: str(a) for i, a in enumerate(peers)}
        # peers = every OTHER member, keyed by its group index; the
        # index order IS the promotion priority
        self.peers = {i: a for i, a in all_peers.items()
                      if i != self.index}
        self.cond = threading.Condition()
        self.log = collections.deque(maxlen=self.LOG_CAP)  # (seq, op)
        self.acked = {}
        self.in_sync = {}
        self.sync_timeout_s = float(sync_timeout_s)
        self.last_stream = time.monotonic()
        self.primary_index = None if standby else self.index
        self._lag_rec_t = 0.0
        self._stop = threading.Event()
        self._threads = []
        self.state.role = "standby" if standby else "primary"

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._discover_incumbent()
        for pidx, addr in sorted(self.peers.items()):
            t = threading.Thread(target=self._sender_main,
                                 args=(pidx, addr), daemon=True,
                                 name="paddle_tpu-repl-%d>%d"
                                 % (self.index, pidx))
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._watch_main, daemon=True,
                             name="paddle_tpu-repl-watch-%d"
                             % self.index)
        t.start()
        self._threads.append(t)

    def stop(self, join=True):
        self._stop.set()
        with self.cond:
            self.cond.notify_all()
        if join:
            for t in self._threads:
                t.join(timeout=5.0)

    def _discover_incumbent(self):
        """Startup term discovery: a member booted as primary (e.g. a
        restarted ex-primary relaunched with its ORIGINAL flags) probes
        its peers first — finding a higher term, or a live primary at
        its own term, it starts as a STANDBY instead of splitting the
        brain. Fresh groups find nothing and keep their configured
        roles."""
        with self.state.lock:
            if self.state.role != "primary" or not self.peers:
                return
            my_term = self.state.term
        best = None
        for pidx, addr in sorted(self.peers.items()):
            st = _probe_status(addr)
            if not st:
                continue
            t = int(st.get("term", 0))
            if t > my_term or (st.get("role") == "primary"
                               and t >= my_term):
                if best is None or t > best[0]:
                    best = (t, pidx)
        if best is None:
            return
        with self.state.lock:
            self.state.term = max(self.state.term, best[0])
            self.state.role = "standby"
            self.primary_index = best[1]
            self.last_stream = time.monotonic()
            term = self.state.term
        record_event("transport_demote", index=self.index, term=term,
                     reason="incumbent")
        record_event("transport_term", term=term)

    # -- primary side ------------------------------------------------------
    def publish_locked(self, seq, op):
        """Append one op to the stream (caller holds ``state.lock``;
        the seq was already taken from ``state.applied_seq``)."""
        with self.cond:
            self.log.append((seq, op))
            self.cond.notify_all()

    def wait_replicated(self, target_seq, timeout_s):
        """Block until every IN-SYNC standby acked ``target_seq``. On
        timeout the laggards are dropped from the sync set (they will
        re-position — possibly via snapshot — when they catch up or
        reconnect): a dead standby must cost one bounded wait, not the
        pod's availability."""
        deadline = time.monotonic() + float(timeout_s)
        with self.cond:
            while not self._stop.is_set():
                waiting = [p for p in self.peers
                           if self.in_sync.get(p)
                           and self.acked.get(p, 0) < target_seq]
                if not waiting:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    for p in waiting:
                        self.in_sync[p] = False
                    record_event("transport_repl_desync",
                                 peers=sorted(waiting),
                                 seq=target_seq)
                    return False
                self.cond.wait(remaining)
        return False

    def _ack(self, pidx, have):
        with self.state.lock:
            head = self.state.applied_seq
        now = time.monotonic()
        with self.cond:
            self.acked[pidx] = have
            self.in_sync[pidx] = True
            self.cond.notify_all()
            lag = max((head - self.acked.get(p, 0)
                       for p in self.peers if self.in_sync.get(p)),
                      default=0)
            due = now - self._lag_rec_t > 1.0
            if due:
                self._lag_rec_t = now
        # the gauge event is throttled like the hb-lag one: the event
        # log is bounded and acks run at op rate
        if due:
            record_event("transport_repl_lag", lag=lag)

    def _next_entry(self, sent, timeout_s):
        """The next op past ``sent``: an (seq, op) entry, "snapshot"
        when the log window no longer covers the gap, or None on idle
        timeout (the sender then heartbeats)."""
        deadline = time.monotonic() + timeout_s
        with self.cond:
            while not self._stop.is_set():
                if self.log:
                    first = self.log[0][0]
                    if sent + 1 < first:
                        return "snapshot"
                    idx = sent + 1 - first
                    if idx < len(self.log):
                        return self.log[idx]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self.cond.wait(remaining)
        return None

    @staticmethod
    def _rpc(sock, rfile, req):
        sock.sendall(json.dumps(req).encode() + b"\n")
        line = rfile.readline()
        if not line:
            raise ConnectionError("replication peer closed the stream")
        return json.loads(line)

    def _observe_higher_term(self, term, pidx=None):
        """A peer answered with a term beyond ours: adopt it, and if we
        were primary, DEMOTE — we are the stale ex-primary the fencing
        exists for. The watcher takes over from here (it may promote us
        again later if the whole group ahead of us dies)."""
        demoted = False
        with self.state.lock:
            if term > self.state.term:
                self.state.term = term
                if self.state.role == "primary":
                    self.state.role = "standby"
                    demoted = True
                self.primary_index = pidx
                self.last_stream = time.monotonic()
            new_term = self.state.term
        if demoted:
            record_event("transport_demote", index=self.index,
                         term=new_term, reason="higher_term")
            record_event("transport_term", term=new_term)

    def _send_snapshot(self, sock, rfile, term):
        with self.state.lock:
            snap = self.state.to_snapshot()
        resp = self._rpc(sock, rfile, {"cmd": "repl_snapshot",
                                       "term": term,
                                       "index": self.index,
                                       "state": snap})
        if resp.get("repl_reject"):
            self._observe_higher_term(int(resp.get("term", 0)))
            raise ConnectionError("snapshot rejected (stale term)")
        return int(resp.get("have", snap["seq"]))

    def _sender_main(self, pidx, addr):
        """One peer's replication stream: position (sync/snapshot),
        then apply-op/heartbeat forever. Parked while this member is a
        standby; reconnects with a small backoff on socket loss."""
        backoff = 0.05
        sock = rfile = None
        sent = -1

        def drop():
            for c in (rfile, sock):
                try:
                    if c is not None:
                        c.close()
                except OSError:
                    pass
            with self.cond:
                self.in_sync[pidx] = False
                self.cond.notify_all()

        hb_s = self.state.hb_deadline_s
        idle_s = max(0.05, hb_s / 4.0) if hb_s else 0.5
        while not self._stop.is_set():
            with self.state.lock:
                role = self.state.role
                term = self.state.term
                head = self.state.applied_seq
            if role != "primary":
                if sock is not None:
                    drop()
                    sock = rfile = None
                self._stop.wait(0.2)
                continue
            try:
                if sock is None:
                    sock = socket.create_connection(_split_addr(addr),
                                                    timeout=2.0)
                    sock.settimeout(max(2.0, self.sync_timeout_s * 2))
                    rfile = sock.makefile("rb")
                    resp = self._rpc(sock, rfile,
                                     {"cmd": "repl_sync", "term": term,
                                      "seq": head, "index": self.index})
                    if resp.get("repl_reject"):
                        self._observe_higher_term(
                            int(resp.get("term", 0)), pidx)
                        raise ConnectionError("sync rejected")
                    have = int(resp.get("have", 0))
                    with self.cond:
                        covered = bool(self.log) \
                            and self.log[0][0] <= have + 1
                    if have < head and not covered:
                        have = self._send_snapshot(sock, rfile, term)
                    sent = have
                    self._ack(pidx, sent)
                entry = self._next_entry(sent, idle_s)
                if entry == "snapshot":
                    sent = self._send_snapshot(sock, rfile, term)
                    self._ack(pidx, sent)
                    continue
                if entry is None:
                    resp = self._rpc(sock, rfile,
                                     {"cmd": "repl_hb", "term": term,
                                      "seq": head, "index": self.index})
                else:
                    seq, op = entry
                    resp = self._rpc(sock, rfile,
                                     {"cmd": "repl_apply", "term": term,
                                      "seq": seq, "index": self.index,
                                      "op": op})
                if resp.get("repl_reject"):
                    self._observe_higher_term(
                        int(resp.get("term", 0)), pidx)
                    raise ConnectionError("stream rejected")
                if resp.get("need_snapshot"):
                    sent = self._send_snapshot(sock, rfile, term)
                else:
                    sent = int(resp.get("have", sent))
                self._ack(pidx, sent)
                backoff = 0.05
            except (OSError, ValueError):
                drop()
                sock = rfile = None
                sent = -1
                self._stop.wait(backoff)
                backoff = min(0.5, backoff * 2.0)
        drop()

    # -- standby side ------------------------------------------------------
    def _watch_main(self):
        """Promotion watcher: while standby, judge the primary by the
        SAME heartbeat staleness bound hosts are fenced by; on
        staleness, defer to any lower-index live standby (the
        lowest-index live standby promotes), and never promote past a
        primary that still answers its status probe."""
        dl = self.state.hb_deadline_s
        if dl is None:
            return   # liveness disabled: promotion is manual-only
        period = max(0.02, dl / 4.0)
        while not self._stop.wait(period):
            with self.state.lock:
                role = self.state.role
                term = self.state.term
            if role != "standby":
                continue
            if time.monotonic() - self.last_stream <= dl:
                continue
            statuses = {}
            for pidx, addr in sorted(self.peers.items()):
                st = _probe_status(addr, timeout_s=max(0.2, dl / 4.0))
                if st:
                    statuses[pidx] = st
            if any(st.get("role") == "primary"
                   and int(st.get("term", 0)) >= term
                   for st in statuses.values()):
                # a live primary exists — our stream is partitioned,
                # not orphaned. Reset the staleness clock and keep
                # waiting: promoting here WOULD be the split brain.
                self.last_stream = time.monotonic()
                continue
            if any(pidx < self.index and st.get("role") == "standby"
                   for pidx, st in statuses.items()):
                continue   # a lower-index live standby will promote
            self._promote()

    def _promote(self):
        with self.state.lock:
            if self.state.role != "standby":
                return
            self.state.term += 1
            self.state.role = "primary"
            term = self.state.term
            now = time.monotonic()
            # failover grace: every lease restarts NOW — plus a full
            # extra deadline of scan holdoff, because a client deep in
            # its reconnect backoff may take longer than one deadline
            # to land its first post-promotion heartbeat
            for h in list(self.state.hb):
                self.state.hb[h] = now
            if self.state.hb_deadline_s is not None:
                self.state.scan_holdoff = \
                    now + self.state.hb_deadline_s
            self.primary_index = self.index
            with self.cond:
                # the promoted log starts empty at applied_seq: peers
                # behind it re-position via snapshot
                self.log.clear()
                self.acked = {}
                self.in_sync = {}
                self.cond.notify_all()
        record_event("transport_promote", index=self.index, term=term)
        record_event("transport_term", term=term)

    # -- repl request handling (both sides; caller holds state.lock) ------
    def handle_locked(self, state, req, now):
        cmd = req.get("cmd")
        term = int(req.get("term", 0))
        pidx = req.get("index")
        pidx = None if pidx is None else int(pidx)
        if term < state.term:
            # THE ex-primary fence: a stale incarnation's stream is
            # refused with the new term; it demotes itself on sight
            return {"repl_reject": True, "term": state.term}
        if term == state.term and state.role == "primary":
            # two primaries at one term (a promotion race): the LOWER
            # index wins outright — deterministic, no negotiation
            if pidx is not None and pidx < self.index:
                state.role = "standby"
                record_event("transport_demote", index=self.index,
                             term=state.term, reason="tie_break")
            else:
                return {"repl_reject": True, "term": state.term}
        if term > state.term:
            state.term = term
            if state.role == "primary":
                state.role = "standby"
                record_event("transport_demote", index=self.index,
                             term=term, reason="higher_term")
            record_event("transport_term", term=term)
        self.last_stream = time.monotonic()
        if pidx is not None:
            self.primary_index = pidx
        if cmd in ("repl_sync", "repl_hb"):
            return {"ok": True, "have": state.applied_seq,
                    "term": state.term}
        if cmd == "repl_apply":
            seq = int(req.get("seq", 0))
            if seq <= state.applied_seq:
                return {"ok": True, "have": state.applied_seq}
            if seq == state.applied_seq + 1:
                _apply_replicated(state, req.get("op") or {}, now)
                state.applied_seq = seq
                return {"ok": True, "have": seq}
            return {"need_snapshot": True, "have": state.applied_seq}
        if cmd == "repl_snapshot":
            state.load_snapshot(req.get("state") or {}, now)
            state.term = max(state.term, term)
            state.role = "standby"
            return {"ok": True, "have": state.applied_seq}
        return {"error": "unknown repl cmd %r" % cmd}

    def primary_hint(self):
        """The current primary's address, best-effort (a standby knows
        it from the stream metadata; None before the first contact —
        or once the stream has gone STALE: hinting clients at a
        primary we ourselves judge dead would ping-pong them between
        a refused connection and this redirect for the whole
        promotion window)."""
        if self.primary_index is None:
            return None
        if self.primary_index == self.index:
            return self.server.address
        dl = self.state.hb_deadline_s
        if dl is not None \
                and time.monotonic() - self.last_stream > dl:
            return None
        return self.peers.get(self.primary_index)


def _apply_replicated(state, op, now):
    """Apply one replicated op to standby state (caller holds the
    lock). The response is discarded — determinism comes from applying
    the SAME op sequence to the SAME starting snapshot; heartbeat
    leases land on the standby's own clock, which is exactly what its
    post-promotion monitor must judge by."""
    cmd = op.get("cmd")
    hid = op.get("host")
    hid = None if hid is None else int(hid)
    try:
        _dispatch(state, cmd, hid, op, now)
    except Exception:   # pragma: no cover - a poison op must not
        pass            # kill the stream; the state simply skips it


class CoordServer(object):
    """The rendezvous service: TCP + threads, stdlib only.

    One per pod — or, replicated, one GROUP per pod (see the module
    docstring): ``configure_replication(index, peers, standby=)``
    before :meth:`start` wires this member into a term-numbered
    primary/warm-standby group; :func:`replicated_group` builds a whole
    in-process group for tests and benches. ``snapshot_path=`` arms
    periodic on-disk state snapshots (reloaded on construction) so even
    a SOLO deployment survives a supervised restart with its in-flight
    rounds intact.

    Start in-process (tests, or the host-0 sidecar pattern) or
    standalone through ``python -m paddle_tpu_torch.tools.coordsvc``.
    ``port=0`` binds an
    ephemeral port — read it back from :attr:`address`.
    ``n_hosts=None`` starts in auto-size mode: the pod size is learned
    from the first hello that carries one (``paddle_tpu_torch.tools.coordsvc
    --n-hosts auto``) — elastic group sizes without up-front config.

    ``hb_deadline_s`` arms heartbeat liveness: any host that ever said
    hello and then goes silent past the deadline is tombstoned by the
    monitor thread, exactly as if a peer had declared it lost — clients
    observe the tombstone on their next heartbeat/poll and fire their
    loss hooks. ``None`` disables the monitor (losses then come only
    from explicit ``mark_lost`` / gather deadlines, the FileCoordinator
    default). The SAME deadline judges the primary in a replicated
    group: a standby whose replication stream goes stale past it runs
    the promotion dance."""

    def __init__(self, n_hosts, port=0, host="127.0.0.1",
                 hb_deadline_s=None, snapshot_path=None,
                 snapshot_every_s=5.0, blob_max_bytes=64 * 1024 * 1024):
        self._state = _PodState(n_hosts, hb_deadline_s=hb_deadline_s)
        # legacy-mailbox ceiling (server config, not replicated state):
        # finite by default so a legacy-mode pod with an oversized scope
        # gets a NAMED refusal instead of silently growing this process
        # by n_hosts x scope. None disables.
        self._state.blob_max_bytes = None if blob_max_bytes is None \
            else int(blob_max_bytes)
        self._repl = None
        self._snapshot_path = snapshot_path
        self._snapshot_every_s = float(snapshot_every_s)
        if snapshot_path and os.path.exists(snapshot_path):
            try:
                with open(snapshot_path) as fh:
                    snap = json.load(fh)
                with self._state.lock:
                    self._state.load_snapshot(snap, time.monotonic())
                record_event("transport_snapshot_load",
                             seq=self._state.applied_seq,
                             term=self._state.term)
            except (OSError, ValueError):
                # a torn/unreadable snapshot must not block the
                # restart: the service comes up empty (the pre-snapshot
                # behavior) and the next period overwrites it
                record_event("transport_snapshot_corrupt",
                             path=str(snapshot_path))
        state = self._state
        server_self = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                # register the live connection: kill()/close() sever
                # every one of them, because a "dead" member that keeps
                # answering on long-lived sockets is exactly the stale
                # primary the chaos tests must reproduce
                with server_self._conns_lock:
                    server_self._conns.add(self.connection)
                try:
                    while not server_self._dead:
                        line = self.rfile.readline()
                        if not line:
                            return
                        try:
                            req = json.loads(line)
                            resp = _serve(server_self, state, req)
                        except Exception as e:   # malformed request
                            resp = {"error": "%s: %s"
                                    % (type(e).__name__, e)}
                        self.wfile.write(json.dumps(resp).encode()
                                         + b"\n")
                        self.wfile.flush()
                finally:
                    with server_self._conns_lock:
                        server_self._conns.discard(self.connection)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._conns = set()
        self._conns_lock = threading.Lock()
        self._server = _Server((host, port), _Handler)
        self.address = "%s:%d" % self._server.server_address[:2]
        self._threads = []
        self._closed = threading.Event()
        self._dead = False

    @property
    def state(self):
        """The live :class:`_PodState` — in-process introspection for
        tests and the host-0 sidecar (read under ``state.lock``)."""
        return self._state

    def configure_replication(self, index, peers, standby=False,
                              sync_timeout_s=2.0):
        """Wire this member into a replication group BEFORE start():
        ``peers`` is the ordered endpoint list (or {index: addr} map)
        of the WHOLE group — own entry included, skipped by ``index``.
        ``standby=True`` boots in standby role (waits for the stream);
        a member booted primary still probes its peers first and defers
        to a higher-term incumbent (the restarted ex-primary path)."""
        self._repl = _Replication(self, index, peers, standby,
                                  sync_timeout_s=sync_timeout_s)
        return self

    def _replicate_locked(self, op):
        """Primary-side: take the next stream seq for ``op`` and
        publish it to the senders. Caller holds ``state.lock``. Returns
        the seq (to sync-wait on), or None when not replicating."""
        if self._repl is None or self._state.role != "primary":
            return None
        self._state.applied_seq += 1
        seq = self._state.applied_seq
        self._repl.publish_locked(seq, op)
        return seq

    def _scan_and_replicate_locked(self, now):
        """Heartbeat scan + synthetic-tombstone replication, the ONE
        home for both fencing paths (the monitor thread and the
        per-request piggyback): monitor tombstones are mutations with
        no client op behind them, so the stream carries them as
        synthetic mark_lost ops. Caller holds ``state.lock``; returns
        the newly fenced ids."""
        newly = self._state._scan_heartbeats(now)
        for hid in newly:
            self._replicate_locked(
                {"cmd": "mark_lost", "host": hid,
                 "reason": self._state.lost.get(hid,
                                                "missed heartbeat")})
        return newly

    def start(self):
        t = threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="paddle_tpu-coordsvc")
        t.start()
        self._threads.append(t)
        if self._state.hb_deadline_s is not None:
            m = threading.Thread(target=self._monitor, daemon=True,
                                 name="paddle_tpu-coordsvc-hb")
            m.start()
            self._threads.append(m)
        if self._repl is not None:
            self._repl.start()
        if self._snapshot_path:
            s = threading.Thread(target=self._snapshot_loop, daemon=True,
                                 name="paddle_tpu-coordsvc-snap")
            s.start()
            self._threads.append(s)
        return self

    def _monitor(self):
        period = max(0.01, self._state.hb_deadline_s / 4.0)
        while not self._closed.wait(period):
            with self._state.lock:
                if self._state.role != "primary":
                    continue   # only the primary judges host liveness
                newly = self._scan_and_replicate_locked(time.monotonic())
            for hid in newly:
                record_event("hb_lost", host_lost=hid)

    def _snapshot_loop(self):
        while not self._closed.wait(self._snapshot_every_s):
            self.save_snapshot()

    def save_snapshot(self):
        """Persist the full state atomically (temp + replace). A no-op
        without ``snapshot_path``; called periodically and on close."""
        if not self._snapshot_path:
            return None
        with self._state.lock:
            blob = json.dumps(self._state.to_snapshot())
        tmp = "%s.tmp.%d" % (self._snapshot_path, os.getpid())
        try:
            with open(tmp, "w") as fh:
                fh.write(blob)
            os.replace(tmp, self._snapshot_path)
        except OSError:   # pragma: no cover - disk trouble
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return self._snapshot_path

    def _sever_connections(self):
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def close(self):
        if self._dead:
            return
        self._dead = True
        self._closed.set()
        if self._repl is not None:
            self._repl.stop()
        self.save_snapshot()
        self._server.shutdown()
        self._sever_connections()
        self._server.server_close()
        for t in self._threads:
            t.join(timeout=5.0)

    def kill(self):
        """Abrupt in-process death for chaos tests and benches: stop
        serving NOW — no final snapshot, no graceful joins, every live
        connection severed — so peers and clients see exactly what a
        SIGKILL leaves behind."""
        if self._dead:
            return
        self._dead = True
        self._closed.set()
        if self._repl is not None:
            self._repl.stop(join=False)
        self._server.shutdown()
        self._sever_connections()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replicated_group(n_hosts, n_members=2, host="127.0.0.1",
                     hb_deadline_s=1.0, snapshot_paths=None,
                     sync_timeout_s=2.0):
    """Build + wire + start a whole in-process replication group:
    member 0 boots primary, the rest warm standbys, all sharing the
    ordered endpoint list. Returns the server list (same order as the
    endpoints clients should dial). Tests and bench_micro ride this;
    production deploys one ``coordsvc --peers ... --repl-index i``
    per member instead."""
    servers = [CoordServer(n_hosts, host=host,
                           hb_deadline_s=hb_deadline_s,
                           snapshot_path=None if snapshot_paths is None
                           else snapshot_paths[i])
               for i in range(n_members)]
    addrs = [s.address for s in servers]
    for i, s in enumerate(servers):
        s.configure_replication(i, addrs, standby=(i != 0),
                                sync_timeout_s=sync_timeout_s)
    for s in servers:
        s.start()
    return servers


def _serve(server, state, req):
    """Dispatch one request against the pod state. Every client op is
    idempotent so a client may blindly re-send after a reconnect (or a
    failover — the promoted standby holds the replicated state)."""
    cmd = req.get("cmd")
    now = time.monotonic()
    if cmd in _REPL_CMDS:
        repl = server._repl
        if repl is None:
            return {"error": "replication not configured on this member"}
        with state.lock:
            return repl.handle_locked(state, req, now)
    if cmd == "status":
        return _serve_status(server, state, now)
    if cmd == "time":
        # the obs clock-offset probe (obs.probe_clock_offset): the
        # server's wall clock, answered statelessly so it works before
        # the first sized hello and on standbys alike — tracing
        # alignment must not depend on group membership
        return {"ok": True, "wall": time.time()}
    hid = req.get("host")
    hid = None if hid is None else int(hid)
    wait_seq = None
    with state.lock:
        if state.role != "primary":
            # term-fenced redirect: a standby (or a demoted ex-primary)
            # serves NOTHING mutable — the client fails over on the
            # not_primary marker, or rejects a stale term outright
            hint = None if server._repl is None \
                else server._repl.primary_hint()
            return {"not_primary": True, "role": state.role,
                    "term": state.term, "primary": hint,
                    "error": "not primary (standby at term %d) — dial "
                    "the primary" % state.term}
        # both guards read state.n_hosts INSIDE the lock: in auto-size
        # mode a non-hello op racing the first sized hello must see
        # one consistent value — a torn read could skip the range
        # check and land exactly the phantom state it exists to block
        if hid is not None and state.n_hosts is not None \
                and not 0 <= hid < state.n_hosts:
            # an off-by-one host id must fail loudly, not land phantom
            # contributions in rounds or phantom tombstones
            return {"error": "host id %d out of range for a %d-host "
                    "pod" % (hid, state.n_hosts)}
        if state.n_hosts is None and cmd != "hello":
            # auto-size mode before the first sized hello: nothing
            # else can be range-checked or frozen yet
            return {"error": "pod size not learned yet — the first "
                    "hello must carry n_hosts (auto-size mode)"}
        # the heartbeat monitor owns proactive scans, but piggybacking
        # one on every request keeps detection sharp under load (and
        # makes the deadline hold even on a paused monitor thread)
        server._scan_and_replicate_locked(now)
        resp = _dispatch(state, cmd, hid, req, now)
        if "lost" in resp:
            # every lost map ships with its version: the client drops
            # any map older than one it already applied, so a response
            # processed late cannot resurrect a cleared tombstone
            resp["lost_v"] = state.lost_version
        if cmd in _MUTATING_CMDS and "error" not in resp \
                and "fenced" not in resp:
            seq = server._replicate_locked(dict(req, cmd=cmd))
            if seq is not None and cmd in _SYNC_CMDS:
                wait_seq = seq
        # the term rides EVERY response: the client's staleness fence
        resp["term"] = state.term
    if wait_seq is not None:
        # sync replication happens OUTSIDE the lock: a slow standby
        # must never serialize the whole service behind its socket
        server._repl.wait_replicated(wait_seq,
                                     server._repl.sync_timeout_s)
    return resp


def _serve_status(server, state, now):
    """The ``status`` probe — served by EVERY role (it is how standbys
    probe each other during the promotion dance, how coordsvc --status
    answers operators, and how a restarted ex-primary discovers the
    incumbent)."""
    repl = server._repl
    with state.lock:
        resp = {"ok": True, "role": state.role, "term": state.term,
                "seq": state.applied_seq, "n_hosts": state.n_hosts,
                "hb_deadline_s": state.hb_deadline_s,
                "address": server.address}
        if repl is not None:
            resp["index"] = repl.index
            resp["peers"] = {str(i): a
                             for i, a in sorted(repl.peers.items())}
            resp["primary"] = repl.primary_hint()
            if state.role == "primary":
                with repl.cond:
                    resp["repl_acked"] = {str(p): repl.acked.get(p, 0)
                                          for p in repl.peers}
                    resp["repl_in_sync"] = {str(p): bool(
                        repl.in_sync.get(p)) for p in repl.peers}
                    resp["repl_lag"] = max(
                        (state.applied_seq - repl.acked.get(p, 0)
                         for p in repl.peers if repl.in_sync.get(p)),
                        default=0)
            else:
                resp["stream_age_s"] = round(
                    now - repl.last_stream, 6)
    return resp


def _dispatch(state, cmd, hid, req, now):
    """The op table — caller holds ``state.lock``."""
    if cmd == "hello":
        if state.n_hosts is None:
            # auto-size: the first sized hello fixes the pod size for
            # the service's lifetime; later hellos must agree. The
            # validation runs BEFORE the commit — an error return must
            # not have the side effect of pinning a bogus size
            if req.get("n_hosts") is None:
                return {"error": "pod size not learned yet — this "
                        "hello must carry n_hosts (auto-size mode)"}
            want = int(req["n_hosts"])
            if want < 1:
                return {"error": "n_hosts must be >= 1, got %d" % want}
            if hid is not None and not 0 <= hid < want:
                return {"error": "host id %d out of range for a "
                        "%d-host pod" % (hid, want)}
            state.n_hosts = want
        if int(req.get("n_hosts", state.n_hosts)) != state.n_hosts:
            resized = (" — the group was RESIZED (v%d): relaunch this "
                       "member with the current size"
                       % state.resize_version) \
                if state.resize_version else ""
            return {"error": "pod size mismatch: server has %d "
                    "hosts, client expects %s%s"
                    % (state.n_hosts, req.get("n_hosts"), resized)}
        if hid is not None and req.get("lease"):
            # only heartbeating clients take a liveness lease: a
            # passive observer (heartbeat=False) that registered
            # one would be tombstoned the moment it went stale
            state.hb[hid] = now
        return {"ok": True, "n_hosts": state.n_hosts,
                "lost": dict(state.lost)}
    if cmd == "hb":
        if hid is not None:
            state.hb[hid] = now
        return {"ok": True, "lost": dict(state.lost)}
    if cmd == "lost":
        return {"lost": dict(state.lost)}
    if cmd == "mark_lost":
        state._mark_lost(hid, req.get("reason", "declared lost"))
        return {"ok": True, "lost": dict(state.lost)}
    if cmd == "announce_join":
        if hid not in state.lost:
            return {"error": "host %d is not fenced — only a lost "
                    "host announces a rejoin" % hid}
        state.joins[hid] = int(req.get("nonce", 0))
        return {"ok": True}
    if cmd == "pending_joins":
        return {"joins": dict(state.joins)}
    if cmd == "unfence":
        if state.lost.pop(hid, None) is not None:
            state.lost_version += 1
        state.joins.pop(hid, None)
        # the un-fenced host re-enters liveness with a fresh lease —
        # without this its pre-fence stale heartbeat would re-fence
        # it on the very next monitor scan
        if hid in state.hb:
            state.hb[hid] = now
        # the response CARRIES the post-unfence lost map: the caller's
        # client applies its (bumped) version before the coordinator
        # forgets the host, so any straggling pre-unfence callback is
        # dropped by the version guard instead of resurrecting the loss
        return {"ok": True, "lost": dict(state.lost)}
    if cmd == "put":
        name = req["name"]
        if hid in state.lost:
            return {"fenced": state.lost[hid], "lost": dict(state.lost)}
        r = state.rounds.setdefault(
            name, {"values": {}, "tokens": {}, "done": None,
                   "acks": set()})
        token = req.get("token")
        if hid in r["values"]:
            if r["tokens"].get(hid) == token and token is not None:
                # the same client re-sending after a reconnect (or a
                # FAILOVER onto the promoted standby): idempotent,
                # keyed by (name, host_id, token)
                return {"ok": True, "resent": True}
            return {"error": "host %d already contributed to round "
                    "%r — collective names must be unique per round"
                    % (hid, name)}
        if r["done"] is not None:
            # frozen without us: we were fenced when the snapshot
            # was taken — arriving now must not mutate it
            return {"fenced": state.lost.get(
                hid, "round %r froze without host %d" % (name, hid)),
                "lost": dict(state.lost)}
        r["values"][hid] = req.get("value")
        r["tokens"][hid] = token
        state._freeze_if_complete(name)
        return {"ok": True}
    if cmd == "poll":
        name = req["name"]
        r = state.rounds.get(name)
        if hid in state.lost and (r is None or r["done"] is None
                                  or hid not in r["done"]):
            return {"fenced": state.lost[hid], "lost": dict(state.lost)}
        if r is None:
            return {"error": "round %r unknown — poll follows put"
                    % name}
        state._freeze_if_complete(name)
        if r["done"] is None:
            waiting = [i for i in range(state.n_hosts)
                       if i not in state.lost
                       and i not in r["values"]]
            return {"waiting": waiting, "lost": dict(state.lost)}
        return {"done": r["done"],
                "values": {str(i): r["values"][i] for i in r["done"]},
                "lost": dict(state.lost)}
    if cmd == "ack":
        name = req["name"]
        r = state.rounds.get(name)
        if r is not None and r["done"] is not None:
            r["acks"].add(hid)
            if r["acks"] >= set(r["done"]):
                # last one out cleans up (File/LocalCoordinator
                # parity) — the rounds table stays bounded
                state.rounds.pop(name, None)
        return {"ok": True}
    if cmd == "put_info":
        # member-published blob (last write wins, idempotent): how a
        # serving replica advertises its HTTP address + generation so
        # the router never needs static fleet configuration
        if hid is None:
            return {"error": "put_info needs a host id"}
        state.info[hid] = req.get("info")
        return {"ok": True}
    if cmd == "put_blob":
        # buddy-checkpoint mailbox write: ONE generation per owner
        # (bounded memory), generation-fenced so a delayed/replayed
        # put can never rewind the mailbox below what a restore may
        # already have adopted. Primary-replicated (_SYNC_CMDS) and
        # snapshot-covered: a coordinator failover mid-window keeps
        # every acked snapshot.
        if hid is None:
            return {"error": "put_blob needs a host id"}
        if hid in state.lost:
            return {"fenced": state.lost[hid], "lost": dict(state.lost)}
        try:
            gen = int(req["gen"])
            buddy = int(req["buddy"])
        except (KeyError, TypeError, ValueError):
            return {"error": "put_blob needs integer gen and buddy"}
        nb = _blob_nbytes(req.get("blob"))
        if state.blob_max_bytes is not None \
                and nb > state.blob_max_bytes:
            # named refusal the client maps to BlobTooLargeError: a
            # legacy-mode pod whose scope outgrew the coordinator gets
            # a typed error (and falls back to the disk tier), never a
            # silent coordinator OOM. The p2p tier has no such ceiling
            # — payloads live in peer mailboxes.
            return {"error": "blob_max_bytes exceeded: put_blob of %d "
                    "bytes for host %d is over the coordinator's %d-"
                    "byte ceiling — use the p2p mailbox tier for "
                    "scopes this size" % (nb, hid,
                                          state.blob_max_bytes)}
        prev = state.blobs.get(hid)
        if req.get("reset"):
            # post-disk-restore re-seed: the pod legitimately rewound
            # below the mailbox generation (and a poison-batch replay
            # may change the trajectory, so even an equal-gen blob is
            # from the WRONG history) — force-overwrite, bypassing the
            # rewind fence
            state.blobs[hid] = {"gen": gen, "buddy": buddy,
                                "blob": req.get("blob")}
            _record_coord_resident(state)
            return {"ok": True, "reset": True}
        if prev is not None and gen < int(prev["gen"]):
            return {"error": "put_blob generation rewind: host %d is "
                    "at gen %d on the server, refused gen %d"
                    % (hid, int(prev["gen"]), gen)}
        if prev is not None and gen == int(prev["gen"]):
            # same client re-sending after a reconnect or a failover
            # onto the promoted standby: idempotent, keyed by gen
            return {"ok": True, "resent": True}
        state.blobs[hid] = {"gen": gen, "buddy": buddy,
                            "blob": req.get("blob")}
        _record_coord_resident(state)
        return {"ok": True}
    if cmd == "get_blob":
        # read-only mailbox fetch; meta_only skips the payload so the
        # restore election can poll generations cheaply. No fencing:
        # a fenced survivor reading its own (or a dead peer's) last
        # snapshot is exactly the restore path.
        try:
            owner = int(req["owner"])
        except (KeyError, TypeError, ValueError):
            return {"error": "get_blob needs an integer owner"}
        rec = state.blobs.get(owner)
        if rec is None:
            return {"miss": True}
        resp = {"gen": int(rec["gen"]), "buddy": int(rec["buddy"])}
        if not req.get("meta_only"):
            resp["blob"] = rec["blob"]
        return resp
    if cmd == "mailbox_hello":
        # p2p buddy tier: a host registers its MailboxServer endpoint
        # so restore-time peers can resolve host-to-host pulls.
        # Primary-replicated and snapshot-covered — the address book
        # must survive coordinator failover just like the metadata.
        if hid is None:
            return {"error": "mailbox_hello needs a host id"}
        addr = req.get("addr")
        if not addr:
            return {"error": "mailbox_hello needs an addr"}
        state.mailbox_addrs[hid] = str(addr)
        return {"ok": True}
    if cmd == "put_buddy_meta":
        # p2p buddy tier COMMIT: after the ring buddy's mailbox acked
        # the deposited payload, the sender publishes this metadata row
        # — {gen, buddy, digest, nbytes}, a few hundred bytes per host
        # regardless of scope size. Same generation fence as put_blob:
        # a delayed/replayed commit can never rewind the row below
        # what a restore may already have elected. Replicated
        # (_SYNC_CMDS) and snapshot-covered.
        if hid is None:
            return {"error": "put_buddy_meta needs a host id"}
        if hid in state.lost:
            return {"fenced": state.lost[hid], "lost": dict(state.lost)}
        try:
            gen = int(req["gen"])
            buddy = int(req["buddy"])
        except (KeyError, TypeError, ValueError):
            return {"error": "put_buddy_meta needs integer gen and "
                    "buddy"}
        row = {"gen": gen, "buddy": buddy,
               "digest": req.get("digest"),
               "nbytes": int(req.get("nbytes", 0))}
        prev = state.buddy_meta.get(hid)
        if req.get("reset"):
            state.buddy_meta[hid] = row
            _record_coord_resident(state)
            return {"ok": True, "reset": True}
        if prev is not None and gen < int(prev["gen"]):
            return {"error": "put_buddy_meta generation rewind: host "
                    "%d is at gen %d on the server, refused gen %d"
                    % (hid, int(prev["gen"]), gen)}
        if prev is not None and gen == int(prev["gen"]):
            return {"ok": True, "resent": True}
        state.buddy_meta[hid] = row
        _record_coord_resident(state)
        return {"ok": True}
    if cmd == "buddy_meta":
        # read-only metadata fetch for restore planning — one owner's
        # row, or the whole table + mailbox address book when no owner
        # is named. No fencing, same reasoning as get_blob.
        owner = req.get("owner")
        if owner is not None:
            rec = state.buddy_meta.get(int(owner))
            if rec is None:
                return {"miss": True}
            resp = dict(rec)
            resp["addr"] = state.mailbox_addrs.get(int(rec["buddy"]))
            return resp
        return {"meta": {str(h): dict(r)
                         for h, r in state.buddy_meta.items()},
                "addrs": {str(h): a
                          for h, a in state.mailbox_addrs.items()}}
    if cmd == "members":
        # one poll answers the whole routing question: who is
        # registered (info), who is fenced (lost — versioned by the
        # caller in _serve), and how stale each liveness lease is.
        # The server's deadline ships too, so clients can judge a
        # lease "live-looking" by the SAME bound the monitor fences by
        return {"n_hosts": state.n_hosts,
                "resize_v": state.resize_version,
                "hb_deadline_s": state.hb_deadline_s,
                "hb_age": {str(h): round(now - t, 6)
                           for h, t in state.hb.items()},
                "info": {str(h): v for h, v in state.info.items()},
                "lost": dict(state.lost)}
    if cmd == "resize":
        # DYNAMIC GROUP RESIZE: grow/shrink n_hosts at a round
        # boundary. Grown slots are born FENCED ("resized: awaiting
        # join") so in-flight gathers never wait for a member that has
        # not joined — the new member's start finds itself fenced and
        # takes the ordinary announce/admit/join path. A shrink only
        # removes TOP ids whose members are already fenced or hold no
        # live-looking lease (drain first). Primary-replicated
        # (_SYNC_CMDS) and snapshot-covered, so the resized size
        # survives failover and restart.
        try:
            want = int(req["n_hosts"])
        except (KeyError, TypeError, ValueError):
            return {"error": "resize needs an integer n_hosts"}
        if want < 1:
            return {"error": "resize: n_hosts must be >= 1, got %d"
                    % want}
        open_rounds = sorted(n for n, r in state.rounds.items()
                             if r["done"] is None)
        if open_rounds:
            return {"error": "resize refused mid-round: %d gather "
                    "round(s) in flight (%s) — retry at a round "
                    "boundary" % (len(open_rounds), open_rounds[:3])}
        if want == state.n_hosts:
            return {"ok": True, "n_hosts": want,
                    "resize_v": state.resize_version,
                    "lost": dict(state.lost)}
        if want < state.n_hosts:
            dl = state.hb_deadline_s
            live = [h for h in range(want, state.n_hosts)
                    if h not in state.lost and h in state.hb
                    and (dl is None or now - state.hb[h] <= dl)]
            if live:
                return {"error": "resize refused: host(s) %s hold a "
                        "live lease — drain/fence them before "
                        "shrinking past their ids" % live}
            for h in range(want, state.n_hosts):
                state.lost.pop(h, None)
                state.joins.pop(h, None)
                state.hb.pop(h, None)
                state.info.pop(h, None)
                state.blobs.pop(h, None)
                state.buddy_meta.pop(h, None)
                state.mailbox_addrs.pop(h, None)
            state.lost_version += 1
        else:
            for h in range(state.n_hosts, want):
                state._mark_lost(h, GROW_FENCE_REASON)
        state.n_hosts = want
        state.resize_version += 1
        return {"ok": True, "n_hosts": want,
                "resize_v": state.resize_version,
                "lost": dict(state.lost)}
    return {"error": "unknown cmd %r" % cmd}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

def _parse_endpoints(address):
    """Accepts one "host:port", a comma-joined list of them, a
    ("host", port) pair, or a list/tuple of endpoint strings — the
    replicated-group client shape. Returns [(host, port), ...] in
    priority order (primary first, by convention)."""
    if isinstance(address, (tuple, list)):
        items = list(address)
        # a 2-tuple whose second element is a (numeric) port is the
        # classic (host, port) pair — judged by the PORT, not by a ":"
        # in the host, so IPv6 literals like ("::1", 9000) keep working
        if len(items) == 2 and isinstance(items[0], str) and (
                isinstance(items[1], int)
                or (isinstance(items[1], str) and items[1].isdigit())):
            return [(items[0], int(items[1]))]
        out = []
        for it in items:
            out.extend(_parse_endpoints(it))
        return out
    out = []
    for part in str(address).split(","):
        part = part.strip()
        if part:
            out.append(_split_addr(part))
    if not out:
        raise ValueError("no endpoint in address %r" % (address,))
    return out


class CoordClient(object):
    """Request/response client with transparent reconnect AND failover.

    One per (process, host_id). All requests serialize on one socket
    under a lock — the heartbeat thread shares it, so ordering is
    strict and the server never sees interleaved lines. A send/recv
    failure tears the socket down and retries through ``retry_policy``
    (connect + re-send; server ops are idempotent), recording a
    ``transport_reconnect`` event per re-dial so
    ``transport_reconnects_total`` counts real network pain.

    ``address`` may be a LIST of endpoints (a replication group, in
    index order): on socket failure — or on a standby's ``not_primary``
    redirect — the client rotates to the next endpoint inside the same
    retry budget, so a primary SIGKILL costs one failover, not an
    error. Every response's ``term`` is tracked: a response carrying a
    LOWER term than one already observed comes from a stale ex-primary
    and is REFUSED (``transport_stale_primary`` event + rotate) — the
    client-side half of the term fence. Successful endpoint switches
    count in ``transport_failovers_total``; the observed term rides the
    ``transport_term`` gauge.

    ``hb_interval_s`` starts the daemon heartbeat on :meth:`start_heartbeat`
    callers; each beat refreshes this host's liveness lease and records
    the ``transport_hb_lag`` gauge — seconds the cadence is running
    late (0 when healthy). The latest ``lost`` map from any response is
    kept on :attr:`last_lost` for the owner to diff against."""

    def __init__(self, address, host_id=None, retry_policy=None,
                 connect_timeout_s=5.0, io_timeout_s=30.0):
        self._endpoints = _parse_endpoints(address)
        self._ep_i = 0
        self._ep_last_ok = None
        self.host_id = None if host_id is None else int(host_id)
        # the default budget rides out a SUPERVISED RESTART of the
        # rendezvous service (~5-10s of backoff) — and therefore also a
        # standby PROMOTION, which completes within the group's
        # heartbeat deadline — not just a dropped connection; pass a
        # bigger retry_policy for slower orchestrators
        self._policy = retry_policy or RetryPolicy(
            max_attempts=9, base_delay_s=0.1, max_delay_s=2.0)
        self._connect_timeout_s = float(connect_timeout_s)
        # every server op answers immediately (no server-side blocking),
        # so a bounded read is purely a hang guard: a wedged service
        # must not pin the request lock — and with it the heartbeat AND
        # gather threads — forever
        self._io_timeout_s = None if io_timeout_s is None \
            else float(io_timeout_s)
        self._lock = threading.Lock()
        self._sock = None
        self._rfile = None
        self._closed = False
        self._hb_thread = None
        self._hb_stop = threading.Event()
        self.last_lost = {}
        self._lost_cb = None
        # ordering guard for the lost map: responses finish their
        # roundtrip under _lock but are PROCESSED after releasing it,
        # so a slow thread could apply a stale map after a newer one
        # (resurrecting a cleared tombstone). The server versions every
        # map; we only ever apply forward.
        self._lost_lock = threading.Lock()
        self._lost_v = -1
        # the term fence: the highest replication term any response
        # carried. Guarded by _lost_lock (same tiny critical sections).
        self.term_seen = 0
        # instantaneous heartbeat-cadence lag, updated every beat (the
        # recorded gauge EVENTS are throttled — see _hb_loop)
        self.hb_lag_s = 0.0

    @property
    def _addr(self):
        return self._endpoints[self._ep_i]

    # -- wire --------------------------------------------------------------
    def _connect_locked(self):
        sock = socket.create_connection(
            self._addr, timeout=self._connect_timeout_s)
        sock.settimeout(self._io_timeout_s)
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def _teardown_locked(self):
        for closer in (self._rfile, self._sock):
            try:
                if closer is not None:
                    closer.close()
            except OSError:
                pass
        self._sock = self._rfile = None

    def _roundtrip_locked(self, payload):
        if self._sock is None:
            self._connect_locked()
        # chaos surface: a raise here is caught by request()'s socket-
        # error handler (reconnect/rotate/backoff); DROP models a
        # message lost in flight without waiting out the read timeout
        out = faultinject.hit("transport.send", payload,
                              host=self.host_id)
        if out is faultinject.DROP:
            self._teardown_locked()
            raise ConnectionError("transport.send: dropped by failpoint")
        self._sock.sendall(out)
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("coordination service closed the "
                                  "connection")
        return json.loads(line)

    def _rotate_locked(self, hint=None):
        """Advance to the next endpoint (or jump to the ``primary``
        hint a standby handed back). A single-endpoint client only
        reconnects — there is nowhere to fail over to."""
        if hint:
            try:
                hp = _split_addr(hint)
            except (ValueError, TypeError):
                hp = None
            if hp is not None:
                if hp not in self._endpoints:
                    self._endpoints.append(hp)
                self._ep_i = self._endpoints.index(hp)
                return
        if len(self._endpoints) > 1:
            self._ep_i = (self._ep_i + 1) % len(self._endpoints)

    def _screen_response(self, resp):
        """Term fence + failover redirect. Returns None to ACCEPT the
        response, or a ("kind", exception) pair describing why it must
        be retried on another endpoint: kind "stale" (an ex-primary's
        lower term, refused) or "standby" (a not-yet-promoted member's
        redirect — wait and re-probe)."""
        term = resp.get("term")
        if term is not None:
            term = int(term)
            with self._lost_lock:
                seen = self.term_seen
                stale = term < seen
                if term > seen:
                    self.term_seen = term
            if stale:
                # a response from a lower term than one we already
                # observed: a stale ex-primary woke up. Refuse it — the
                # promoted member holds the truth.
                record_event("transport_stale_primary",
                             host=self.host_id, term=term, seen=seen)
                with self._lock:
                    self._teardown_locked()
                    self._rotate_locked()
                return ("stale", ConnectionError(
                    "stale-term response (term %d < observed %d) — "
                    "refused and failing over" % (term, seen)))
            if term > seen:
                record_event("transport_term", host=self.host_id,
                             term=term)
        if resp.get("not_primary"):
            hint = resp.get("primary")
            with self._lock:
                self._teardown_locked()
                self._rotate_locked(hint)
            return ("standby", ConnectionError(
                "endpoint is a standby (term %s) — failing over"
                % resp.get("term")))
        return None

    # a standby's redirect means the group EXISTS but is mid-promotion:
    # the wait is bounded by this wall clock (generous vs any sane
    # hb_deadline_s) at a tight cadence, NOT by the reconnect attempt
    # budget at full backoff — burning attempts against a known-alive
    # group would spend the whole budget before promotion lands
    _STANDBY_WAIT_S = 30.0
    _STANDBY_POLL_S = 0.05

    def request(self, req):
        """One request/response round trip; reconnects, re-sends and
        FAILS OVER across the endpoint list on transient failure
        (requests are idempotent server-side; stale-term responses are
        refused; a mid-promotion group is waited out). Raises
        :class:`TransportError` once the retry budget is spent."""
        payload = json.dumps(req).encode() + b"\n"
        last = None
        attempt = 0
        standby_deadline = None
        while True:
            resp = None
            socket_err = False
            with self._lock:
                if self._closed:
                    raise TransportError("client is closed")
                try:
                    resp = self._roundtrip_locked(payload)
                except (OSError, ValueError) as e:
                    # ValueError: a torn JSON line from a half-closed
                    # socket — same remedy as any socket error
                    last = e
                    socket_err = True
                    self._teardown_locked()
            if resp is not None:
                verdict = self._screen_response(resp)
                if verdict is None:
                    ep = self._ep_i
                    if self._ep_last_ok is not None \
                            and self._ep_last_ok != ep:
                        # the first accepted answer from a NEW endpoint
                        # after talking to another: one failover landed
                        record_event("transport_failover",
                                     host=self.host_id,
                                     endpoint="%s:%d" % self._addr)
                    self._ep_last_ok = ep
                    return resp
                kind, last = verdict
                if kind == "standby":
                    now = time.monotonic()
                    if standby_deadline is None:
                        standby_deadline = now + self._STANDBY_WAIT_S
                    if now >= standby_deadline:
                        break
                    self._policy.sleep(self._STANDBY_POLL_S)
                    continue
            if socket_err and standby_deadline is not None \
                    and time.monotonic() < standby_deadline:
                # a live standby already answered this request: the
                # group EXISTS, we are only waiting out its promotion.
                # A refused connection (the dead ex-primary) must not
                # burn the bounded attempt budget with growing backoff
                # — rotate and keep the tight promotion-wait cadence.
                with self._lock:
                    self._rotate_locked()
                self._policy.sleep(self._STANDBY_POLL_S)
                continue
            attempt += 1
            if attempt >= self._policy.max_attempts:
                break
            delay = self._policy.delay_s(attempt - 1)
            if socket_err:
                with self._lock:
                    self._rotate_locked()
                record_event("transport_reconnect", attempt=attempt,
                             error=type(last).__name__, backoff_s=delay,
                             host=self.host_id)
            self._policy.sleep(delay)
        raise TransportError(
            "coordination service unreachable at %s after %d attempts; "
            "last error: %r"
            % (["%s:%d" % ep for ep in self._endpoints],
               self._policy.max_attempts, last))

    def call(self, cmd, **fields):
        """request() + server-error unwrapping. Returns the response
        dict; a server-side ``error`` raises RuntimeError (the caller
        maps it onto the Coordinator error taxonomy). Tracks the most
        recent ``lost`` map for the owner's loss observation."""
        req = dict(fields, cmd=cmd)
        if self.host_id is not None and "host" not in req:
            req["host"] = self.host_id
        resp = self.request(req)
        if "lost" in resp:
            parsed = {int(k): v for k, v in resp["lost"].items()}
            version = int(resp.get("lost_v", 0))
            with self._lost_lock:
                if version >= self._lost_v:
                    self._lost_v = version
                    self.last_lost = parsed
                # the callback always sees the NEWEST map known to this
                # client (never a stale response's own) AND its version
                # — the consumer re-checks it under ITS lock, because
                # this invocation happens outside ours and a delayed
                # thread could otherwise deliver a pre-unfence map
                # after the owner already readmitted the host
                current = dict(self.last_lost)
                current_v = self._lost_v
            cb = self._lost_cb
            if cb is not None:
                cb(current, current_v)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    # -- heartbeat ---------------------------------------------------------
    def start_heartbeat(self, interval_s=_DEFAULT_HB_INTERVAL_S,
                        on_lost=None):
        """Say hello (registers this host's liveness lease) and start
        the daemon heartbeat. ``on_lost(lost_map)`` fires on every
        response that carries a lost map — the SocketCoordinator hangs
        its loss observation here so tombstones written by the server's
        deadline monitor reach the survivors' hooks without any gather
        in flight."""
        self._lost_cb = on_lost
        self._hb_interval_s = float(interval_s)
        self.call("hello", lease=True)
        t = threading.Thread(target=self._hb_loop, daemon=True,
                             name="paddle_tpu-hb-%s" % self.host_id)
        self._hb_thread = t
        t.start()
        return self

    def _hb_loop(self):
        last_beat = time.monotonic()
        last_recorded = 0.0
        beats = 0
        while not self._hb_stop.wait(self._hb_interval_s):
            try:
                # DROP loses the beat silently; an injected raise is
                # swallowed like any transport failure — either way the
                # server-side lease ages until the deadline monitor
                # declares this host lost
                if faultinject.hit("coordination.hb",
                                   host=self.host_id) is faultinject.DROP:
                    continue
                self.call("hb")
            except (TransportError, RuntimeError, ConnectionError):
                # the reconnect events already counted the pain; the
                # lease simply ages until the server or network heals
                continue
            now = time.monotonic()
            lag = max(0.0, (now - last_beat) - self._hb_interval_s)
            last_beat = now
            self.hb_lag_s = lag
            beats += 1
            # the gauge event is THROTTLED: the event log is a bounded
            # deque shared with the recovery history, and an unthrotted
            # 2 Hz stream would evict everything else within the hour.
            # Record when the cadence actually slipped (the signal) or
            # every ~60s as a keepalive so the gauge stays fresh; the
            # instantaneous value is always on .hb_lag_s.
            keepalive = max(1, int(60.0 / max(self._hb_interval_s,
                                              1e-3)))
            if lag > self._hb_interval_s or lag > last_recorded * 2 \
                    or beats % keepalive == 0:
                last_recorded = lag
                record_event("transport_hb_lag", host=self.host_id,
                             lag_s=lag)

    def close(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        with self._lock:
            self._closed = True
            self._teardown_locked()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# p2p buddy mailbox endpoint (one per host)
# ---------------------------------------------------------------------------

def mailbox_request(address, req, timeout_s=5.0):
    """One-shot newline-JSON request against a peer's MailboxServer.
    Raises ConnectionError on any wire failure — the buddy tier maps
    every raise to its typed fallbacks, never a hang (the socket
    timeout bounds the wait)."""
    try:
        with socket.create_connection(_split_addr(address),
                                      timeout=timeout_s) as s:
            s.settimeout(timeout_s)
            s.sendall(json.dumps(req).encode() + b"\n")
            line = s.makefile("rb").readline()
    except OSError as e:
        raise ConnectionError(
            "mailbox at %s unreachable: %s" % (address, e))
    if not line:
        raise ConnectionError(
            "mailbox at %s closed the connection mid-request"
            % (address,))
    try:
        return json.loads(line)
    except ValueError as e:
        raise ConnectionError(
            "mailbox at %s sent a torn response: %s" % (address, e))


class MailboxServer(object):
    """One host's p2p buddy-mailbox endpoint: a tiny ThreadingTCPServer
    on the CoordServer newline-JSON wire, serving deposits into and
    fetches out of a :class:`buddy.BuddyMailbox` that lives in THIS
    host's RAM. The coordinator never sees a payload — only the
    metadata row the sender commits after the deposit is acked here.

    Ops (one JSON line in, one out):
      mb_deposit {owner, payload}   -> the mailbox's ack/refusal dict
      mb_fetch   {owner}            -> {gen, digest, blob} |
                                       {miss: true} | {refused: ...}
      mb_status  {}                 -> {owners: {o: meta},
                                       resident_bytes}

    ``port=0`` binds an ephemeral port — read :attr:`address` back and
    register it with the coordinator via ``mailbox_hello``."""

    def __init__(self, mailbox, host="127.0.0.1", port=0):
        self.mailbox = mailbox
        self._dead = False
        server_self = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while not server_self._dead:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                        resp = server_self._serve(req)
                    except Exception as e:   # malformed request
                        resp = {"error": "%s: %s"
                                % (type(e).__name__, e)}
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, int(port)), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="paddle-tpu-mailbox", daemon=True)
        self._thread.start()

    @property
    def address(self):
        h, p = self._server.server_address[:2]
        return "%s:%d" % (h, p)

    def _serve(self, req):
        cmd = req.get("cmd")
        if cmd == "mb_deposit":
            return self.mailbox.deposit(int(req["owner"]),
                                        req["payload"])
        if cmd == "mb_fetch":
            try:
                return self.mailbox.reconstruct(int(req["owner"]))
            except LookupError:
                return {"miss": True}
            except Exception as e:
                # chain/digest corruption: a TYPED refusal the fetching
                # side surfaces as snapshot_torn, never a wedged socket
                return {"refused": "%s: %s" % (type(e).__name__, e)}
        if cmd == "mb_status":
            return {"owners": {str(o): m for o, m in
                               (self.mailbox.meta() or {}).items()},
                    "resident_bytes": self.mailbox.resident_bytes()}
        return {"error": "unknown cmd %r" % cmd}

    def close(self):
        if self._dead:
            return
        self._dead = True
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
