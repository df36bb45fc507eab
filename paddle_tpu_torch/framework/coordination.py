"""Pod recovery control plane: agreed restores for multi-host training
(counterpart of paddle_tpu/framework/coordination.py).

Collectives deadlock when a host resumes at another step than its peers,
so a pod's recovery is agreed: every host rewinds to one quorum-validated
checkpoint step, or none does. framework/resilience.py closes the
detect-and-recover loop for one process; this module is the pod half:

  * :class:`Coordinator`: ``barrier`` / ``all_gather`` /
    ``elect_restore_step`` (the max step a scrub validated on every live
    host), the rejoin protocol (``announce_join``, ``admit``, ``join``),
    the buddy tier's mailboxes, and host-loss detection that fires the
    mesh re-init hooks (distributed/mesh.py).
  * :class:`LocalCoordinator`: in-process, on threads: N simulated hosts
    in one process (each with its own Executor, Scope and checkpoint
    dir), the pod the tests and ``chip_smoke.py`` run on one card.
  * :class:`FileCoordinator`: one object per process, agreeing through
    atomically written files in a shared directory (tombstones, round
    files, heartbeat leases).
  * :class:`SocketCoordinator`: one object per process over a TCP
    rendezvous service (framework/transport.py's ``CoordServer``, in
    process or ``python -m paddle_tpu_torch.tools.coordsvc``), with
    heartbeat leases, failover across a replicated server group and a
    per-host buddy mailbox endpoint (``transport.MailboxServer``).
  * :class:`PodResilientTrainer`: N per-host ResilientTrainers; every
    dispatch window ends in a status exchange, and a transient fault on
    any host takes the pod to the agreed buddy restore (at most one
    window lost, no disk read) or else to the consensus disk rewind; the
    restart budget is shared.
  * :class:`ElasticTrainer`: survivors continue at reduced capacity when
    a host drops (``elastic_shrink``) and re-absorb it when it returns
    (``elastic_grow``, its state shipped zlib-compressed); the proactive
    straggler and SDC drains.

On one card every mesh has size 1 (``compiler.check_mesh``), so a
shrink or grow re-targets no mesh and re-shards nothing; the events
still carry their ``capacity``. The elastic pipeline re-cut and per-host
``ShardedFeed`` streams raise NotPortedError (the torch.distributed
slice).
"""
import collections
import threading
import time

from ..ops.registry import NotPortedError
from . import obs
from . import resilience
from .resilience import RestartBudgetExceededError, record_event

__all__ = [
    "CoordinationError", "HostLostError", "BarrierTimeoutError",
    "NoQuorumError", "Coordinator", "LocalCoordinator",
    "FileCoordinator", "SocketCoordinator", "PodResilientTrainer",
    "ElasticTrainer", "agreed_pending",
]

# the fence reason dynamic resize stamps on a GROWN slot: the member
# has never joined, so observers must not treat the tombstone as a
# host LOSS (no loss hooks, no host_lost event, no mesh re-init) —
# it clears through the ordinary announce/admit/join path instead
GROW_FENCE_REASON = "resized: awaiting join"


def agreed_pending(verdicts, idx=1):
    """The admission ``[host, nonce]`` pair EVERY participant of a
    frozen gather observed — the first such pair in the lowest live
    host's ordering, or None. Each verdict's ``idx`` element is that
    host's sorted view of the pending-join set.

    This is the agreement invariant that makes the join barrier
    complete: because it is computed from the same frozen verdicts on
    every host, all of them admit the SAME joiner together. Shared by
    :class:`ElasticTrainer`'s window-boundary admission and the
    serving fleet's control rounds — it must have exactly one
    definition."""
    live = sorted(verdicts)
    for pair in (verdicts[live[0]][idx] if live else []):
        if all(pair in v[idx] for v in verdicts.values()):
            return pair
    return None


class CoordinationError(RuntimeError):
    """A pod-level coordination failure (peer fatal, protocol misuse)."""


class HostLostError(CoordinationError):
    """This host was marked lost (fenced): it missed a barrier or was
    declared dead. A fenced host must NOT keep training — rejoin via the
    orchestrator as a fresh participant instead of split-braining."""


class BarrierTimeoutError(CoordinationError):
    """A collective did not complete in time and loss detection was
    disabled, so nobody was marked lost — the caller decides."""


class NoQuorumError(CoordinationError):
    """No checkpoint step is valid on enough live hosts to restore —
    escalate to the orchestrator (cold start or manual repair)."""


class BlobTooLargeError(CoordinationError):
    """A legacy-mode ``put_blob`` payload exceeded the coordinator's
    ``blob_max_bytes`` ceiling. Named so a misconfigured pod fails
    TYPED (the buddy tier records buddy_send_fail and training keeps
    the disk fallback) instead of silently growing the coordinator
    process until the OOM killer fences the whole control plane. The
    p2p mailbox tier has no such ceiling — payloads live in peer
    host RAM."""


# ---------------------------------------------------------------------------
# coordinator contract + shared consensus logic
# ---------------------------------------------------------------------------

class Coordinator(object):
    """Base contract. Subclasses implement :meth:`all_gather` plus the
    live/lost bookkeeping; everything else (barrier, consensus election,
    host-loss hook fan-out) is shared.

    Host-loss semantics: when a collective times out, the hosts that
    never arrived are marked LOST (``detect_loss=True``), the remaining
    values are returned to the survivors, and the loss hooks fire —
    including mesh re-initialization (``distributed.mesh
    .handle_host_loss``) so the survivors' collectives are rebuilt
    without the dead host. A lost host that later calls in gets
    :class:`HostLostError` (fencing: it must rejoin, not resume).
    """

    def __init__(self, n_hosts, timeout_s=30.0, detect_loss=True,
                 mesh_reinit=True):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.n_hosts = int(n_hosts)
        self.timeout_s = float(timeout_s)
        self.detect_loss = bool(detect_loss)
        self._mesh_reinit = bool(mesh_reinit)
        self._loss_hooks = []
        self._join_hooks = []
        # admissions THIS object already reacted to: LocalCoordinator is
        # shared by every simulated host, so the mesh re-grows once; a
        # FileCoordinator is per-process, so every process re-grows its
        # own mesh — same guard, right semantics in both topologies
        self._absorbed = set()
        self._absorb_lock = threading.Lock()
        # buddy-snapshot mailboxes, default in-memory store (Local
        # shares ONE coordinator object across simulated hosts, so the
        # store is naturally pod-wide; File is per-process, so a dead
        # host's mailbox is simply absent there and restores fall back
        # to disk). SocketCoordinator keeps them on its CoordServer
        # instead.
        self._blobs = {}
        self._blob_lock = threading.Lock()
        # legacy put_blob payload ceiling (None = unbounded, the
        # in-process default; CoordServer enforces its own finite one)
        self.blob_max_bytes = None
        # p2p buddy tier: per-host BuddyMailbox registry + the
        # {owner: (gen, buddy, digest, nbytes)} metadata table. Same
        # topology note as _blobs — Local's shared object makes the
        # registry pod-wide (deposits really land in "the other
        # host's" mailbox), File's per-process registry degrades every
        # restore to buddy_missing. (SocketCoordinator runs a per-host
        # MailboxServer endpoint instead.)
        self._mailboxes = {}
        self._buddy_meta = {}
        self._mailbox_lock = threading.Lock()

    # -- subclass surface --------------------------------------------------
    def all_gather(self, name, host_id, value=None, timeout_s=None):
        """Collective: every live host contributes ``value`` under the
        (round-unique) ``name``; returns {host_id: value} of the live
        participants. Blocks until all live hosts arrive or the timeout
        handles the missing ones (see class docstring)."""
        raise NotImplementedError

    def live_hosts(self):
        raise NotImplementedError

    def lost_hosts(self):
        """{host_id: reason} of every host marked lost so far."""
        raise NotImplementedError

    def mark_lost(self, host_id, reason="declared lost"):
        raise NotImplementedError

    def announce_join(self, host_id, nonce):
        """A FENCED host announces it wants back in. ``nonce`` is the
        host's rejoin-attempt counter — it namespaces the admission
        round so the same host can rejoin repeatedly. Raises
        CoordinationError for a host that is not fenced (a live host
        has nothing to rejoin)."""
        raise NotImplementedError

    def pending_joins(self):
        """{host_id: nonce} of fenced hosts waiting for admission."""
        raise NotImplementedError

    def unfence(self, host_id):
        """Clear ``host_id``'s tombstone and join request (idempotent).
        Only the admission path may call this — un-fencing a host that
        did not go through :meth:`admit`/:meth:`join` recreates exactly
        the split brain fencing exists to prevent."""
        raise NotImplementedError

    def resize(self, n_hosts):
        """DYNAMIC GROUP RESIZE: change the group size at a round
        boundary. Grown slots are born FENCED ("resized: awaiting
        join") so no in-flight gather ever waits for a member that has
        not joined — the new member's start finds itself fenced and
        takes the ordinary announce/admit/join path. A shrink only
        removes TOP ids that are already fenced (drain first); raises
        :class:`CoordinationError` for the protocol's named refusals
        (a mid-round call, a live id in the shrink range) and
        ``ValueError`` for n_hosts < 1. Returns the new size."""
        raise NotImplementedError

    @staticmethod
    def _check_resize(n_hosts, current, open_rounds, live_in_range):
        """Shared resize validation; returns the int size to adopt."""
        n = int(n_hosts)
        if n < 1:
            raise ValueError("resize: n_hosts must be >= 1, got %d" % n)
        if open_rounds:
            raise CoordinationError(
                "resize refused mid-round: gather round(s) %s in "
                "flight — retry at a round boundary"
                % sorted(open_rounds)[:3])
        if n < current and live_in_range:
            raise CoordinationError(
                "resize refused: host(s) %s still live — drain/fence "
                "them before shrinking past their ids"
                % sorted(live_in_range))
        return n

    # -- shared machinery --------------------------------------------------
    def add_host_loss_hook(self, fn):
        """Register ``fn(lost_ids, live_ids)`` to run on host loss (after
        the built-in mesh re-init). Returns fn for decorator use."""
        self._loss_hooks.append(fn)
        return fn

    def add_host_join_hook(self, fn):
        """Register ``fn(joined_ids, live_ids)`` to run when a host is
        re-absorbed (after the built-in mesh re-grow). Returns fn."""
        self._join_hooks.append(fn)
        return fn

    def admit(self, host_id, joined, nonce, value, name="join",
              timeout_s=None, enact=True, poll_s=0.01):
        """Survivor half of the rejoin protocol.

        Every SURVIVOR calls this in the same window (the pending-join
        set must be agreed out of band — ElasticTrainer rides it on the
        window status exchange, so all hosts compute the same admission
        deterministically). It un-fences ``joined`` (idempotent across
        survivors), then meets the joiner on the admission barrier,
        contributing ``value`` — the survivor's sync coordinates (step
        counter etc.); the joiner contributes None and adopts the max.
        After the barrier the mesh re-absorbs the host
        (:func:`distributed.mesh.absorb_hosts`) and join hooks fire.

        ``enact=False`` is the FOLLOWER half of leader-based admission
        (the serving fleet's router tier): the caller meets the
        admission barrier but does NOT un-fence — it waits (bounded by
        the timeout) for the admission LEADER's un-fence to land
        first, so the barrier can never freeze without the joiner.
        Returns None when the leader never enacted in time.

        Returns the agreed sync value, or None when the joiner died
        between announcing and the barrier (it is re-fenced by the
        barrier timeout and the admission is abandoned)."""
        with obs.span("coord.admit", joined=joined, host=host_id,
                      enact=bool(enact)):
            return self._admit_traced(host_id, joined, nonce, value,
                                      name, timeout_s, enact, poll_s)

    def _admit_traced(self, host_id, joined, nonce, value, name,
                      timeout_s, enact, poll_s):
        if enact:
            self.unfence(joined)
        else:
            deadline = time.monotonic() + (
                self.timeout_s if timeout_s is None
                else float(timeout_s))
            while joined in self.lost_hosts():
                if time.monotonic() >= deadline:
                    record_event("join_abort", host=joined, nonce=nonce,
                                 reason="admission leader never "
                                 "enacted")
                    return None
                time.sleep(poll_s)
        round_name = "%s:h%d:n%d" % (name, joined, nonce)
        got = self.all_gather(round_name, host_id, value,
                              timeout_s=timeout_s)
        if joined not in got:
            record_event("join_abort", host=joined, nonce=nonce)
            return None
        sync = max(v for v in got.values() if v is not None)
        self._on_join([joined], nonce, sync)
        return sync

    def join(self, host_id, nonce, name="join", timeout_s=None,
             poll_s=0.01):
        """Joiner half: after :meth:`announce_join`, block until the
        survivors un-fence this host, then meet the admission barrier.
        Returns the survivors' agreed sync value. Raises
        BarrierTimeoutError when no admission lands in time (the host
        stays fenced — escalate to the orchestrator)."""
        with obs.span("coord.join", host=host_id):
            deadline = time.monotonic() + (
                self.timeout_s if timeout_s is None
                else float(timeout_s))
            while host_id in self.lost_hosts():
                if time.monotonic() >= deadline:
                    raise BarrierTimeoutError(
                        "host %d announced a rejoin but was not "
                        "admitted in time — survivors may be "
                        "mid-recovery or gone" % host_id)
                time.sleep(poll_s)
            round_name = "%s:h%d:n%d" % (name, host_id, nonce)
            got = self.all_gather(round_name, host_id, None,
                                  timeout_s=timeout_s)
            values = [v for v in got.values() if v is not None]
            if not values:
                raise CoordinationError(
                    "admission round %r carried no sync value from "
                    "any survivor" % round_name)
            sync = max(values)
            self._on_join([host_id], nonce, sync)
            return sync

    def _on_join(self, joined, nonce, sync):
        """Fan out an admission exactly once per coordinator object:
        resilience event, mesh re-grow, join hooks."""
        key = (tuple(joined), int(nonce))
        with self._absorb_lock:
            if key in self._absorbed:
                return
            self._absorbed.add(key)
        live = self.live_hosts()
        record_event("host_join", hosts=sorted(joined), live=list(live),
                     sync=sync)
        if self._mesh_reinit:
            from ..distributed import mesh as mesh_mod
            mesh_mod.absorb_hosts(sorted(joined), live)
        for fn in list(self._join_hooks):
            fn(sorted(joined), live)

    def barrier(self, name, host_id, timeout_s=None):
        """Block until every live host reaches the same ``name``;
        returns the sorted ids that arrived."""
        got = self.all_gather("barrier:%s" % name, host_id,
                              timeout_s=timeout_s)
        return sorted(got)

    def elect_restore_step(self, host_id, valid_steps, name="elect",
                           quorum=None, timeout_s=None):
        """Consensus restore step for the whole pod.

        Every live host contributes the steps its checkpoint scrub
        validated (``io.scrub_checkpoint(dir)["valid_steps"]``); the
        consensus is the MAX step reported by at least ``quorum`` live
        hosts — default ALL of them, because with per-host checkpoint
        dirs every host must hold the step it is told to restore. On a
        shared filesystem (one dir scrubbed by everyone) a smaller
        quorum tolerates scrub-time races. Deterministic: every host
        computes the same answer from the same gathered sets.

        Raises :class:`NoQuorumError` when no step qualifies."""
        got = self.all_gather("elect:%s" % name, host_id,
                              sorted(int(s) for s in set(valid_steps)),
                              timeout_s=timeout_s)
        counts = collections.Counter(
            s for steps in got.values() for s in steps)
        need = len(got) if quorum is None else min(int(quorum), len(got))
        eligible = [s for s, c in counts.items() if c >= need]
        if not eligible:
            raise NoQuorumError(
                "no checkpoint step is valid on %d/%d live hosts "
                "(reported: %s) — nothing the pod can agree to restore"
                % (need, len(got),
                   {h: list(v) for h, v in sorted(got.items())}))
        step = max(eligible)
        record_event("consensus", step=step, hosts=len(got),
                     quorum=need)
        return step

    # -- buddy-snapshot mailboxes (framework/buddy.py rides these) --------
    def put_blob(self, host_id, gen, buddy, blob, reset=False):
        """Store ``host_id``'s buddy snapshot. ONE generation is kept
        per owner (bounded memory): a higher ``gen`` overwrites in
        place, the same ``gen`` is an idempotent re-send, and a LOWER
        one raises CoordinationError — a delayed put must never rewind
        the mailbox below what a restore may already have adopted.
        ``reset=True`` force-overwrites regardless of generation: the
        post-disk-restore re-seed, where the pod legitimately rewound
        below the mailbox gen (and a poison-batch replay may change
        the trajectory, making even an equal-gen blob stale)."""
        gen, owner = int(gen), int(host_id)
        if owner in self.lost_hosts():
            raise HostLostError(
                "host %d is fenced — a fenced host must not publish "
                "buddy snapshots" % owner)
        if self.blob_max_bytes is not None:
            nb = len(blob.get("npz", "")) if isinstance(blob, dict) \
                else (0 if blob is None else len(str(blob)))
            if nb > self.blob_max_bytes:
                raise BlobTooLargeError(
                    "put_blob of %d bytes for host %d exceeds the "
                    "coordinator's blob_max_bytes=%d ceiling — use "
                    "the p2p mailbox tier for scopes this size"
                    % (nb, owner, self.blob_max_bytes))
        with self._blob_lock:
            prev = self._blobs.get(owner)
            if reset:
                self._blobs[owner] = {"gen": gen, "buddy": int(buddy),
                                      "blob": blob}
                return
            if prev is not None and gen < prev["gen"]:
                raise CoordinationError(
                    "put_blob generation rewind: host %d is at gen %d, "
                    "refused gen %d" % (owner, prev["gen"], gen))
            if prev is None or gen > prev["gen"]:
                self._blobs[owner] = {"gen": gen, "buddy": int(buddy),
                                      "blob": blob}

    def get_blob(self, owner, meta_only=False):
        """Fetch ``owner``'s buddy snapshot record
        ``{"gen", "buddy"[, "blob"]}`` or None when no mailbox exists
        (``meta_only=True`` skips the payload — the restore election
        polls generations cheaply). Read-only and unfenced: a fenced
        survivor reading its own last snapshot IS the restore path."""
        with self._blob_lock:
            rec = self._blobs.get(int(owner))
            if rec is None:
                return None
            out = {"gen": rec["gen"], "buddy": rec["buddy"]}
            if not meta_only:
                out["blob"] = rec["blob"]
            return out

    # -- p2p buddy mailboxes + metadata table -----------------------------
    def mailbox_of(self, host_id):
        """``host_id``'s :class:`buddy.BuddyMailbox`, created on first
        touch. In the base (in-process) plane the registry is shared
        by every host the coordinator object serves."""
        from . import buddy as buddy_mod
        hid = int(host_id)
        with self._mailbox_lock:
            mb = self._mailboxes.get(hid)
            if mb is None:
                mb = self._mailboxes[hid] = \
                    buddy_mod.BuddyMailbox(host_id=hid)
            return mb

    def mailbox_send(self, owner, at, payload):
        """Deposit ``owner``'s payload into host ``at``'s mailbox and
        return the mailbox's ack/refusal dict. ``at == owner`` is the
        free local self-deposit; anything else models the p2p stream
        (a real one over MailboxServer in the socket plane)."""
        return self.mailbox_of(at).deposit(owner, payload)

    def mailbox_fetch(self, owner, at):
        """Reconstruct ``owner``'s resident generation out of host
        ``at``'s mailbox: ``{"gen", "digest", "blob"}``, or None when
        the mailbox/slot is absent. Raises on chain/digest corruption
        — the buddy tier maps every raise to ``snapshot_torn``."""
        with self._mailbox_lock:
            mb = self._mailboxes.get(int(at))
        if mb is None:
            return None
        try:
            return mb.reconstruct(owner)
        except LookupError:
            return None

    def put_buddy_meta(self, host_id, gen, buddy, digest, nbytes,
                       reset=False):
        """Commit ``host_id``'s metadata row ``{gen, buddy, digest,
        nbytes}`` — called ONLY after the buddy's mailbox acked the
        deposit (ack-before-commit). Same generation fence and reset
        bypass as :meth:`put_blob`, but metadata-sized."""
        gen, owner = int(gen), int(host_id)
        if owner in self.lost_hosts():
            raise HostLostError(
                "host %d is fenced — a fenced host must not publish "
                "buddy metadata" % owner)
        row = {"gen": gen, "buddy": int(buddy), "digest": digest,
               "nbytes": int(nbytes)}
        with self._mailbox_lock:
            prev = self._buddy_meta.get(owner)
            if reset:
                self._buddy_meta[owner] = row
                return
            if prev is not None and gen < prev["gen"]:
                raise CoordinationError(
                    "put_buddy_meta generation rewind: host %d is at "
                    "gen %d, refused gen %d" % (owner, prev["gen"],
                                                gen))
            if prev is None or gen > prev["gen"]:
                self._buddy_meta[owner] = row

    def buddy_meta(self, owner):
        """``owner``'s committed metadata row (a copy) or None.
        Read-only and unfenced, same reasoning as :meth:`get_blob`."""
        with self._mailbox_lock:
            rec = self._buddy_meta.get(int(owner))
            return None if rec is None else dict(rec)

    def _evict_orphan_blobs(self):
        """Drop mailboxes whose owner AND recorded buddy are both lost
        (the physical bytes lived in the buddy's RAM — a double
        failure loses them)."""
        lost = set(self.lost_hosts())
        with self._blob_lock:
            for o in [o for o, rec in self._blobs.items()
                      if o in lost and rec["buddy"] in lost]:
                del self._blobs[o]
        with self._mailbox_lock:
            for o in [o for o, rec in self._buddy_meta.items()
                      if o in lost and rec["buddy"] in lost]:
                del self._buddy_meta[o]

    def _on_loss(self, newly_lost):
        """Fan out a host-loss: resilience event, mesh re-init, hooks."""
        if not newly_lost:
            return
        self._evict_orphan_blobs()
        live = self.live_hosts()
        record_event("host_lost", hosts=sorted(newly_lost),
                     live=list(live))
        if self._mesh_reinit:
            from ..distributed import mesh as mesh_mod
            mesh_mod.handle_host_loss(sorted(self.lost_hosts()), live)
        for fn in list(self._loss_hooks):
            fn(sorted(newly_lost), live)


# ---------------------------------------------------------------------------
# in-process (threaded) coordinator
# ---------------------------------------------------------------------------

class LocalCoordinator(Coordinator):
    """Thread-based coordinator: N logical hosts in one process.

    This is the tier-1 test vehicle — it runs the exact consensus and
    fencing logic of the pod control plane with no processes, sockets or
    real TPUs, which is how the chaos battery stays fast and
    deterministic."""

    def __init__(self, n_hosts, timeout_s=30.0, detect_loss=True,
                 mesh_reinit=True):
        super(LocalCoordinator, self).__init__(
            n_hosts, timeout_s=timeout_s, detect_loss=detect_loss,
            mesh_reinit=mesh_reinit)
        self._cond = threading.Condition()
        self._lost = {}
        self._joins = {}    # host_id -> nonce (fenced hosts asking back)
        self._rounds = {}   # name -> {"values": {hid: v}, "exits": int}

    def live_hosts(self):
        with self._cond:
            return [i for i in range(self.n_hosts) if i not in self._lost]

    def lost_hosts(self):
        with self._cond:
            return dict(self._lost)

    def mark_lost(self, host_id, reason="declared lost"):
        with self._cond:
            if host_id in self._lost:
                return
            self._lost[host_id] = reason
            self._cond.notify_all()
        self._on_loss([host_id])

    def announce_join(self, host_id, nonce):
        with self._cond:
            if host_id not in self._lost:
                raise CoordinationError(
                    "host %d is not fenced — only a lost host announces "
                    "a rejoin" % host_id)
            self._joins[host_id] = int(nonce)
            self._cond.notify_all()

    def pending_joins(self):
        with self._cond:
            return dict(self._joins)

    def unfence(self, host_id):
        with self._cond:
            self._lost.pop(host_id, None)
            self._joins.pop(host_id, None)
            self._cond.notify_all()

    def resize(self, n_hosts):
        with self._cond:
            open_rounds = [name for name, r in self._rounds.items()
                           if r["result"] is None]
            live = [] if int(n_hosts) >= self.n_hosts else \
                [h for h in range(int(n_hosts), self.n_hosts)
                 if h not in self._lost]
            n = self._check_resize(n_hosts, self.n_hosts, open_rounds,
                                   live)
            if n == self.n_hosts:
                return n
            if n < self.n_hosts:
                for h in range(n, self.n_hosts):
                    self._lost.pop(h, None)
                    self._joins.pop(h, None)
            else:
                for h in range(self.n_hosts, n):
                    self._lost[h] = GROW_FENCE_REASON
            self.n_hosts = n
            self._cond.notify_all()
        record_event("group_resize", n_hosts=n)
        return n

    def all_gather(self, name, host_id, value=None, timeout_s=None):
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None
                                       else float(timeout_s))
        newly_lost = []
        with self._cond:
            if host_id in self._lost:
                raise HostLostError(
                    "host %d is fenced (%s) — rejoin, don't resume"
                    % (host_id, self._lost[host_id]))
            r = self._rounds.setdefault(name, {"values": {}, "exits": 0,
                                               "result": None})
            if host_id in r["values"]:
                raise CoordinationError(
                    "host %d already contributed to round %r — collective "
                    "names must be unique per round" % (host_id, name))
            r["values"][host_id] = value
            self._cond.notify_all()
            while True:
                # completion is STICKY: the first host to see the round
                # complete freezes the result for everyone. Without it,
                # a fast peer can exit, enter the admission path and
                # UN-FENCE the joiner while we are still blocked here —
                # recomputing membership would then add the joiner to
                # waiting_for and wedge this round forever (the joiner
                # is already in the admission round, not this one).
                if r["result"] is not None:
                    break
                waiting_for = [i for i in range(self.n_hosts)
                               if i not in self._lost
                               and i not in r["values"]]
                if not waiting_for:
                    r["result"] = {i: v for i, v in r["values"].items()
                                   if i not in self._lost}
                    self._cond.notify_all()
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if not self.detect_loss:
                        raise BarrierTimeoutError(
                            "round %r timed out waiting for hosts %s"
                            % (name, waiting_for))
                    for i in waiting_for:
                        self._lost[i] = "missed round %r" % name
                        newly_lost.append(i)
                    self._cond.notify_all()
                    continue
                self._cond.wait(remaining)
            # every participant returns the SAME frozen snapshot — the
            # protocol's "identical verdicts on every host" assumption
            # holds even when membership changes mid-exit
            result = dict(r["result"])
            # exit accounting BEFORE the fence check: a host fenced
            # between the freeze and its exit still leaves the round,
            # otherwise the entry (and its gathered payloads) would
            # leak forever — exits could never reach len(result)
            r["exits"] += 1
            if r["exits"] >= len(result):
                self._rounds.pop(name, None)   # last one out cleans up
            if host_id in self._lost:
                # marked lost while blocked in this very round: fence
                raise HostLostError(
                    "host %d is fenced (%s) — rejoin, don't resume"
                    % (host_id, self._lost[host_id]))
        # hooks run OUTSIDE the lock: mesh re-init is arbitrary user code
        self._on_loss(newly_lost)
        return result


# ---------------------------------------------------------------------------
# file-based coordinator (multi-process pods on a shared filesystem)
# ---------------------------------------------------------------------------

class FileCoordinator(Coordinator):
    """Coordinator over a shared directory — one object per PROCESS.

    All state flows through atomically-committed files (io._atomic_write
    discipline: temp file + os.replace), so N processes that share only
    a filesystem agree exactly like LocalCoordinator's threads:

        <root>/lost/host_<i>              tombstone (fence), reason text
        <root>/rounds/<name>/host_<i>.json   one contribution per round
        <root>/hb/hb_<i>.json             heartbeat (liveness lease)

    Polling (``poll_s``) replaces condition variables, backing off
    exponentially up to ``poll_max_s`` so a long barrier does not spin
    the filesystem at 100 Hz per host; round names must
    be unique per live round exactly as with LocalCoordinator
    (PodResilientTrainer namespaces every round by a per-run counter).
    The last host to read a completed round removes its directory, so
    the rounds dir stays bounded over a long job. A RESTARTED process
    must rejoin on a fresh coordinator root as a new participant — its
    old incarnation is fenced, and replaying old round names against a
    stale root would read stale contributions.

    ``hb_deadline_s`` arms heartbeat liveness (SocketCoordinator
    parity): every host touches ``hb/hb_<i>.json`` on each gather poll,
    and any host whose heartbeat file goes stale past the deadline is
    auto-tombstoned by whichever peer notices first — declared-loss-only
    detection stops being a FileCoordinator quirk. A host with NO
    heartbeat file is never auto-fenced (it may not have started; the
    gather deadline still covers it), and the deadline must exceed the
    longest stretch a healthy host computes between gathers (the
    dispatch window), since hosts only heartbeat while polling.
    Staleness compares the scanner's wall clock against the heartbeat
    file's mtime, which on a shared mount is stamped by the WRITER (or
    the NFS server): size ``hb_deadline_s`` to absorb the pod's worst
    cross-host clock skew plus the mount's attribute-cache lag, or
    healthy hosts will be fenced spuriously. (SocketCoordinator has no
    such bound — its ages live on one clock, the server's.)"""

    def __init__(self, root, n_hosts, timeout_s=30.0, poll_s=0.01,
                 detect_loss=True, mesh_reinit=True, poll_max_s=0.25,
                 hb_deadline_s=None):
        super(FileCoordinator, self).__init__(
            n_hosts, timeout_s=timeout_s, detect_loss=detect_loss,
            mesh_reinit=mesh_reinit)
        import os
        self._root = root
        self._lost_dir = os.path.join(root, "lost")
        self._rounds_dir = os.path.join(root, "rounds")
        self._join_dir = os.path.join(root, "joins")
        self._hb_dir = os.path.join(root, "hb")
        self.poll_s = float(poll_s)
        self.poll_max_s = max(self.poll_s, float(poll_max_s))
        self.hb_deadline_s = None if hb_deadline_s is None \
            else float(hb_deadline_s)
        if self.hb_deadline_s is not None:
            # a host only touches its heartbeat between poll sleeps, so
            # the backoff cap must sit well inside the deadline — at or
            # past it, a healthy host mid-sleep looks stale and a peer
            # fences it spuriously
            if self.poll_s * 4.0 > self.hb_deadline_s:
                raise ValueError(
                    "hb_deadline_s=%g is too tight for poll_s=%g: a "
                    "healthy host's heartbeat legitimately ages one "
                    "poll interval between touches" %
                    (self.hb_deadline_s, self.poll_s))
            self.poll_max_s = min(self.poll_max_s,
                                  self.hb_deadline_s / 4.0)
        # per-PROCESS loss knowledge: tombstones written by peers must
        # fire THIS process's _on_loss (mesh re-init is per-process
        # state) exactly once, whoever won the race to write them
        self._known_lost = set()
        self._last_hb_scan = 0.0
        os.makedirs(self._lost_dir, exist_ok=True)
        os.makedirs(self._rounds_dir, exist_ok=True)
        os.makedirs(self._join_dir, exist_ok=True)
        os.makedirs(self._hb_dir, exist_ok=True)

    @staticmethod
    def _safe(name):
        return "".join(c if (c.isalnum() or c in "._-") else "_"
                       for c in name)

    def lost_hosts(self):
        import os
        out = {}
        for f in os.listdir(self._lost_dir):
            if f.startswith("host_"):
                try:
                    with open(os.path.join(self._lost_dir, f)) as fh:
                        out[int(f[5:])] = fh.read().strip()
                except (OSError, ValueError):   # pragma: no cover - race
                    continue
        return out

    def live_hosts(self):
        self._refresh_size()
        lost = self.lost_hosts()
        return [i for i in range(self.n_hosts) if i not in lost]

    def mark_lost(self, host_id, reason="declared lost"):
        import os
        from ..io import _write_text as _atomic_write
        if host_id in self.lost_hosts():
            return
        _atomic_write(os.path.join(self._lost_dir, "host_%d" % host_id),
                      reason)
        self._known_lost.add(host_id)
        self._on_loss([host_id])

    def announce_join(self, host_id, nonce):
        import os
        from ..io import _write_text as _atomic_write
        if host_id not in self.lost_hosts():
            raise CoordinationError(
                "host %d is not fenced — only a lost host announces a "
                "rejoin" % host_id)
        _atomic_write(os.path.join(self._join_dir, "host_%d" % host_id),
                      str(int(nonce)))

    def pending_joins(self):
        import os
        out = {}
        for f in os.listdir(self._join_dir):
            if f.startswith("host_"):
                try:
                    with open(os.path.join(self._join_dir, f)) as fh:
                        out[int(f[5:])] = int(fh.read().strip())
                except (OSError, ValueError):  # pragma: no cover - race
                    continue
        return out

    def unfence(self, host_id):
        import os
        for d in (self._lost_dir, self._join_dir):
            try:
                os.unlink(os.path.join(d, "host_%d" % host_id))
            except OSError:   # peer already removed it — idempotent
                pass
        # a future re-loss of this host must re-fire _on_loss here
        self._known_lost.discard(host_id)

    def _refresh_size(self):
        """Adopt a peer's resize: the size record is the one piece of
        FileCoordinator state every process re-reads (poll-time), since
        n_hosts otherwise lives only in each object."""
        import json
        import os
        try:
            with open(os.path.join(self._root, "size.json")) as fh:
                n = int(json.load(fh)["n_hosts"])
        except (OSError, ValueError, KeyError):
            return
        if n != self.n_hosts:
            self.n_hosts = n
            record_event("group_resize", n_hosts=n, adopted=True)

    def resize(self, n_hosts):
        import json
        import os
        from ..io import _write_text as _atomic_write
        self._refresh_size()
        open_rounds = [
            d for d in os.listdir(self._rounds_dir)
            if os.path.isdir(os.path.join(self._rounds_dir, d))
            and not os.path.exists(os.path.join(self._rounds_dir, d,
                                                "_done.json"))]
        lost = self.lost_hosts()
        live = [] if int(n_hosts) >= self.n_hosts else \
            [h for h in range(int(n_hosts), self.n_hosts)
             if h not in lost]
        n = self._check_resize(n_hosts, self.n_hosts, open_rounds, live)
        if n == self.n_hosts:
            return n
        if n < self.n_hosts:
            for h in range(n, self.n_hosts):
                self.unfence(h)
                try:
                    os.unlink(os.path.join(self._hb_dir,
                                           "hb_%d.json" % h))
                except OSError:
                    pass
        else:
            for h in range(self.n_hosts, n):
                _atomic_write(os.path.join(self._lost_dir,
                                           "host_%d" % h),
                              GROW_FENCE_REASON)
        _atomic_write(os.path.join(self._root, "size.json"),
                      json.dumps({"n_hosts": n}))
        self.n_hosts = n
        record_event("group_resize", n_hosts=n)
        return n

    def _touch_hb(self, host_id):
        """Refresh this host's liveness lease (no-op unless armed)."""
        if self.hb_deadline_s is None:
            return
        import os
        from ..io import _write_text as _atomic_write
        _atomic_write(os.path.join(self._hb_dir, "hb_%d.json" % host_id),
                      '{"t": %r}' % time.time())

    def _scan_heartbeats(self, lost):
        """Tombstone every un-fenced host whose heartbeat file went
        stale past the deadline; returns the (possibly updated) lost
        map so the caller's poll iteration needs no second lost-dir
        listing. Scans are THROTTLED to ~deadline/4 — stating N
        heartbeat files on every poll tick would be exactly the
        filesystem spin the backoff exists to cool. First tombstone
        wins (atomic-write parity with the gather-timeout path); the
        regular newly-observed machinery fires the loss hooks."""
        if self.hb_deadline_s is None:
            return lost
        import os
        from ..io import _write_text as _atomic_write
        now = time.time()
        if now - self._last_hb_scan < self.hb_deadline_s / 4.0:
            return lost
        self._last_hb_scan = now
        lost = dict(lost)
        for f in os.listdir(self._hb_dir):
            if not f.startswith("hb_"):
                continue
            try:
                hid = int(f[3:].split(".", 1)[0])
            except ValueError:    # pragma: no cover - foreign file
                continue
            if hid in lost or hid >= self.n_hosts:
                continue
            try:
                age = now - os.stat(os.path.join(self._hb_dir,
                                                 f)).st_mtime
            except OSError:       # pragma: no cover - peer mid-replace
                continue
            if age > self.hb_deadline_s:
                reason = ("missed heartbeat (%.2fs > %.2fs)"
                          % (age, self.hb_deadline_s))
                _atomic_write(
                    os.path.join(self._lost_dir, "host_%d" % hid),
                    reason)
                lost[hid] = reason
        return lost

    def all_gather(self, name, host_id, value=None, timeout_s=None):
        import json
        import os
        from ..io import _write_text as _atomic_write
        self._refresh_size()
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None
                                       else float(timeout_s))
        rd = os.path.join(self._rounds_dir, self._safe(name))
        os.makedirs(rd, exist_ok=True)
        lost = self.lost_hosts()
        if host_id in lost:
            raise HostLostError(
                "host %d is fenced (%s) — rejoin, don't resume"
                % (host_id, lost[host_id]))
        mine = os.path.join(rd, "host_%d.json" % host_id)
        if os.path.exists(mine):
            # same split-brain guard as LocalCoordinator: never let an
            # imposter (or a replayed round name) overwrite a live value
            raise CoordinationError(
                "host %d already contributed to round %r — collective "
                "names must be unique per round" % (host_id, name))
        _atomic_write(mine, json.dumps({"value": value}))
        done_path = os.path.join(rd, "_done.json")
        self._touch_hb(host_id)
        sleep_s = self.poll_s
        while True:
            # completion is STICKY (LocalCoordinator parity): the first
            # process to see every live host present freezes the member
            # snapshot in _done.json. Without it, a fast peer can exit
            # and un-fence a rejoining host while we are still polling
            # — recomputing membership would add the joiner to
            # waiting_for and wedge this round forever.
            if os.path.exists(done_path):
                try:
                    with open(done_path) as fh:
                        members = json.load(fh)
                    break
                except (OSError, ValueError):  # pragma: no cover - race
                    pass    # mid-replace glimpse: poll again
            self._touch_hb(host_id)
            lost = self._scan_heartbeats(self.lost_hosts())
            if host_id in lost:
                # fenced while polling: stop competing NOW. Also load-
                # bearing for cleanup: the frozen member set excludes
                # us, so once every member acks, the round dir is
                # removed under our feet — without this check the
                # listdir below would crash instead of fencing
                raise HostLostError(
                    "host %d is fenced (%s) — rejoin, don't resume"
                    % (host_id, lost[host_id]))
            try:
                present = {int(f[5:-5]) for f in os.listdir(rd)
                           if f.startswith("host_")
                           and f.endswith(".json")}
            except OSError:
                # the members finished and removed the round dir in the
                # window since the fence check — the next iteration's
                # check raises the HostLostError (deadline-bounded so a
                # filesystem anomaly can never spin forever)
                if time.monotonic() >= deadline:
                    raise BarrierTimeoutError(
                        "round %r directory vanished and host %d was "
                        "never fenced" % (name, host_id))
                time.sleep(self.poll_s)
                continue
            waiting_for = [i for i in range(self.n_hosts)
                           if i not in lost and i not in present]
            if not waiting_for:
                # claim the freeze atomically: hard-link of a complete
                # temp file, so the FIRST freezer wins outright and no
                # reader ever sees a partial or second snapshot (two
                # hosts with divergent lost views must not freeze
                # different member sets). Loop back to read the
                # canonical file — even the winner re-reads it.
                import tempfile
                fd, tmp = tempfile.mkstemp(dir=rd, suffix=".tmp")
                try:
                    with os.fdopen(fd, "w") as fh:
                        fh.write(json.dumps(sorted(present - set(lost))))
                    try:
                        os.link(tmp, done_path)
                    except OSError:     # a peer froze first — use theirs
                        pass
                finally:
                    os.unlink(tmp)
                continue
            if time.monotonic() >= deadline:
                if not self.detect_loss:
                    raise BarrierTimeoutError(
                        "round %r timed out waiting for hosts %s"
                        % (name, waiting_for))
                for i in waiting_for:
                    # first tombstone wins; duplicates are idempotent —
                    # _on_loss firing is keyed on _known_lost below, so
                    # losing this race still re-inits OUR mesh
                    if i not in self.lost_hosts():
                        _atomic_write(
                            os.path.join(self._lost_dir, "host_%d" % i),
                            "missed round %r" % name)
                continue
            # exponential backoff from poll_s up to poll_max_s (clamped
            # to the remaining deadline): a long barrier idles at a few
            # Hz instead of hammering the filesystem at 1/poll_s
            time.sleep(min(sleep_s,
                           max(0.0, deadline - time.monotonic())))
            sleep_s = min(sleep_s * 2.0, self.poll_max_s)
        lost = self.lost_hosts()
        if host_id in lost:
            raise HostLostError(
                "host %d is fenced (%s) — rejoin, don't resume"
                % (host_id, lost[host_id]))
        result = {}
        for i in members:
            with open(os.path.join(rd, "host_%d.json" % i)) as fh:
                result[i] = json.load(fh)["value"]
        # last one out cleans up (LocalCoordinator parity): every value
        # is written before any ack, and removal needs every reader's
        # ack — so nobody can lose a file they still need. Lost hosts
        # never ack; their rounds leak, bounded by the loss count.
        _atomic_write(os.path.join(rd, "ack_%d" % host_id), "")
        try:
            acked = {int(f[4:]) for f in os.listdir(rd)
                     if f.startswith("ack_")}
            if acked >= set(result):
                import shutil
                shutil.rmtree(rd, ignore_errors=True)
        except (OSError, ValueError):   # pragma: no cover - lost race
            pass
        # fire for every loss THIS process has not yet reacted to —
        # including tombstones another process won the race to write:
        # mesh re-init is per-process state, so a survivor that merely
        # OBSERVES a loss must still rebuild its collectives. Grown
        # slots are born fenced but were never members: no hooks, and
        # they stay OUT of _known_lost so a real loss after they join
        # still fires (LocalCoordinator.resize parity).
        growing = {h for h, r in lost.items()
                   if str(r).startswith(GROW_FENCE_REASON)}
        newly_observed = sorted(set(lost) - growing - self._known_lost)
        self._known_lost.update(h for h in lost if h not in growing)
        self._on_loss(newly_observed)
        return result


# ---------------------------------------------------------------------------
# socket-backed coordinator (multi-process pods WITHOUT shared storage)

# ---------------------------------------------------------------------------
# socket-backed coordinator (multi-process pods WITHOUT shared storage)
# ---------------------------------------------------------------------------

class SocketCoordinator(Coordinator):
    """Coordinator over a TCP rendezvous service — one object per
    PROCESS, no shared filesystem anywhere.

    The full protocol of Local/FileCoordinator (sticky round
    completion, tombstone fencing, join announcements, consensus
    elections) lives server-side in :class:`~.transport.CoordServer`
    (in-process for tests, standalone via
    ``python -m paddle_tpu_torch.tools.coordsvc``); this
    client implements the :class:`Coordinator` contract over it, so
    :class:`PodResilientTrainer`/:class:`ElasticTrainer` run unmodified.

    What the network transport adds over FileCoordinator:

      * **Real liveness.** A daemon thread heartbeats the server every
        ``hb_interval_s``; the server tombstones any host whose
        heartbeat goes stale past its ``hb_deadline_s`` — a
        ``kill -9`` is detected by the DEADLINE, not by a peer calling
        :meth:`mark_lost` or waiting out a gather timeout. Every
        response carries the server's lost map, so survivors fire their
        loss hooks (mesh re-init) even with no gather in flight.
      * **Transient-fault tolerance.** Socket errors reconnect and
        re-send through the shared :class:`~.resilience.RetryPolicy`;
        round contributions are idempotent server-side (keyed by
        ``(name, host_id)`` plus a per-call token), so a replay after a
        broken pipe never double-counts — and an imposter with a
        different token still gets the split-brain
        :class:`CoordinationError`.
      * **Observability.** ``transport_reconnects_total`` and the
        per-host ``transport_heartbeat_lag`` gauge ride
        ``resilience.metrics()``.

    ``host_id`` binds the object to its host (the heartbeat identity);
    the per-call ``host_id`` arguments of the contract remain and must
    match in a real deployment. ``heartbeat=False`` builds a passive
    client (observers, tests driving liveness by hand).

    ``address`` may be a LIST of endpoints (``"h:p1,h:p2"`` or a list)
    — a term-replicated CoordServer group in index order. Failover is
    transparent: on primary loss the client rotates to the promoted
    standby inside its retry budget, contributions replay idempotently
    by ``(name, host_id, token)``, and a stale ex-primary's responses
    are refused by term (``transport_stale_primary``) — the trainers
    above this class run UNMODIFIED through a coordinator SIGKILL.

    The wire is newline JSON, so a buddy blob sent through this
    coordinator travels as base64 text (``blob_text``; the in-process
    coordinators keep it as bytes), which either package decodes."""

    # buddy.send_snapshot encodes blobs as text for a JSON wire
    blob_text = True

    def __init__(self, address, n_hosts, host_id, timeout_s=30.0,
                 poll_s=0.01, poll_max_s=0.25, detect_loss=True,
                 mesh_reinit=True, heartbeat=True, hb_interval_s=0.5,
                 retry_policy=None, mailbox=True,
                 mailbox_host="127.0.0.1", mailbox_port=0):
        super(SocketCoordinator, self).__init__(
            n_hosts, timeout_s=timeout_s, detect_loss=detect_loss,
            mesh_reinit=mesh_reinit)
        from .transport import CoordClient
        self.host_id = int(host_id)
        self._mb_server = None
        self._mb_addrs = {}
        self.poll_s = float(poll_s)
        self.poll_max_s = max(self.poll_s, float(poll_max_s))
        self._known_lost = set()
        self._known_lock = threading.Lock()
        self._lost_seen_v = -1
        self._token_seq = 0
        # per-INCARNATION token base: a reconnect replay from this
        # process matches its own token (idempotent), while a duplicate
        # process launched with the same host_id generates a different
        # base and still gets the split-brain CoordinationError
        import os as _os
        import random as _random
        self._token_base = "%d.%08x" % (_os.getpid(),
                                        _random.getrandbits(32))
        self._client = CoordClient(address, host_id=self.host_id,
                                   retry_policy=retry_policy)
        # hello validates the pod size before anything else rides the
        # connection; the heartbeat (when armed) then takes the lease
        with obs.span("coord.hello", host=self.host_id):
            self._call("hello", n_hosts=self.n_hosts)
        if mailbox:
            # p2p buddy mailbox endpoint: started and registered BEFORE
            # this constructor returns (and so before any pod_start
            # barrier completes), so every peer can resolve this host's
            # address by the time the first gen-0 seed streams.
            from . import buddy as buddy_mod
            from .transport import MailboxServer
            self._mb_server = MailboxServer(
                buddy_mod.BuddyMailbox(host_id=self.host_id),
                host=mailbox_host, port=int(mailbox_port))
            self._call("mailbox_hello", addr=self._mb_server.address)
        if obs.enabled():
            # align this process's span timestamps to the coordination
            # server's clock (min-RTT midpoint probe) — what lets one
            # merged timeline order spans across hosts. Best-effort:
            # an old server without the `time` op changes nothing.
            try:
                obs.probe_clock_offset(lambda cmd: self._call(cmd))
            except Exception:
                pass
        if heartbeat:
            self._client.start_heartbeat(interval_s=hb_interval_s,
                                         on_lost=self._observe_lost)
        else:
            self._client._lost_cb = self._observe_lost

    # -- loss observation (runs on gather AND heartbeat threads) ----------
    def _observe_lost(self, lost, version=None):
        """Fire _on_loss exactly once per process per tombstone —
        including ones the server's heartbeat monitor wrote. The update
        of _known_lost happens BEFORE the hooks so the nested
        live_hosts() calls inside _on_loss cannot re-enter. ``version``
        is the server's lost_v: a delayed delivery older than one we
        already processed is DROPPED, so a pre-unfence map can never
        re-fire hooks for a host this coordinator just readmitted (or
        poison _known_lost into suppressing its next real loss)."""
        with self._known_lock:
            if version is not None:
                if version < self._lost_seen_v:
                    return
                self._lost_seen_v = version
            # a GROWN slot's birth fence is not a loss: the host was
            # never a member, so no hooks fire and it stays out of
            # _known_lost (else its first REAL loss after joining
            # would be suppressed) — LocalCoordinator.resize parity
            growing = {h for h, r in lost.items()
                       if str(r).startswith(GROW_FENCE_REASON)} \
                if isinstance(lost, dict) else set()
            newly = sorted(set(lost) - growing - self._known_lost
                           - {self.host_id})
            self._known_lost.update(h for h in lost
                                    if h not in growing)
        if newly:
            self._on_loss(newly)

    def _call(self, cmd, **fields):
        """call() with server errors mapped onto the Coordinator error
        taxonomy (transport errors — ConnectionError — raise through
        as transients for the caller's policy)."""
        try:
            return self._client.call(cmd, **fields)
        except CoordinationError:
            raise
        except RuntimeError as e:
            raise CoordinationError(str(e))

    # -- contract ----------------------------------------------------------
    def lost_hosts(self):
        self._call("lost")            # call() refreshed last_lost
        return dict(self._client.last_lost)

    def live_hosts(self):
        lost = self.lost_hosts()
        return [i for i in range(self.n_hosts) if i not in lost]

    def mark_lost(self, host_id, reason="declared lost"):
        # the response's lost map runs through _observe_lost, which
        # fires _on_loss for the newly tombstoned host
        self._call("mark_lost", host=int(host_id), reason=reason)

    def announce_join(self, host_id, nonce):
        self._call("announce_join", host=int(host_id), nonce=int(nonce))

    def pending_joins(self):
        joins = self._call("pending_joins").get("joins", {})
        return {int(h): int(n) for h, n in joins.items()}

    # -- member registry (serving fleet) -----------------------------------
    def put_info(self, info):
        """Publish this host's JSON blob to the server's member
        registry (last write wins). The serving fleet advertises each
        replica's HTTP address + artifact generation here so the
        router needs no static fleet configuration."""
        self._call("put_info", info=info)

    # -- buddy-snapshot mailboxes (server-side store) ----------------------
    def put_blob(self, host_id, gen, buddy, blob, reset=False):
        """Mailbox write on the CoordServer (see Coordinator.put_blob):
        synchronously replicated to standbys and snapshot-covered, so
        an acked snapshot survives coordinator failover. The server's
        ``blob_max_bytes`` refusal surfaces as
        :class:`BlobTooLargeError`."""
        try:
            resp = self._call("put_blob", host=int(host_id),
                              gen=int(gen), buddy=int(buddy),
                              blob=blob, reset=bool(reset))
        except CoordinationError as e:
            if "blob_max_bytes" in str(e):
                raise BlobTooLargeError(str(e))
            raise
        if "fenced" in resp:
            raise HostLostError(
                "host %d is fenced (%s) — a fenced host must not "
                "publish buddy snapshots" % (int(host_id),
                                             resp["fenced"]))

    def get_blob(self, owner, meta_only=False):
        resp = self._call("get_blob", owner=int(owner),
                          meta_only=bool(meta_only))
        if resp.get("miss"):
            return None
        out = {"gen": int(resp["gen"]), "buddy": int(resp["buddy"])}
        if not meta_only:
            out["blob"] = resp.get("blob")
        return out

    # -- p2p buddy mailboxes (real per-host endpoints) ---------------------
    def mailbox_of(self, host_id):
        """This host's own mailbox when the endpoint is armed; the
        in-process base registry otherwise (mailbox=False clients,
        observers)."""
        if self._mb_server is not None \
                and int(host_id) == self.host_id:
            return self._mb_server.mailbox
        return super(SocketCoordinator, self).mailbox_of(host_id)

    def _mailbox_addr(self, host_id):
        """Resolve a peer's MailboxServer address from the local cache,
        refreshed from the coordinator's replicated address book on a
        miss."""
        h = int(host_id)
        addr = self._mb_addrs.get(h)
        if addr is None:
            resp = self._call("buddy_meta")
            self._mb_addrs.update(
                {int(k): a
                 for k, a in resp.get("addrs", {}).items()})
            addr = self._mb_addrs.get(h)
        return addr

    def _mailbox_request(self, host_id, req):
        """One-shot request against ``host_id``'s mailbox endpoint. A
        dead/renumbered endpoint drops the cached address before the
        ConnectionError propagates, so the next attempt re-resolves."""
        from .transport import mailbox_request
        h = int(host_id)
        addr = self._mailbox_addr(h)
        if addr is None:
            raise ConnectionError(
                "no mailbox endpoint registered for host %d" % h)
        try:
            return mailbox_request(addr, req)
        except ConnectionError:
            self._mb_addrs.pop(h, None)
            raise

    def mailbox_send(self, owner, at, payload):
        at = int(at)
        if self._mb_server is not None and at == self.host_id:
            return self._mb_server.mailbox.deposit(owner, payload)
        if self._mb_server is None:
            return super(SocketCoordinator, self).mailbox_send(
                owner, at, payload)
        resp = self._mailbox_request(
            at, {"cmd": "mb_deposit", "owner": int(owner),
                 "payload": payload})
        if "error" in resp:
            raise ConnectionError(
                "mailbox deposit for host %d failed: %s"
                % (int(owner), resp["error"]))
        return resp

    def mailbox_fetch(self, owner, at):
        at = int(at)
        if self._mb_server is not None and at == self.host_id:
            try:
                return self._mb_server.mailbox.reconstruct(owner)
            except LookupError:
                return None
        if self._mb_server is None:
            return super(SocketCoordinator, self).mailbox_fetch(
                owner, at)
        resp = self._mailbox_request(
            at, {"cmd": "mb_fetch", "owner": int(owner)})
        if resp.get("miss"):
            return None
        if "refused" in resp or "error" in resp:
            raise RuntimeError(
                "mailbox fetch for host %d refused: %s"
                % (int(owner),
                   resp.get("refused") or resp.get("error")))
        return resp

    def put_buddy_meta(self, host_id, gen, buddy, digest, nbytes,
                       reset=False):
        """Metadata commit on the CoordServer (replicated + snapshot-
        covered) — see Coordinator.put_buddy_meta."""
        resp = self._call("put_buddy_meta", host=int(host_id),
                          gen=int(gen), buddy=int(buddy),
                          digest=digest, nbytes=int(nbytes),
                          reset=bool(reset))
        if "fenced" in resp:
            raise HostLostError(
                "host %d is fenced (%s) — a fenced host must not "
                "publish buddy metadata" % (int(host_id),
                                            resp["fenced"]))

    def buddy_meta(self, owner):
        resp = self._call("buddy_meta", owner=int(owner))
        if resp.get("miss"):
            return None
        out = {"gen": int(resp["gen"]), "buddy": int(resp["buddy"]),
               "digest": resp.get("digest"),
               "nbytes": int(resp.get("nbytes", 0))}
        if resp.get("addr"):
            # piggybacked address of the recorded buddy's endpoint —
            # prime the cache so the restore-time pull needs no extra
            # round-trip
            self._mb_addrs[out["buddy"]] = resp["addr"]
        return out

    def members(self):
        """One snapshot of the whole membership picture:
        ``{"n_hosts", "hb_deadline_s", "hb_age": {host: seconds},
        "info": {host: blob}, "lost": {host: reason}}`` — host keys as
        ints. The routing table is derived from exactly this (live =
        registered, not fenced), and ``hb_deadline_s`` lets a client
        judge a lease live-looking by the same bound the server's
        monitor fences by."""
        resp = self._call("members")
        n = resp.get("n_hosts")
        if n is not None and int(n) != self.n_hosts:
            # a peer resized the group (dynamic resize): adopt — the
            # server is the size's single source of truth, and a stale
            # client-side n_hosts would mis-enumerate live_hosts()
            self.n_hosts = int(n)
            record_event("group_resize", n_hosts=self.n_hosts,
                         adopted=True)
        return {"n_hosts": resp.get("n_hosts"),
                "resize_v": resp.get("resize_v"),
                "hb_deadline_s": resp.get("hb_deadline_s"),
                "hb_age": {int(h): float(v)
                           for h, v in resp.get("hb_age", {}).items()},
                "info": {int(h): v
                         for h, v in resp.get("info", {}).items()},
                "lost": {int(h): v
                         for h, v in resp.get("lost", {}).items()}}

    def unfence(self, host_id):
        self._call("unfence", host=int(host_id))
        with self._known_lock:
            # a future re-loss of this host must re-fire _on_loss here
            self._known_lost.discard(int(host_id))

    def resize(self, n_hosts):
        """Server-side dynamic resize (primary-replicated, snapshot-
        covered); adopts the new size locally. Raises
        CoordinationError mid-round or for a live id in a shrink range
        (the server's named refusals)."""
        if int(n_hosts) < 1:
            # local pre-check so the caller-facing contract matches
            # Local/File: ValueError for a bad ARGUMENT, reserving
            # CoordinationError for the protocol's named refusals
            raise ValueError("resize: n_hosts must be >= 1, got %d"
                             % int(n_hosts))
        resp = self._call("resize", n_hosts=int(n_hosts))
        self.n_hosts = int(resp.get("n_hosts", n_hosts))
        record_event("group_resize", n_hosts=self.n_hosts)
        return self.n_hosts

    def all_gather(self, name, host_id, value=None, timeout_s=None):
        # the span covers put + poll-to-freeze + ack: the whole
        # barrier WAIT, which is exactly what makes an elastic window
        # barrier attributable (compute vs coordination) on a merged
        # timeline
        with obs.span("coord.gather", round=name, host=host_id):
            return self._all_gather_traced(name, host_id, value,
                                           timeout_s)

    def _all_gather_traced(self, name, host_id, value, timeout_s):
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None
                                       else float(timeout_s))
        with self._known_lock:
            self._token_seq += 1
            token = "h%d.%s.%d" % (self.host_id, self._token_base,
                                   self._token_seq)
        resp = self._call("put", name=name, host=host_id, value=value,
                          token=token)
        if "fenced" in resp:
            raise HostLostError(
                "host %d is fenced (%s) — rejoin, don't resume"
                % (host_id, resp["fenced"]))
        sleep_s = self.poll_s
        while True:
            try:
                resp = self._call("poll", name=name, host=host_id)
            except CoordinationError as e:
                if "unknown" not in str(e):
                    raise
                # "round unknown" AFTER our put landed: the service
                # failed over to a standby the contribution had not
                # replicated to yet (a sub-sync-window race). The put
                # is idempotent keyed by (name, host, token) — re-send
                # it against the promoted member and keep polling; a
                # replay the new primary DID inherit answers "resent"
                resp = self._call("put", name=name, host=host_id,
                                  value=value, token=token)
                if "fenced" in resp:
                    raise HostLostError(
                        "host %d is fenced (%s) — rejoin, don't resume"
                        % (host_id, resp["fenced"]))
                continue
            if "fenced" in resp:
                raise HostLostError(
                    "host %d is fenced (%s) — rejoin, don't resume"
                    % (host_id, resp["fenced"]))
            if "done" in resp:
                break
            if time.monotonic() >= deadline:
                waiting = resp.get("waiting", [])
                if not self.detect_loss:
                    raise BarrierTimeoutError(
                        "round %r timed out waiting for hosts %s"
                        % (name, waiting))
                for i in waiting:
                    # client-driven fencing at the gather deadline —
                    # the slow path; the server's heartbeat monitor
                    # usually tombstones a dead host long before this
                    self._call("mark_lost", host=i,
                               reason="missed round %r" % name)
                continue
            time.sleep(min(sleep_s,
                           max(0.0, deadline - time.monotonic())))
            sleep_s = min(sleep_s * 2.0, self.poll_max_s)
        result = {int(h): v for h, v in resp["values"].items()}
        if host_id in self._client.last_lost:
            # fenced between the freeze and our exit (File/Local
            # parity): the snapshot exists for the survivors; we fence
            raise HostLostError(
                "host %d is fenced (%s) — rejoin, don't resume"
                % (host_id, self._client.last_lost[host_id]))
        # last one out cleans up server-side; fenced hosts never ack —
        # their rounds leak server-side, bounded by the loss count
        self._call("ack", name=name, host=host_id)
        return result

    def close(self):
        if self._mb_server is not None:
            self._mb_server.close()
        self._client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# pod-level resilient training
# ---------------------------------------------------------------------------

class PodResilientTrainer(object):
    """Coordinated auto-recovery across an N-host pod.

    Wraps N per-host :class:`~.resilience.ResilientTrainer` s, each with
    its own Executor, Scope and checkpoint dir. In the simulation all N
    live in one process on a :class:`LocalCoordinator` (threads); in
    ``host_id`` mode each process holds its own trainer and they meet on
    a shared coordinator.

    Protocol, per dispatch window:

      1. every host dispatches its window and (at a checkpoint boundary)
         saves its checkpoint;
      2. status exchange (all_gather): ok / transient / fatal;
      3. all ok: commit, mail the buddy snapshot and continue. Any
         fatal: the whole pod aborts (a shape bug replays identically).
         Any transient: pod-wide recovery: the agreed buddy restore at
         this boundary if every host's snapshot is there, else every
         host scrubs its checkpoint dir without loading payloads
         (io.scrub_checkpoint), the coordinator elects the max step
         valid on every live host, and every host restores exactly that
         step.

    A checkpoint carries the parameters, the optimizer state and the run
    counter, so the replayed pod trajectory equals a fault-free run bit
    for bit. The restart budget is shared: every host's counter advances
    in lockstep and the pod gives up together."""

    def __init__(self, trainers, coordinator=None, max_restarts=3,
                 host_id=None, buddy=True, buddy_compress="zlib",
                 buddy_p2p=True, buddy_delta=True,
                 buddy_rebase_every=8):
        """``host_id=None`` (simulation): ``trainers`` holds all N hosts
        and run() drives them on N threads. ``host_id=i`` (one process a
        host): ``trainers`` holds this host's trainer, ``coordinator`` is
        the shared rendezvous, and run() drives the one host loop in the
        calling thread.

        ``buddy=True`` arms the buddy-checkpoint tier
        (:mod:`framework.buddy`); ``buddy_compress``: "zlib" (lossless:
        a restore stays bit-equal to the uninterrupted run), "q8"
        (lossy) or None; ``buddy_p2p=True`` keeps payloads in the peer
        mailboxes with the coordinator holding metadata only (False:
        the coordinator's ``put_blob``); ``buddy_delta=True`` ships only
        changed leaves, re-based to a full send every
        ``buddy_rebase_every`` windows."""
        if not trainers:
            raise ValueError("PodResilientTrainer needs >= 1 trainer")
        if buddy_compress not in (None, "zlib", "q8"):
            raise ValueError("buddy_compress must be None, 'zlib' or "
                             "'q8', got %r" % (buddy_compress,))
        if int(buddy_rebase_every) < 1:
            raise ValueError("buddy_rebase_every must be >= 1, got %r"
                             % (buddy_rebase_every,))
        self._buddy = bool(buddy)
        self._buddy_compress = buddy_compress
        self._buddy_p2p = bool(buddy_p2p)
        self._buddy_delta = bool(buddy_delta)
        self._buddy_rebase_every = int(buddy_rebase_every)
        # per-host sender-side delta trackers
        self._buddy_trackers = {}
        self._trainers = list(trainers)
        every = {t._checkpoint_every for t in self._trainers}
        window = {t._steps_per_dispatch for t in self._trainers}
        keep = {t._keep_last for t in self._trainers}
        if len(every) != 1 or len(window) != 1 or len(keep) != 1:
            # the recovery protocol assumes identical control flow on
            # every host: same windows, checkpoint boundaries and pruning
            raise ValueError(
                "all pod trainers must agree on checkpoint_every, "
                "steps_per_dispatch and keep_last (got %s / %s / %s)"
                % (sorted(every), sorted(window), sorted(keep)))
        if min(keep) < 2:
            # a host that faulted before the window's save holds one
            # fewer checkpoint than its ok peers; keep_last=1 would let
            # the peers prune the last step everyone shares
            raise ValueError(
                "pod trainers need keep_last >= 2: the consensus "
                "election requires the previous common checkpoint to "
                "survive the ok hosts' pruning")
        self._coordinator = coordinator or LocalCoordinator(
            len(self._trainers))
        self._host_id = None if host_id is None else int(host_id)
        if self._host_id is None:
            if self._coordinator.n_hosts != len(self._trainers):
                raise ValueError(
                    "coordinator expects %d hosts but %d trainers were "
                    "given" % (self._coordinator.n_hosts,
                               len(self._trainers)))
        else:
            if len(self._trainers) != 1:
                raise ValueError(
                    "host_id mode is one-process-per-host: pass exactly "
                    "this host's trainer (got %d)" % len(self._trainers))
            if not 0 <= self._host_id < self._coordinator.n_hosts:
                raise ValueError(
                    "host_id %d out of range for a %d-host coordinator"
                    % (self._host_id, self._coordinator.n_hosts))
        self._max_restarts = int(max_restarts)
        # advances once per run() on every host, namespacing round names
        # so that a second run() never collides with the first's rounds
        self._run_seq = 0

    @property
    def coordinator(self):
        return self._coordinator

    def _agree_poison(self, co, hid, run_tag, rnd, trainer, step, err):
        """Pod-wide poison-batch agreement, one gather of the recovery
        round: the host whose numeric policy localized a
        :class:`~.resilience.NumericFaultError` publishes the batch's
        index and every host adds the agreed union to its trainer's
        poison set, so the replay skips it pod-wide."""
        mine = []
        if isinstance(err, resilience.NumericFaultError) \
                and not isinstance(err,
                                   resilience.SkipBudgetExceededError):
            b = err.batch_index
            if b is None:
                b = step + int(err.window_offset or 0)
            mine = [int(b)]
        shared = co.all_gather("%sp%d" % (run_tag, rnd), hid, mine)
        agreed = sorted({int(b) for v in shared.values()
                         for b in (v or [])})
        culprit = getattr(err, "culprit", None)
        for b in agreed:
            if b not in trainer._poison_batches:
                trainer._poison_batches.add(b)
                record_event("poison_batch", batch=b, step=step,
                             **({} if culprit is None
                                else {"culprit": culprit}))
        return agreed

    @staticmethod
    def _scope_of(trainer):
        from .scope import global_scope
        return trainer._scope if trainer._scope is not None \
            else global_scope()

    def _buddy_send(self, co, hid, trainer, members, gen, reset=False):
        """Mail this window boundary's snapshot to the ring buddy;
        best-effort (:func:`buddy.send_snapshot` turns every failure
        into a ``buddy_send_fail`` event)."""
        if not self._buddy:
            return
        from . import buddy as buddy_mod
        tracker = None
        if self._buddy_p2p and self._buddy_delta:
            tracker = self._buddy_trackers.get(int(hid))
            if tracker is None:
                tracker = self._buddy_trackers[int(hid)] = \
                    buddy_mod.DeltaTracker(
                        rebase_every=self._buddy_rebase_every)
        buddy_mod.send_snapshot(co, hid, members, gen,
                                self._scope_of(trainer),
                                compress=self._buddy_compress,
                                reset=reset, p2p=self._buddy_p2p,
                                tracker=tracker)

    def _buddy_restore(self, co, hid, run_tag, rnd, trainer, gen, live,
                       lost=(), shardings=None, agreed=False,
                       reason=None):
        """Pod-agreed buddy restore at generation ``gen``, tried before
        the consensus disk rewind. Returns the restored step (``gen``)
        or None for the disk fallback; the typed reason
        (:data:`buddy.FALLBACK_REASONS`) is recorded on the
        ``buddy_restore`` event either way. ``agreed=True``: the caller
        already ran :func:`buddy.agree_plan` this round and passes its
        ``reason``."""
        if not self._buddy:
            return None
        from . import buddy as buddy_mod
        name = "%sb%d" % (run_tag, rnd)
        live, lost = sorted(live), sorted(lost)
        if not agreed:
            reason = buddy_mod.agree_plan(
                co, hid, name, live, lost,
                sorted(set(live) | set(lost)), gen,
                p2p=self._buddy_p2p)
        if reason is None:
            ok, _ = buddy_mod.restore_agreed(
                co, hid, name, gen, self._scope_of(trainer),
                shardings=shardings, p2p=self._buddy_p2p,
                device=trainer._executor.device)
            if ok:
                # the buddy election is this round's restore consensus:
                # recorded in elect_restore_step's shape
                record_event("consensus", step=int(gen),
                             hosts=len(live), quorum=len(live))
                record_event("buddy_restore", outcome="ok",
                             step=int(gen))
                return int(gen)
            reason = "snapshot_torn"
        record_event("buddy_restore", outcome=reason, step=int(gen))
        return None

    def run(self, feeds, fetch_list=None, steps=None):
        """Run the pod to completion, recovering from transient faults.

        ``feeds``: one list of per-step feed dicts (replicated to every
        host) or a list of N per-host feed lists of equal length.
        Returns the per-host fetch lists ``[n_hosts][n_steps]``; in
        ``host_id`` mode ``feeds`` is this host's list and the result
        its fetch list. ``feeds=None`` (per-host ShardedFeed streams)
        raises NotPortedError."""
        if feeds is None:
            raise NotPortedError(
                "pod runs over per-host ShardedFeed streams "
                "(run(feeds=None)) arrive with the torch.distributed "
                "(multi-GPU) slice of paddle_tpu_torch — pass the "
                "batches to run(feeds)")
        if self._host_id is not None:
            self._run_seq += 1
            with resilience.context(host=self._host_id):
                return self._host_loop(self._host_id,
                                       "r%d." % self._run_seq,
                                       list(feeds), fetch_list)
        n_hosts = len(self._trainers)
        if not feeds or isinstance(feeds[0], dict):
            per_host = [list(feeds)] * n_hosts
        else:
            per_host = [list(f) for f in feeds]
            if len(per_host) != n_hosts:
                raise ValueError(
                    "per-host feeds: expected %d lists, got %d"
                    % (n_hosts, len(per_host)))
        if len({len(f) for f in per_host}) > 1:
            raise ValueError("every host needs the same number of "
                             "steps (lockstep collectives)")
        results = [None] * n_hosts
        errors = [None] * n_hosts
        self._run_seq += 1
        run_tag = "r%d." % self._run_seq

        def host_main(hid):
            try:
                with resilience.context(host=hid):
                    results[hid] = self._host_loop(hid, run_tag,
                                                   per_host[hid],
                                                   fetch_list)
            except BaseException as e:   # surfaced after join
                errors[hid] = e

        threads = [threading.Thread(target=host_main, args=(hid,),
                                    name="pod-host-%d" % hid)
                   for hid in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        real = [e for e in errors
                if e is not None and not isinstance(e, CoordinationError)]
        if real:
            raise real[0]
        coord = [e for e in errors if e is not None]
        if coord:
            raise coord[0]
        return results

    def _host_loop(self, hid, run_tag, feeds, fetch_list):
        # host_id mode holds only this host's trainer; the simulation
        # holds all of them, indexed by the logical host id
        trainer = self._trainers[0] if self._host_id is not None \
            else self._trainers[hid]
        co = self._coordinator
        fetch_list = trainer._resolved_fetch_list(fetch_list)
        n = len(feeds)
        trainer._require_fresh_dir()
        trainer._save(0)
        co.barrier(run_tag + "pod_start", hid)
        # seed the buddy mailboxes at gen 0 (after the barrier: the ring
        # comes from a membership every host agrees on); reset=, since a
        # second run() starts below the previous run's generations
        self._buddy_send(co, hid, trainer, sorted(co.live_hosts()), 0,
                         reset=True)
        if n == 0:
            co.barrier(run_tag + "pod_end", hid)
            return []
        all_fetches = [None] * n
        ckpt_every = trainer._checkpoint_every
        step, restarts, rnd = 0, 0, 0
        while step < n:
            rnd += 1   # advances identically on every host
            until_ckpt = ckpt_every - (step % ckpt_every)
            w = min(trainer._steps_per_dispatch, n - step, until_ckpt)
            status, err, outs = "ok", None, None
            try:
                outs = trainer._dispatch(feeds, step, w, fetch_list)
                if (step + w) % ckpt_every == 0 or step + w == n:
                    trainer._save(step + w)
            except Exception as e:
                err = e
                status = "transient" if trainer._policy.is_transient(e) \
                    else "fatal"
            statuses = co.all_gather("%sw%d" % (run_tag, rnd), hid,
                                     status)
            if any(v == "fatal" for v in statuses.values()):
                record_event("fatal", step=step,
                             error=type(err).__name__ if err else None)
                if err is not None and status == "fatal":
                    raise err
                bad = sorted(h for h, v in statuses.items()
                             if v == "fatal")
                raise CoordinationError(
                    "pod aborted: host(s) %s hit a fatal error at step %d"
                    % (bad, step))
            if all(v == "ok" for v in statuses.values()):
                for i in range(w):
                    all_fetches[step + i] = outs[i]
                step += w
                # every committed boundary refreshes the buddy tier: the
                # mailbox generation tracks the agreed step exactly
                self._buddy_send(co, hid, trainer, sorted(statuses), step)
                continue
            # -- pod-wide recovery ------------------------------------
            restarts += 1   # lockstep on every host: the shared budget
            if restarts > self._max_restarts:
                record_event("giveup", step=step, restarts=restarts)
                raise RestartBudgetExceededError(
                    "pod restart budget (%d) exhausted at step %d; "
                    "last local error: %r" % (self._max_restarts, step,
                                              err))
            delay = trainer._policy.delay_s(restarts - 1)
            record_event("pod_restart", step=step, restarts=restarts,
                         error=type(err).__name__ if err else None,
                         backoff_s=delay)
            trainer._policy.sleep(delay)
            # numeric_policy="rewind": agree the poison batch so every
            # host's replay skips it
            self._agree_poison(co, hid, run_tag, rnd, trainer, step,
                               err)
            # warm path first: the buddy tier holds every host's state at
            # this very boundary (gen == step); any doubt falls the whole
            # pod back to the consensus rewind
            got = self._buddy_restore(co, hid, run_tag, rnd, trainer,
                                      step, sorted(statuses))
            if got is None:
                from .. import io as io_mod
                report = io_mod.scrub_checkpoint(trainer._ckpt_dir)
                agreed = co.elect_restore_step(
                    hid, report["valid_steps"],
                    name="%se%d" % (run_tag, rnd))
                got = trainer._restore(step=agreed)
                # the disk rewind moved the pod below the mailbox
                # generations: re-seed them, reset= past the rewind fence
                self._buddy_send(co, hid, trainer, sorted(statuses), got,
                                 reset=True)
            record_event("pod_restore", step=got)
            step = got
        co.barrier(run_tag + "pod_end", hid)
        return all_fetches


# ---------------------------------------------------------------------------
# elastic training: continue on the survivors, re-absorb on rejoin
# ---------------------------------------------------------------------------

def _default_lr_rescale(trainer, scale_by, scope):
    """Default lr_rescale hook: multiply every floating
    ``learning_rate*`` value of the scope by ``scale_by`` (in the value's
    own dtype, as the JAX package multiplies by ``dtype.type(scale)``),
    binding a new tensor on the value's device. Replace through
    ``ElasticTrainer(lr_rescale_hook=...)`` for schedules kept
    elsewhere."""
    import torch
    for name in list(scope.keys()):
        if "learning_rate" not in name:
            continue
        val = scope.find_var(name)
        if not isinstance(val, torch.Tensor) or \
                not val.is_floating_point():
            continue
        scope.set_var(name, val * torch.tensor(scale_by, dtype=val.dtype,
                                               device=val.device))


class ElasticTrainer(PodResilientTrainer):
    """Elastic continue: survivors keep training when a host drops.

    PodResilientTrainer answers every fault with a pod-wide rewind;
    ElasticTrainer answers membership changes elastically and keeps the
    rewind for poisoned state:

      * **Shrink.** A lost host is fenced; the survivors do not rewind:
        they complete the in-flight window, re-target their
        CompiledProgram onto the capacity-scaled mesh
        (``set_mesh_axes``, ``dp`` scaled by the live fraction of the
        full topology) and continue from the in-flight step
        (``elastic_shrink``, ``capacity`` "3/4"). On one card the mesh
        has size 1: nothing is re-sharded.
      * **Grow.** A fenced host announces a rejoin; every survivor sees
        the pending set on the window status exchange, so all admit the
        same joiner in the same window (``Coordinator.admit`` /
        ``join``). The live state is shipped to it (in the threaded
        simulation leaf by leaf through the ``ship_compress`` codec,
        zlib by default: lossless; or through a scrub-validated sync
        checkpoint in ``sync_dir``, which ``host_id`` mode needs), the
        mesh re-absorbs the host (``elastic_grow``, "4/4").
      * **Transient compute faults** still take the parent's pod-wide
        recovery (the buddy restore, else the consensus rewind).

    Feeds must be the replicated shape (one list of per-step feed
    dicts). ``drain_after=k`` arms the proactive straggler drain: a host
    flagged for k consecutive windows (its compute latch, or an SDC
    suspect under ``sdc_detect``) fences itself at the next window
    boundary and the survivors shrink, never below ``drain_floor`` and
    at most one host per ``drain_cooldown`` windows. Every decision is
    computed from the frozen window verdicts, so every live host agrees.
    ``drain_hb_lag_s`` flags a host whose heartbeat-cadence lag, carried
    on the window exchange, exceeds it (a SocketCoordinator's client
    measures the lag; Local and File coordinators carry 0.0). A pipeline
    mesh's re-cut (``pp_recut``) raises NotPortedError (the
    torch.distributed slice); so does the stream-lag drain
    (``drain_stream_lag``, which reads per-host ShardedFeed cursors)."""

    # the LR-rescale factor currently applied, checkpointed with the
    # state so that a restore saved under another capacity reconciles
    LR_SCALE_VAR = "@lr_rescale_factor"

    def __init__(self, trainers, coordinator=None, max_restarts=3,
                 host_id=None, rejoin=True, sync_dir=None,
                 lr_rescale=False, grad_merge_steps=1,
                 lr_rescale_hook=None, drain_after=None,
                 ship_compress="zlib", drain_floor=None,
                 drain_cooldown=None, drain_hb_lag_s=None,
                 drain_stream_lag=None, sdc_detect=None,
                 pp_recut=True, buddy=True, buddy_compress="zlib",
                 buddy_p2p=True, buddy_delta=True,
                 buddy_rebase_every=8):
        super(ElasticTrainer, self).__init__(
            trainers, coordinator=coordinator, max_restarts=max_restarts,
            host_id=host_id, buddy=buddy, buddy_compress=buddy_compress,
            buddy_p2p=buddy_p2p, buddy_delta=buddy_delta,
            buddy_rebase_every=buddy_rebase_every)
        self._rejoin = bool(rejoin)
        self._pp_recut = bool(pp_recut)
        self._sync_dir = sync_dir
        if ship_compress not in (None, "zlib", "q8"):
            raise ValueError("ship_compress must be None, 'zlib' or "
                             "'q8', got %r" % (ship_compress,))
        self._ship_compress = ship_compress
        if drain_after is not None and int(drain_after) < 1:
            raise ValueError("drain_after must be >= 1 consecutive "
                             "critical-straggler windows (or None)")
        self._drain_after = None if drain_after is None \
            else int(drain_after)
        if drain_floor is not None:
            if isinstance(drain_floor, float):
                if not 0.0 < drain_floor <= 1.0:
                    raise ValueError(
                        "drain_floor as a fraction must be in (0, 1], "
                        "got %r" % drain_floor)
            elif int(drain_floor) < 1:
                raise ValueError("drain_floor as a host count must be "
                                 ">= 1, got %r" % drain_floor)
        self._drain_floor = drain_floor
        if drain_cooldown is not None and int(drain_cooldown) < 1:
            raise ValueError("drain_cooldown must be >= 1 windows "
                             "(or None = drain_after)")
        self._drain_cooldown = self._drain_after \
            if drain_cooldown is None and self._drain_after \
            else (None if drain_cooldown is None
                  else int(drain_cooldown))
        if drain_hb_lag_s is not None and float(drain_hb_lag_s) <= 0:
            raise ValueError("drain_hb_lag_s must be > 0 seconds "
                             "(or None to ignore heartbeat lag)")
        self._drain_hb_lag_s = None if drain_hb_lag_s is None \
            else float(drain_hb_lag_s)
        if drain_stream_lag is not None:
            raise NotPortedError(
                "ElasticTrainer(drain_stream_lag=) drains on per-host "
                "ShardedFeed stream lag; it arrives with the "
                "torch.distributed (multi-GPU) slice of paddle_tpu_torch")
        # sdc_detect: every window each host publishes its float-state
        # L2 norm on the status exchange and every host runs the same
        # SDCDetector over the frozen map; a suspect is flagged into the
        # drain latch. True = the default detector, a dict its kwargs.
        if sdc_detect in (None, False):
            self._sdc_cfg = None
        elif sdc_detect is True:
            self._sdc_cfg = {}
        elif isinstance(sdc_detect, dict):
            self._sdc_cfg = dict(sdc_detect)
        else:
            raise ValueError(
                "sdc_detect must be None/False, True, or a dict of "
                "SDCDetector kwargs, got %r" % (sdc_detect,))
        # lr_rescale=True: the fixed-per-host-batch regime, where a
        # capacity change linearly rescales the learning rate
        # (gradient-merge-aware: grad_merge_steps an int or a callable
        # live_hosts -> k); False: the replicated-feed regime, where the
        # global batch and the schedule do not move
        self._lr_rescale = bool(lr_rescale)
        self._grad_merge_steps = grad_merge_steps
        self._lr_rescale_hook = lr_rescale_hook
        self._nonces = {}
        self._nonce_lock = threading.Lock()
        # each trainer's full topology, frozen at first use:
        # set_mesh_axes mutates the strategy, and a later run() must
        # still scale from the full axes
        self._frozen_axes = {}
        if host_id is not None and rejoin and sync_dir is None:
            raise ValueError(
                "host_id mode cannot ship rejoin state between process "
                "scopes — pass sync_dir= (a shared directory the "
                "survivors write the sync checkpoint to)")

    def run(self, feeds, fetch_list=None, steps=None):
        if feeds is not None:
            feeds = list(feeds)
            if self._host_id is None and feeds \
                    and not isinstance(feeds[0], dict):
                raise ValueError(
                    "ElasticTrainer needs the replicated feed shape "
                    "(ONE list of per-step feed dicts): every host "
                    "carries the full global batch and the dp mesh "
                    "assigns each host its share, which is what makes "
                    "a capacity change a pure re-partitioning")
        for t in self._trainers:
            strategy = self._target_strategy(t)
            axes = {} if strategy is None \
                else (strategy._build_strategy.mesh_axes or {})
            if self._pp_axes(axes):
                raise NotPortedError(
                    "ElasticTrainer's elastic pipeline re-cut (a 'pp' "
                    "mesh axis, pp_recut) arrives with the "
                    "torch.distributed (multi-GPU) slice of "
                    "paddle_tpu_torch")
        return super(ElasticTrainer, self).run(feeds, fetch_list,
                                               steps=steps)

    # -- topology helpers --------------------------------------------------
    @staticmethod
    def _target_strategy(trainer):
        from .compiler import CompiledProgram
        t = trainer._target
        return t if isinstance(t, CompiledProgram) else None

    def _current_shardings(self, trainer):
        """The shardings a restore re-shards onto: on one card a size-1
        mesh has none (None)."""
        return None

    def _next_nonce(self, hid):
        with self._nonce_lock:
            self._nonces[hid] = self._nonces.get(hid, 0) + 1
            return self._nonces[hid]

    def _straggler_flag(self, hid):
        """This host's critical-straggler latch for the window exchange.
        The threaded simulation shares the process's detector between
        hosts; tests that need attribution override this seam."""
        from . import watchdog
        return watchdog.straggler_action_due()

    def _drain_floor_hosts(self):
        """Minimum live hosts that must remain after a drain."""
        f = self._drain_floor
        if f is None:
            return 1
        if isinstance(f, float):
            import math
            return max(1, int(math.ceil(f * self._coordinator.n_hosts)))
        return max(1, int(f))

    @staticmethod
    def _sdc_norm(trainer):
        """This host's state norm for the SDC sweep: the L2 norm over
        every floating scope value (bfloat16 widened), each summed in
        float64 and added in sorted-name order, so that equal states
        give equal norms; one host read."""
        import torch
        sc = ElasticTrainer._scope_of(trainer)
        parts = []
        for name in sorted(sc.keys()):
            val = sc.find_var(name)
            if isinstance(val, torch.Tensor) and val.is_floating_point():
                parts.append(torch.sum(torch.square(val.double())).cpu())
        total = 0.0
        for p in parts:
            total += float(p)
        return float(total ** 0.5)

    def _hb_lag(self, hid):
        """This host's heartbeat-cadence lag (the value behind the
        transport_heartbeat_lag gauge) for the window exchange: 0.0 on
        coordinators without a transport client (Local, File)."""
        client = getattr(self._coordinator, "_client", None)
        try:
            return float(getattr(client, "hb_lag_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _drain_flags(self, verdicts, sdc=None):
        """Per-host straggler flags from the frozen verdicts only: the
        compute latch (v[3]), the heartbeat lag it carried (v[4], against
        drain_hb_lag_s) and the SDC detector's suspects."""
        suspects = sdc.suspects() if sdc is not None else ()
        flags = {}
        for h, v in verdicts.items():
            f = bool(v[3]) if len(v) > 3 else False
            if not f and self._drain_hb_lag_s is not None and len(v) > 4:
                try:
                    f = float(v[4] or 0.0) > self._drain_hb_lag_s
                except (TypeError, ValueError):
                    f = False
            flags[h] = f or h in suspects
        return flags

    # -- gradient-merge-aware LR rescale (fixed-per-host-batch regime) ----
    def _grad_merge_k(self, n_live):
        k = self._grad_merge_steps
        return int(k(n_live)) if callable(k) else int(k)

    def _lr_target_factor(self, n_live):
        """The effective global batch (per-host batch x live hosts x
        merge steps) over the full-capacity one."""
        n_total = self._coordinator.n_hosts
        k_live = self._grad_merge_k(n_live)
        k_full = self._grad_merge_k(n_total)
        return (n_live * k_live) / float(n_total * k_full), k_live

    def _apply_lr_scale(self, trainer, live):
        """Reconcile the scope's learning rates with the current
        capacity; idempotent and restore-safe (the applied factor lives
        in the checkpointed LR_SCALE_VAR)."""
        if not self._lr_rescale:
            return
        sc = self._scope_of(trainer)
        cur = sc.find_var(self.LR_SCALE_VAR)
        cur = 1.0 if cur is None else float(cur)
        target, k_live = self._lr_target_factor(len(live))
        if abs(target - cur) < 1e-9:
            return
        rel = target / cur
        hook = self._lr_rescale_hook or _default_lr_rescale
        hook(trainer, rel, sc)
        # a Python float (float64): a float32 marker would round
        # non-dyadic ratios and re-trigger a tiny rescale later
        sc.set_var(self.LR_SCALE_VAR, float(target))
        record_event("lr_rescale",
                     capacity="%d/%d" % (len(live),
                                         self._coordinator.n_hosts),
                     factor=round(target, 6), rel=round(rel, 6),
                     grad_merge=k_live)

    @staticmethod
    def _pp_axes(axes):
        """True when a topology carries a pipeline axis larger than 1."""
        return bool(axes) and int(axes.get("pp") or 1) > 1

    def _retarget(self, trainer, base_axes, live, kind, **fields):
        """Re-target this host's CompiledProgram onto the capacity-scaled
        mesh (``dp`` scaled from the full ``base_axes``, never
        compounded), move its state (nothing on a size-1 mesh) and record
        the elastic event."""
        from ..distributed import mesh as mesh_mod
        n_total = self._coordinator.n_hosts
        capacity = "%d/%d" % (len(live), n_total)
        strategy = self._target_strategy(trainer)
        if strategy is None or not base_axes:
            record_event(kind, capacity=capacity, resharded=0, **fields)
            self._apply_lr_scale(trainer, live)
            return
        axes = dict(base_axes)
        if "dp" in axes and axes["dp"] > 1 and len(live) < n_total:
            axes["dp"] = max(1, axes["dp"] * len(live) // n_total)
        old_mesh = mesh_mod.Mesh(strategy._build_strategy.mesh_axes or {})
        strategy.set_mesh_axes(axes)
        new_mesh = mesh_mod.Mesh(axes)
        moved = 0
        if new_mesh != old_mesh:
            sc = self._scope_of(trainer)
            new_state = mesh_mod.reshard_state(dict(sc.items()),
                                               old_mesh, new_mesh)
            for name, val in new_state.items():
                if val is not sc.find_var(name):
                    sc.set_var(name, val)
                    moved += 1
        record_event(kind, capacity=capacity,
                     mesh={a: int(s) for a, s in new_mesh.shape.items()},
                     resharded=moved, **fields)
        self._apply_lr_scale(trainer, live)

    # -- state shipping ----------------------------------------------------
    def _ship_state(self, hid, trainer, live, joined, sync_step):
        """Donor half: in sync_dir mode the lowest surviving host writes
        a checkpoint at the sync step; in the threaded simulation the
        joiner reads the donor's scope, so there is nothing to do."""
        if self._sync_dir is None:
            return
        donors = [h for h in live if h != joined]
        if hid != min(donors):
            return
        from .. import io as io_mod
        io_mod.save_checkpoint(trainer._executor, self._sync_dir,
                               trainer._program, step=sync_step,
                               keep_last=2, scope=self._scope_of(trainer),
                               compress=self._ship_compress)
        try:
            raw, wire = io_mod.checkpoint_dir_bytes(self._sync_dir,
                                                    sync_step)
            resilience.record_bytes("stateship", raw, wire)
        except (OSError, ValueError, KeyError):  # pragma: no cover
            pass   # accounting must never fail a rejoin
        record_event("sync_ship", step=sync_step)

    def _receive_state(self, hid, trainer, live, sync_step):
        """Joiner half: adopt the pod's current state, scrub-validated
        when it travels through sync_dir. In the simulation each donor
        value crosses "the wire" through the ``ship_compress`` host codec
        (ops/quant_ops: zlib lossless, q8 lossy) into a new tensor on
        this host's device, so the byte accounting is a transport's."""
        import torch
        from .. import io as io_mod
        sc = self._scope_of(trainer)
        if self._sync_dir is not None:
            report = io_mod.scrub_checkpoint(self._sync_dir)
            if sync_step not in report["valid_steps"]:
                raise CoordinationError(
                    "sync checkpoint for step %d is not scrub-valid in "
                    "%s (valid: %s) — refusing to rejoin from damaged "
                    "state" % (sync_step, self._sync_dir,
                               report["valid_steps"]))
            io_mod.load_checkpoint(
                trainer._executor, self._sync_dir, trainer._program,
                step=sync_step, scope=sc,
                shardings=self._current_shardings(trainer))
            try:
                raw, wire = io_mod.checkpoint_dir_bytes(self._sync_dir,
                                                        sync_step)
                resilience.record_bytes("stateship", raw, wire)
            except (OSError, ValueError, KeyError):  # pragma: no cover
                pass
            return
        from concurrent.futures import ThreadPoolExecutor
        from ..ops import quant_ops
        donor = self._trainers[min(h for h in live if h != hid)]
        device = trainer._executor.device
        values = dict(self._scope_of(donor).items())
        for name, val in values.items():
            if not isinstance(val, torch.Tensor):
                sc.set_var(name, val)
        # host copies first (new tensors: the donor's are updated in
        # place by its steps), then each leaf through the codec on the
        # io threads (deflate releases the GIL)
        host = {n: io_mod._host_array(v) for n, v in values.items()
                if isinstance(v, torch.Tensor)}

        def wire(item):
            name, (arr, dtype) = item
            if self._ship_compress is None:
                return name, arr, dtype, 0, 0
            enc = quant_ops.encode_array(arr, self._ship_compress)
            return (name, quant_ops.decode_array(enc), dtype,
                    enc["raw_bytes"], enc["wire_bytes"])
        raw_total, wire_total = 0, 0
        with ThreadPoolExecutor(io_mod._IO_THREADS) as pool:
            for name, arr, dtype, raw, wired in pool.map(
                    wire, sorted(host.items())):
                raw_total += raw
                wire_total += wired
                sc.set_var(name, io_mod._decode(arr, dtype).to(
                    device=device, dtype=values[name].dtype, copy=True))
        if wire_total:
            resilience.record_bytes("stateship", raw_total, wire_total)

    # -- the elastic host loop ---------------------------------------------
    def _host_loop(self, hid, run_tag, feeds, fetch_list):
        trainer = self._trainers[0] if self._host_id is not None \
            else self._trainers[hid]
        co = self._coordinator
        fetch_list = trainer._resolved_fetch_list(fetch_list)
        n = len(feeds)
        strategy = self._target_strategy(trainer)
        key = 0 if self._host_id is not None else hid
        if key not in self._frozen_axes:
            self._frozen_axes[key] = dict(
                strategy._build_strategy.mesh_axes or {}) \
                if strategy is not None else {}
        base_axes = self._frozen_axes[key]
        trainer._require_fresh_dir()
        trainer._save(0)
        co.barrier(run_tag + "pod_start", hid)
        # seed the buddy mailboxes at gen 0 over the agreed ring
        self._buddy_send(co, hid, trainer, sorted(co.live_hosts()), 0,
                         reset=True)
        if n == 0:
            co.barrier(run_tag + "pod_end", hid)
            return []
        all_fetches = [None] * n
        ckpt_every = trainer._checkpoint_every
        step, restarts, rnd = 0, 0, 0
        known_live = sorted(co.live_hosts())
        # proactive drain: per-host consecutive flagged windows and the
        # windows since the last drain (None: never drained), computed by
        # every host from the same frozen verdicts
        strag_counts = {}
        since_drain = None
        # one SDC detector per host loop, fed the same frozen norm maps
        sdc = None if self._sdc_cfg is None \
            else resilience.SDCDetector(**self._sdc_cfg)
        while step < n:
            rnd += 1
            until_ckpt = ckpt_every - (step % ckpt_every)
            w = min(trainer._steps_per_dispatch, n - step, until_ckpt)
            status, err, outs = "ok", None, None
            try:
                outs = trainer._dispatch(feeds, step, w, fetch_list)
                if (step + w) % ckpt_every == 0 or step + w == n:
                    trainer._save(step + w)
            except resilience.SimulatedHostDeathError as e:
                # this host is going away: fence ourselves so that the
                # survivors' next gather goes on without waiting out the
                # timeout, then rejoin (or bow out)
                record_event("host_death", step=step,
                             error=type(e).__name__)
                co.mark_lost(hid, "died at step %d: %s"
                             % (step, type(e).__name__))
                got = self._rejoin_or_exit(hid, run_tag, trainer,
                                           base_axes, step)
                if got is None:
                    return all_fetches             # fenced exit (partial)
                step, rnd, restarts = got
                known_live = sorted(co.live_hosts())
                continue
            except Exception as e:
                err = e
                status = "transient" if trainer._policy.is_transient(e) \
                    else "fatal"
            pending = sorted([int(h), int(nc)] for h, nc in
                             co.pending_joins().items())
            strag = bool(self._straggler_flag(hid))
            # the SDC norm, computed after the window ran (v[5])
            norm = None if sdc is None else self._sdc_norm(trainer)
            try:
                verdicts = co.all_gather("%sw%d" % (run_tag, rnd), hid,
                                         [status, pending, None, strag,
                                          self._hb_lag(hid), norm])
            except HostLostError:
                # a peer's timeout fenced us: stop competing
                record_event("host_fenced", step=step)
                got = self._rejoin_or_exit(hid, run_tag, trainer,
                                           base_axes, step)
                if got is None:
                    return all_fetches
                step, rnd, restarts = got
                known_live = sorted(co.live_hosts())
                continue
            live = sorted(verdicts)
            lost = sorted(set(known_live) - set(live))
            if lost:
                # elastic shrink: no rewind, re-target and continue
                self._retarget(trainer, base_axes, live,
                               "elastic_shrink", lost=lost, step=step)
                known_live = live
            statuses = {h: v[0] for h, v in verdicts.items()}
            if any(v == "fatal" for v in statuses.values()):
                record_event("fatal", step=step,
                             error=type(err).__name__ if err else None)
                if err is not None and status == "fatal":
                    raise err
                bad = sorted(h for h, v in statuses.items()
                             if v == "fatal")
                raise CoordinationError(
                    "pod aborted: host(s) %s hit a fatal error at step %d"
                    % (bad, step))
            if all(v == "ok" for v in statuses.values()):
                for i in range(w):
                    all_fetches[step + i] = outs[i]
                step += w
                if strag and step % ckpt_every != 0 and step != n:
                    trainer._save(step)
                    record_event("straggler_ckpt", step=step)
                # the buddy send rides the committed boundary, ringed
                # over this round's frozen live set
                self._buddy_send(co, hid, trainer, live, step)
                if sdc is not None:
                    sdc.observe({h: v[5] for h, v in verdicts.items()
                                 if len(v) > 5 and v[5] is not None},
                                step=step)
                # admission rides the window boundary: every live host
                # saw the same pending sets, so all admit the same joiner
                agreed = agreed_pending(verdicts)
                if agreed is not None:
                    jhid, nonce = agreed
                    try:
                        sync = co.admit(hid, jhid, nonce,
                                        [step, rnd, restarts],
                                        name=run_tag + "join")
                        if sync is not None:
                            live = sorted(co.live_hosts())
                            self._retarget(trainer, base_axes, live,
                                           "elastic_grow",
                                           joined=[jhid], step=step)
                            known_live = live
                            tag = "%s_h%d_n%d" % (run_tag, jhid, nonce)
                            co.barrier("ship" + tag, hid)
                            self._ship_state(hid, trainer, live, jhid,
                                             step)
                            co.barrier("shipped" + tag, hid)
                            # the joiner copies between these barriers:
                            # our scope must not advance under its reads
                            co.barrier("done" + tag, hid)
                            # the admission is a common restore point:
                            # the joiner's dir misses every boundary
                            # saved while it was fenced
                            if step % ckpt_every != 0 and step != n:
                                trainer._save(step)
                            # the ring changed: re-seed every mailbox
                            # over the new membership at the sync step
                            self._buddy_send(co, hid, trainer, live,
                                             step, reset=True)
                    except HostLostError:
                        # fenced mid-admission: the same stop-competing
                        # path as a fence during the window gather
                        record_event("host_fenced", step=step)
                        got = self._rejoin_or_exit(hid, run_tag,
                                                   trainer, base_axes,
                                                   step)
                        if got is None:
                            return all_fetches
                        step, rnd, restarts = got
                        known_live = sorted(co.live_hosts())
                        continue
                if self._drain_after:
                    # the drain's membership is the frozen snapshot: a
                    # live query could differ between hosts
                    frozen_live = sorted(verdicts)
                    if since_drain is not None:
                        since_drain += 1
                    flags = self._drain_flags(verdicts, sdc=sdc)
                    for h in list(strag_counts):
                        if h not in flags:
                            strag_counts.pop(h)
                    for h, f in flags.items():
                        strag_counts[h] = strag_counts.get(h, 0) + 1 \
                            if f else 0
                    due = [h for h in frozen_live
                           if strag_counts.get(h, 0) >= self._drain_after]
                    # a straggler signature is asymmetric: when every
                    # live host latched there is no victim to drain
                    asym = due and len(due) < len(frozen_live) \
                        and len(frozen_live) > 1
                    if asym and len(frozen_live) - 1 \
                            < self._drain_floor_hosts():
                        record_event("drain_deferred", reason="floor",
                                     due=sorted(due), step=step)
                        asym = False
                        strag_counts.clear()
                    if asym and since_drain is not None \
                            and self._drain_cooldown \
                            and since_drain < self._drain_cooldown:
                        record_event("drain_deferred",
                                     reason="cooldown",
                                     due=sorted(due), step=step)
                        asym = False
                    if asym:
                        drained = min(due)
                        # full hysteresis: every count resets
                        strag_counts.clear()
                        since_drain = 0
                        was_sdc = sdc is not None \
                            and drained in sdc.suspects()
                        if was_sdc:
                            sdc.clear(drained)
                        record_event(
                            "elastic_drain", drained=drained, step=step,
                            capacity="%d/%d"
                            % (len(frozen_live) - 1,
                               self._coordinator.n_hosts),
                            windows=self._drain_after, sdc=was_sdc)
                        if drained == hid:
                            # a planned loss: fence ourselves at the
                            # boundary so the survivors shrink at once
                            co.mark_lost(
                                hid, "drained: %s for "
                                "%d consecutive windows"
                                % ("suspected SDC host" if was_sdc
                                   else "critical straggler",
                                   self._drain_after))
                            record_event("host_exit", step=step)
                            return all_fetches
                continue
            # -- transient: the pod-wide recovery of the parent --------
            # buddy generation this round can agree on: an uncommitted
            # fault round's mailboxes sit at this boundary
            bgen = step
            breason = None
            if self._buddy:
                from . import buddy as buddy_mod
                breason = buddy_mod.agree_plan(
                    co, hid, "%sb%d" % (run_tag, rnd), live, lost,
                    sorted(set(live) | set(lost)), bgen,
                    p2p=self._buddy_p2p)
            restarts += 1
            if restarts > self._max_restarts:
                record_event("giveup", step=step, restarts=restarts)
                raise RestartBudgetExceededError(
                    "pod restart budget (%d) exhausted at step %d; "
                    "last local error: %r" % (self._max_restarts,
                                              step, err))
            delay = trainer._policy.delay_s(restarts - 1)
            record_event("pod_restart", step=step, restarts=restarts,
                         error=type(err).__name__ if err else None,
                         backoff_s=delay)
            trainer._policy.sleep(delay)
            self._agree_poison(co, hid, run_tag, rnd, trainer, step,
                               err)
            # warm path first: adopt the agreed buddy generation
            got = self._buddy_restore(
                co, hid, run_tag, rnd, trainer, bgen, live, lost=lost,
                shardings=self._current_shardings(trainer),
                agreed=True, reason=breason)
            from_disk = got is None
            if from_disk:
                from .. import io as io_mod
                report = io_mod.scrub_checkpoint(trainer._ckpt_dir)
                agreed_step = co.elect_restore_step(
                    hid, report["valid_steps"],
                    name="%se%d" % (run_tag, rnd))
                got = trainer._restore(
                    step=agreed_step,
                    shardings=self._current_shardings(trainer))
            # the restored scope carries the LR (and its factor) from
            # save time: reconcile with the current capacity
            self._apply_lr_scale(trainer, live)
            if from_disk:
                # the disk rewind moved the pod below the mailbox
                # generations: re-seed them, reset= past the rewind fence
                self._buddy_send(co, hid, trainer, live, got, reset=True)
            record_event("pod_restore", step=got)
            step = got
        co.barrier(run_tag + "pod_end", hid)
        return all_fetches

    def _rejoin_or_exit(self, hid, run_tag, trainer, base_axes, step):
        """Fenced-host tail: announce a rejoin and wait for admission.
        Returns the adopted (step, rnd, restarts), or None when this host
        stays out (rejoin disabled or not admitted in time)."""
        co = self._coordinator
        if not self._rejoin:
            record_event("host_exit", step=step)
            return None
        nonce = self._next_nonce(hid)
        try:
            co.announce_join(hid, nonce)
            record_event("join_announce", nonce=nonce, step=step)
            sync = co.join(hid, nonce, name=run_tag + "join")
        except CoordinationError as e:
            # not admitted: stay out; a fenced host never forces its way
            # back
            record_event("rejoin_failed", error=type(e).__name__,
                         nonce=nonce)
            return None
        new_step, new_rnd, new_restarts = sync
        try:
            live = sorted(co.live_hosts())
            self._retarget(trainer, base_axes, live, "elastic_grow",
                           joined=[hid], step=new_step)
            tag = "%s_h%d_n%d" % (run_tag, hid, nonce)
            co.barrier("ship" + tag, hid)
            co.barrier("shipped" + tag, hid)
            self._receive_state(hid, trainer, live, new_step)
            co.barrier("done" + tag, hid)
            # persist the adopted state: the sync step becomes a step
            # valid on every live host, for a later consensus
            trainer._save(new_step)
            # the rejoin re-seed, mirroring the survivors'
            self._buddy_send(co, hid, trainer, live, new_step, reset=True)
        except HostLostError:
            # fenced again mid-admission: the survivors moved on
            record_event("rejoin_failed", error="HostLostError",
                         nonce=nonce)
            return None
        record_event("rejoin", step=new_step, nonce=nonce)
        return int(new_step), int(new_rnd), int(new_restarts)
