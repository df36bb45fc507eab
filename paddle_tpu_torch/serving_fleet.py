"""Serving fleet — multi-replica router with continuous micro-batching
on the coordination plane (counterpart of paddle_tpu/serving_fleet.py,
whole: the same router, member protocol, HTTP surface and series).

In this port a :class:`ReplicaMember` serves the port's exported
artifact (:func:`~.serving.load_serving_artifact`: a ``torch.export``
program a bucket, replayed as a CUDA graph a bucket) on
``CUDAPlace(0)`` unless the caller passes ``place=CPUPlace()``; with no
CUDA device it raises ``NoCUDADeviceError`` and never falls back to the
CPU. The router, :class:`FleetClient` and :class:`Autoscaler` hold no
tensors and take no place.

Reference parity: the reference inference stack serves fleets of C++
predictors behind load balancers (analysis_predictor + Anakin/TensorRT
deployments); :class:`~.serving.ServingPredictor` is one
replica in one process. This module is the fleet story: N predictor
replicas run as heartbeat-leased members of the
:class:`~.framework.transport.CoordServer` plane, and a stdlib-HTTP
router (the ``resilience.serve_metrics`` style — no dependencies)
fronts them with continuous micro-batching.

Topology (one coordination group of ``n_replicas + n_routers`` hosts,
growable by dynamic resize):

  host 0..N-1     :class:`ReplicaMember` — loads the exported serving
                  artifact, serves ``POST /infer`` over HTTP,
                  heartbeats the CoordServer (its liveness lease), and
                  runs the lockstep *control rounds* that agree
                  admissions.
  host N..N+R-1   :class:`FleetRouter` x R — the replicated front
                  door. Each router serves ``/infer`` independently
                  (clients rotate across them — :class:`FleetClient`);
                  every router is a full group member (it heartbeats,
                  joins control rounds), which is what makes a
                  single-replica fleet's restart admissible: a router
                  is always a survivor that can vote the joiner in.
  host >= N+R     replicas GROWN at runtime: the Autoscaler resizes
                  the group (``CoordServer`` ``resize`` op — new slots
                  are born fenced) and the spawned replica joins
                  through the ordinary announce/admit/join path.

Router HA (the replicated router tier): admission stays
frozen-verdict-based, but it is ENACTED (the joiner un-fenced) only by
the **admission leader** — the lowest live router id, judged from the
heartbeat leases. Leader
changes are term-stamped in the member registry (each router's info
blob carries ``lterm``): a takeover bumps the term past every
observed claim, incumbency is sticky (a restarted ex-leader rejoins
as a FOLLOWER), and a stale ex-leader's enactment is refused by the
term check it runs against the registry at enact time — the
transport's term-fencing discipline, re-hosted one layer up. Replicas
enact only when NO router holds a live-looking lease (the router-less
degraded fleet). Routers also share their per-replica in-flight
counts through their info blobs, so N routers' least-loaded dispatch
judges the REAL per-replica load, not each router's own slice — and a
failed-over request does not double-count.

Data plane (router):

  * **Continuous micro-batching.** In-flight requests are coalesced in
    arrival order up to ``max_batch`` request-batch rows or until the
    oldest request has waited ``batch_deadline_s``, whichever first;
    the coalesced feed rides ONE ``/infer`` call (list concatenation
    along the batch dim, split back per caller by the export's
    recorded batch factors — never guessed from runtime shapes).
  * **Least-loaded dispatch.** The routing table derives from the
    CoordServer ``members`` snapshot (registered info blobs minus the
    lost map); the live replica with the fewest router-dispatched
    batches in flight wins, equally-loaded replicas rotating
    round-robin so no healthy replica is ever shadowed.
  * **Shed / degrade.** A full router queue sheds with
    :class:`~.framework.resilience.ServerOverloadedError` (HTTP 503);
    per-replica policies (in-flight caps, cold-bucket degradation)
    keep working unchanged — a replica-side 503 is retried on a
    sibling, and only when every live replica sheds does the caller
    see 503.
  * **Retry on a sibling.** A dispatch that dies mid-flight
    (connection reset = SIGKILLed replica, replica 5xx) is retried on
    the least-loaded untried sibling within the request deadline, so
    a replica death costs zero failed requests — not even the ones in
    flight on it.

Control plane (the elastic path, verbatim from training):

  * **Replica death.** The heartbeat lease fences it (CoordServer's
    deadline monitor — nobody declares anything); the router's next
    members poll drops it from rotation and in-flight work re-routes.
  * **Restart.** The fresh process finds itself fenced and re-admits
    through the full ``announce_join``/``admit``/``join`` protocol:
    survivors observe the pending set on their next control round and
    all admit the same joiner from the same frozen verdicts — the
    ElasticTrainer window-boundary admission, re-hosted.
  * **Rolling weight refresh.** ``FleetRouter.rolling_deploy(dir)``
    drains ONE replica at a time: the replica fences itself (a
    planned loss, the ``drain_after`` shape), reloads + warms the new
    artifact while its HTTP server keeps answering (in-flight work
    completes on the old weights — zero dropped traffic), then
    rejoins through the same admission. The artifact movement is
    accounted like the rejoin state-ship: raw vs zlib-wire bytes land
    in ``resilience.bytes_totals()["stateship"]``.

Observability (rides ``resilience.metrics()`` — see the router series
there): ``router_requests_total{outcome=}``,
``router_retries_total{replica=}``, ``router_batch_size`` histogram,
``router_queue_depth`` and per-replica ``router_replica_inflight``
gauges — all cumulative counters outside the bounded event log, since
requests (and shed-storm retries) run at request rate. Rare
control-plane transitions (a connection-level ``router_retry``,
``fleet_deploy_*``, ``fleet_rejoin*``) ride the ordinary event log.
``python -m paddle_tpu_torch.tools.serving_probe --metrics-url`` folds
the ``router_*`` series under a ``"router"`` group.

Deploy via ``python -m paddle_tpu_torch.tools.servingsvc`` (one
``replica`` process per replica, one ``router``), against a
``python -m paddle_tpu_torch.tools.coordsvc`` service —
``--n-hosts auto`` learns the group size from the first member, and
``--hb-deadline-s`` MUST be armed (fleet liveness is the lease).

Coordination-plane HA: ``coord_address`` accepts a LIST of endpoints
(``"h:p0,h:p1"`` or a list) — a term-replicated coordsvc group
(``--peers`` mode). Every member's SocketCoordinator/CoordClient then
fails over transparently to the promoted standby, so a coordinator
SIGKILL — even mid rolling-deploy — fences nobody, drops no traffic
and aborts no admission: the fleet battery asserts exactly that.
"""
import collections
import json
import os
import random
import threading
import time

from .framework import faultinject
from .framework import obs
from .framework import resilience
from .framework.coordination import (CoordinationError, HostLostError,
                                     SocketCoordinator, agreed_pending)
from .framework.resilience import (DeadlineExceededError,
                                   ServerOverloadedError, record_event)

__all__ = ["FleetError", "FleetRouter", "ReplicaMember", "FleetClient",
           "Autoscaler", "router_host_id", "http_json"]


class FleetError(RuntimeError):
    """A fleet-level operation failed (deploy step, no live replica at
    start, a member that could not be admitted)."""


def router_host_id(n_replicas, router_id=0):
    """Router ``router_id``'s host id in the coordination group: base
    replicas are hosts ``0..N-1``, routers ``N..N+R-1`` (grown
    replicas, if any, sit above the router range)."""
    return int(n_replicas) + int(router_id)


# ---------------------------------------------------------------------------
# tiny JSON-over-HTTP wire helpers (stdlib only)
# ---------------------------------------------------------------------------

def http_json(method, url, payload=None, timeout_s=10.0, headers=None):
    """One JSON request/response round trip. Returns ``(status,
    dict)`` — non-2xx responses are returned, not raised, so callers
    can route on replica-side shed (503) vs deadline (504) vs error.
    Connection-level failures (dead process, refused) raise OSError.
    ``headers`` adds/overrides request headers (the trace-context
    ``x-trace-id`` rides here)."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(
        url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = resp.read().decode() or "{}"
            return resp.status, json.loads(body)
    except urllib.error.HTTPError as e:
        body = e.read().decode() if e.fp is not None else ""
        try:
            parsed = json.loads(body) if body else {}
        except ValueError:
            parsed = {"error": body}
        return e.code, parsed
    except urllib.error.URLError as e:
        # unwrap to the OSError the retry path classifies on
        reason = getattr(e, "reason", e)
        raise reason if isinstance(reason, OSError) \
            else ConnectionError(str(e))


def _start_http(handler_cls, host, port, name):
    import http.server

    class _Server(http.server.ThreadingHTTPServer):
        # the stdlib default listen backlog of 5 collapses a
        # connection-per-request burst: overflowed SYNs retransmit
        # after a full second, so a 24-client surge reaches the
        # router ~2 requests at a time and its queue/shed load
        # signals never see the pressure that is actually there
        request_queue_size = 128
        daemon_threads = True

    srv = _Server((host, port), handler_cls)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name=name)
    t.start()
    return srv, t


def _live_peers(co, self_id):
    """Un-fenced members with a live-looking lease, excluding
    ``self_id``. A lease older than the server's fencing deadline is
    a leftover from a cleanly-closed member (the hb map never forgets)
    — counting it as a survivor would make a member self-fence for a
    peer that cannot admit it back. Empty on a coordinator error."""
    try:
        m = co.members()
    except (CoordinationError, ConnectionError):
        return []
    deadline = m.get("hb_deadline_s")
    return [h for h, age in m["hb_age"].items()
            if h != self_id and h not in m["lost"]
            and (deadline is None or age <= deadline)]


def _device_counters(place):
    """This process's kernel launch counters (``module.counter``: a
    replayed graph is credited with the launches its capture counted)
    and, on a CUDA place, its device's peak allocated bytes: what a
    replica's ``/healthz`` adds to the predictor's health, so that an
    orchestrator (or a check) can see which kernels a replica's requests
    ran and what they cost in memory."""
    from .ops import kernels
    out = {"kernel_launches": {
        "%s.%s" % (mod.__name__.rsplit(".", 1)[-1], attr):
        getattr(mod, attr) for mod, attr in kernels.LAUNCH_COUNTERS}}
    device = place.torch_device()
    if device.type == "cuda":
        import torch
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


# the pieces a ship's wire bytes are deflated in, one thread each
_SHIP_CHUNK = 4 << 20


def _artifact_wire_bytes(dirname, compress="zlib"):
    """(raw, wire) byte sizes of the serving artifact under
    ``dirname`` — the rolling-refresh twin of the rejoin state-ship
    accounting. ``raw`` is the on-disk artifact; ``wire`` is what a
    zlib transport would move (== raw when compress is None): each file
    deflated in 4 MiB pieces on the port's I/O threads with Huffman
    coding only, as its checkpoints and state blobs are: the accounting
    runs inside a replica's refresh, ahead of its rejoin."""
    from concurrent.futures import ThreadPoolExecutor
    from .io import _IO_THREADS, _deflate
    from .serving import MODULE_SUBDIR
    root = os.path.join(dirname, MODULE_SUBDIR)
    raw = wire = 0
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        for fname in sorted(os.listdir(root)):
            path = os.path.join(root, fname)
            if not os.path.isfile(path):
                continue
            size = os.path.getsize(path)
            raw += size
            if compress != "zlib":
                wire += size
                continue
            with open(path, "rb") as f:
                data = f.read()
            pieces = [data[i:i + _SHIP_CHUNK]
                      for i in range(0, len(data), _SHIP_CHUNK)] or [b""]
            wire += sum(pool.map(
                lambda ip: len(_deflate(ip[1], ip[0] == len(pieces) - 1)),
                enumerate(pieces)))
    return raw, wire


# ---------------------------------------------------------------------------
# shared control-plane engine (router and replicas are both members)
# ---------------------------------------------------------------------------

class _FleetMember(object):
    """One heartbeat-leased member of the fleet's coordination group.

    Owns the :class:`SocketCoordinator` (hello + liveness lease) and
    the lockstep *control rounds*: every ``ctl_interval_s`` each live
    member gathers ``["ok", pending_joins]`` under a shared round
    counter, so all of them compute the same admission from the same
    frozen verdicts — the ElasticTrainer window-boundary agreement,
    without a training loop to ride on. A member that finds itself
    fenced (SIGKILL restart, deploy self-fence, a heartbeat stall)
    takes the announce/join path and adopts the survivors' round
    counter from the admission sync value, so round names never
    collide across incarnations."""

    def __init__(self, coord_address, n_replicas, host_id,
                 ctl_interval_s=0.1, hb_interval_s=0.25,
                 timeout_s=30.0, join_timeout_s=30.0, poll_s=0.005,
                 n_routers=1, group_size=None):
        if int(n_replicas) < 1:
            raise ValueError("a fleet needs n_replicas >= 1")
        if int(n_routers) < 1:
            raise ValueError("a fleet needs n_routers >= 1")
        self._coord_address = coord_address
        self.n_replicas = int(n_replicas)
        self.n_routers = int(n_routers)
        # group_size covers GROWN fleets: base replicas 0..N-1, routers
        # N..N+R-1, dynamically grown replicas above — a grown member
        # must hello with the group's CURRENT (post-resize) size
        self.group_size = int(group_size) if group_size is not None \
            else self.n_replicas + self.n_routers
        if self.group_size < self.n_replicas + self.n_routers:
            raise ValueError(
                "group_size %d is smaller than the base layout "
                "(%d replicas + %d routers)"
                % (self.group_size, self.n_replicas, self.n_routers))
        self._host_id = int(host_id)
        self._ctl_interval_s = float(ctl_interval_s)
        self._hb_interval_s = float(hb_interval_s)
        self._timeout_s = float(timeout_s)
        self._join_timeout_s = float(join_timeout_s)
        self._poll_s = float(poll_s)
        self._co = None
        self._k = 0
        self._stop = threading.Event()
        self._threads = []

    # -- subclass surface --------------------------------------------------
    def _prepare(self):
        """Bring the serving surface up BEFORE joining the group (a
        member must never advertise what it cannot serve)."""

    def _after_join(self):
        """Start whatever needs the live coordinator (pollers)."""

    def _sync_value(self):
        """This member's contribution to an admission round:
        ``[round_k, generation, artifact_dir]``. The joiner adopts the
        lexicographic max, so the router (no artifact) contributes
        generation -1 and defers to any replica's value."""
        return [self._k, -1, ""]

    def _adopt_sync(self, sync):
        self._k = int(sync[0])

    def _publish_info(self):
        """Publish this member's registry blob (``put_info``)."""

    # -- lifecycle ---------------------------------------------------------
    def _preflight_supersede(self):
        """A QUICK restart — before the previous incarnation's lease
        was fenced — must not start control rounds at counter 0 while
        the survivors sit at N: the desynced round names would wedge
        both sides' gathers. If the server holds a live-looking lease
        for this host id, fence it (supersede the dead incarnation)
        so this start takes the ordinary rejoin path and ADOPTS the
        survivors' counter from the admission sync.

        Returns the server's CURRENT group size (or ``None`` before
        the first sized hello / when unreachable): a restart after an
        autoscale resize must hello with the group's live size, not
        the base layout its command line froze at boot."""
        from .framework.transport import CoordClient
        server_size = None
        try:
            client = CoordClient(self._coord_address,
                                 host_id=self._host_id)
            try:
                resp = client.call("members")
                server_size = resp.get("n_hosts")
                has_lease = str(self._host_id) in resp.get("hb_age", {})
                fenced = str(self._host_id) in resp.get("lost", {})
                if has_lease and not fenced:
                    client.call("mark_lost",
                                reason="superseded: new incarnation "
                                "of member %d" % self._host_id)
                    record_event("fleet_supersede",
                                 member=self._host_id)
            finally:
                client.close()
        except (RuntimeError, OSError):
            # auto-size server before its first hello, or coordinator
            # unreachable: nothing to supersede — first-boot path
            pass
        return server_size

    def start(self):
        self._prepare()
        try:
            server_size = self._preflight_supersede()
            if server_size is not None \
                    and int(server_size) != self.group_size \
                    and int(server_size) \
                    >= self.n_replicas + self.n_routers:
                # the server's size is authoritative — a base member
                # restarted after an autoscale grow/shrink would
                # otherwise hello with its frozen boot-time size and
                # be refused with the RESIZED mismatch error forever
                record_event("fleet_adopt_group_size",
                             member=self._host_id,
                             configured=self.group_size,
                             adopted=int(server_size))
                self.group_size = int(server_size)
            # detect_loss=False: fleet liveness is EXCLUSIVELY the
            # heartbeat lease (the server monitor). Client-driven
            # fencing at gather deadlines is a training-plane fallback
            # that, on a desynced or wedged member, would mark_lost
            # every healthy peer — a timeout here surfaces as
            # BarrierTimeoutError and the tick simply retries.
            self._co = SocketCoordinator(
                self._coord_address, self.group_size,
                self._host_id, timeout_s=self._timeout_s,
                poll_s=self._poll_s, mesh_reinit=False,
                detect_loss=False, hb_interval_s=self._hb_interval_s)
            if self._host_id in self._co.lost_hosts():
                # a restarted incarnation: fenced by the previous
                # one's stale lease (or the preflight supersede) —
                # re-admit through the full protocol before taking
                # any traffic-facing role
                if not self._rejoin() and not self._solo_recover():
                    raise FleetError(
                        "member %d is fenced and was not admitted "
                        "within %.1fs — are the survivors (or the "
                        "router) up?"
                        % (self._host_id, self._join_timeout_s))
            self._publish_info()
            self._after_join()
            t = threading.Thread(target=self._control_loop,
                                 daemon=True,
                                 name="paddle_tpu-fleet-ctl-%d"
                                 % self._host_id)
            t.start()
            self._threads.append(t)
        except BaseException:
            # full teardown on ANY start failure (coordinator
            # unreachable, pod-size mismatch, not admitted):
            # _prepare() already bound the HTTP listener and threads,
            # and a supervisor retry loop must not accumulate one
            # live listener per failed attempt
            self.close()
            raise
        return self

    def _solo_recover(self):
        """Last member standing: a fenced member with NO other
        live-looking member has nobody to admit it — with nothing
        live there is no split brain to protect against either, so it
        un-fences itself and restarts the control plane fresh."""
        try:
            if _live_peers(self._co, self._host_id):
                return False
            self._co.unfence(self._host_id)
            record_event("fleet_solo_recover", member=self._host_id)
            return True
        except (CoordinationError, ConnectionError):
            return False

    def close(self):
        self._stop.set()
        # the client goes first: a control thread blocked in a gather
        # sees the closed transport raise and exits on the stop flag
        # instead of riding out a full round timeout
        if self._co is not None:
            self._co.close()
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the control rounds ------------------------------------------------
    def _control_loop(self):
        while not self._stop.is_set():
            try:
                self._ctl_tick()
            except Exception as e:   # noqa: BLE001 - the loop IS the
                # member's control plane: an unexpected error must cost
                # one tick, never the thread (a replica with no control
                # loop can never rejoin and wedges future admissions)
                record_event("fleet_ctl_error", member=self._host_id,
                             error=type(e).__name__)
            self._stop.wait(self._ctl_interval_s)

    def _ctl_tick(self):
        """One lockstep control round. Always returns True (the loop
        runs until close): a FENCED member attempts a rejoin and, when
        not admitted this attempt (a coordinator blip, survivors
        mid-recovery, a router restart), simply RETRIES next tick —
        a transient fence must never strand a serving member out of
        rotation for the life of the process."""
        co = self._co
        try:
            pending = sorted([int(h), int(n)] for h, n
                             in co.pending_joins().items())
        except (CoordinationError, ConnectionError):
            return True     # coordinator unreachable: serve on, retry
        self._k += 1
        try:
            verdicts = co.all_gather("ctl%d" % self._k, self._host_id,
                                     ["ok", pending])
        except HostLostError:
            record_event("fleet_fenced", member=self._host_id)
            if not self._rejoin():
                # nobody admitted us this attempt; if nobody live is
                # LEFT to admit (a 1-replica fleet whose router died),
                # recover solo — otherwise the next tick retries
                self._solo_recover()
            return True
        # admission from the frozen verdicts: every member meets the
        # SAME admission barrier for the first pending pair EVERY
        # participant observed — identical on all of them, so the join
        # barrier always completes (the invariant is shared with
        # ElasticTrainer's window admission). The un-fence itself is
        # ENACTED only by the admission leader (lowest live router id,
        # term-stamped — see FleetRouter._admission_enactor); everyone
        # else follows the barrier once the enactment lands.
        agreed = agreed_pending(verdicts)
        if agreed is not None:
            try:
                sync = co.admit(self._host_id, agreed[0], agreed[1],
                                self._sync_value(), name="fjoin",
                                timeout_s=self._join_timeout_s,
                                enact=self._admission_enactor())
                if sync is not None:
                    record_event("fleet_admit", member=self._host_id,
                                 joined=agreed[0])
            except HostLostError:
                record_event("fleet_fenced", member=self._host_id)
                if not self._rejoin():
                    self._solo_recover()
            except (CoordinationError, ConnectionError):
                return True
        return True

    def _admission_enactor(self):
        """Whether THIS member ENACTS (un-fences) the agreed admission.
        Base policy (replicas): only when no router holds a
        live-looking lease — the admission leader (lowest live router
        id) enacts, and replicas are the fallback for a router-less
        degraded fleet; FleetRouter overrides with the term-stamped
        leader check."""
        try:
            m = self._co.members()
        except (CoordinationError, ConnectionError):
            return True      # cannot judge: enacting is the safe side
        dl = m.get("hb_deadline_s")
        for h, info in m["info"].items():
            if isinstance(info, dict) and info.get("kind") == "router" \
                    and h not in m["lost"]:
                age = m["hb_age"].get(h)
                if age is not None and (dl is None or age <= dl):
                    return False
        return True

    def _rejoin(self):
        """Fenced-member tail: announce, wait for the survivors'
        admission, adopt their round counter (and, for replicas, the
        fleet's current artifact). Returns False when not admitted —
        the member stays out and the orchestrator escalates."""
        co = self._co
        nonce = random.getrandbits(31)
        try:
            co.announce_join(self._host_id, nonce)
            record_event("fleet_rejoin_announce", member=self._host_id,
                         nonce=nonce)
            sync = co.join(self._host_id, nonce, name="fjoin",
                           timeout_s=self._join_timeout_s)
        except (CoordinationError, ConnectionError) as e:
            record_event("fleet_rejoin_failed", member=self._host_id,
                         error=type(e).__name__)
            return False
        self._adopt_sync(sync)
        self._publish_info()
        record_event("fleet_rejoin", member=self._host_id)
        return True


# ---------------------------------------------------------------------------
# replica
# ---------------------------------------------------------------------------

class ReplicaMember(_FleetMember):
    """One serving replica: a :class:`~.serving.ServingPredictor`
    behind a stdlib HTTP endpoint, registered as a heartbeat-leased
    member of the fleet's coordination group.

    Endpoints:
      ``POST /infer``           {"feeds": {name: rows}, "deadline_s"?}
                                -> {"outputs", "dtypes", "replica",
                                "generation"}; 503 on the predictor's
                                in-flight shed, 504 on its deadline
      ``GET /healthz``          ServingPredictor.health() + identity
      ``GET /meta``             the export contract the router batches
                                by (feed names/factors/dtypes, buckets)
      ``POST /admin/refresh``   {"dir": artifact_dir} — queue the
                                rolling-deploy weight refresh (the
                                control thread executes it: self-fence,
                                reload + warm, rejoin)

    The per-replica policies are the predictor's own (``max_in_flight``
    load shed, ``deadline_s``, warm-bucket degradation) — the router
    composes with them, never replaces them.

    ``place`` (default ``CUDAPlace(0)``) is where every artifact this
    member loads is served; it is resolved at construction, so a member
    on a machine with no CUDA device raises ``NoCUDADeviceError``
    before it binds a port or joins the group."""

    def __init__(self, artifact_dir, coord_address, n_replicas,
                 replica_id, port=0, host="127.0.0.1", warmup=True,
                 max_in_flight=None, deadline_s=None,
                 ship_compress="zlib", artifact_compress=None,
                 ctl_interval_s=0.1,
                 hb_interval_s=0.25, timeout_s=30.0,
                 join_timeout_s=30.0, n_routers=1, group_size=None,
                 place=None):
        from .framework.place import _current_expected_place
        place = place if place is not None else _current_expected_place()
        place.torch_device()     # NoCUDADeviceError without a device
        rid = int(replica_id)
        gs = int(group_size) if group_size is not None \
            else int(n_replicas) + int(n_routers)
        router_lo = int(n_replicas)
        router_hi = int(n_replicas) + int(n_routers)
        # valid replica slots: the base tier below the routers, plus
        # dynamically GROWN slots above them (group resize)
        if not (0 <= rid < router_lo or router_hi <= rid < gs):
            raise ValueError(
                "replica_id %r is not a replica slot (%d base "
                "replicas, routers %d..%d, group size %d)"
                % (replica_id, n_replicas, router_lo, router_hi - 1,
                   gs))
        super(ReplicaMember, self).__init__(
            coord_address, n_replicas, rid,
            ctl_interval_s=ctl_interval_s, hb_interval_s=hb_interval_s,
            timeout_s=timeout_s, join_timeout_s=join_timeout_s,
            n_routers=n_routers, group_size=group_size)
        if ship_compress not in (None, "zlib"):
            raise ValueError("ship_compress must be None or 'zlib', "
                             "got %r" % (ship_compress,))
        if artifact_compress not in (None, "q8"):
            raise ValueError("artifact_compress must be None or 'q8', "
                             "got %r" % (artifact_compress,))
        self.replica_id = int(replica_id)
        self.place = place
        self._artifact_dir = str(artifact_dir)
        self._http_host = host
        self._http_port = int(port)
        self._warmup = bool(warmup)
        self._max_in_flight = max_in_flight
        self._deadline_s = deadline_s
        self._ship_compress = ship_compress
        self._artifact_compress = artifact_compress
        # deadline-budget guard counter: dispatched work refused
        # because its x-deadline-ms budget was already spent on
        # arrival. The router checks remaining budget immediately
        # before every send, so a live fleet holds this at ZERO — the
        # soak test counter-asserts it (a nonzero value means a
        # request WAS dispatched after expiry)
        self._expired_refused = 0
        self._pred = None
        self._pred_lock = threading.Lock()
        self._generation = 0
        self._refresh_req = None
        self._refresh_lock = threading.Lock()
        self._draining = False
        self._server = None
        self.address = None

    # -- serving surface ---------------------------------------------------
    def _prepare(self):
        # name this process's span dumps (deployment env wins)
        obs.set_service("replica%d" % self.replica_id, force=False)
        self._load_predictor(self._artifact_dir, account=False)
        member = self
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, status, payload):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):   # noqa: N802 - stdlib naming
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._send(400, {"error": "malformed JSON body"})
                    return
                path = self.path.split("?", 1)[0]
                if path == "/infer":
                    # the serve span adopts the router's (or a direct
                    # caller's) trace context from the x-trace-id
                    # header — the replica leg of the one-request
                    # timeline
                    tr, parent = obs.parse_header(
                        self.headers.get("x-trace-id"))
                    tenant = self.headers.get("x-tenant") \
                        or body.get("tenant") or "default"
                    with obs.span("replica.serve", trace_id=tr,
                                  parent=parent,
                                  replica=member.replica_id,
                                  generation=member.generation,
                                  tenant=tenant) as sp:
                        status, payload = member._handle_infer(
                            body, tenant=tenant,
                            deadline_ms=self.headers.get(
                                "x-deadline-ms"))
                        sp.set(status=status)
                    self._send(status, payload)
                elif path == "/admin/refresh":
                    new_dir = body.get("dir")
                    if not new_dir:
                        self._send(400, {"error": "refresh needs "
                                         '{"dir": artifact_dir}'})
                        return
                    if member.request_refresh(new_dir):
                        self._send(200, {"ok": True, "queued": new_dir})
                    else:
                        self._send(409, {"error": "a refresh is "
                                         "already queued"})
                elif path == "/admin/drain":
                    if member.drain():
                        self._send(200, {"ok": True, "draining": True})
                    else:
                        self._send(503, {"error": "drain could not "
                                         "reach the coordinator — "
                                         "retry"})
                else:
                    self._send(404, {"error": "try /infer"})

            def do_GET(self):    # noqa: N802 - stdlib naming
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._send(200, member.health())
                elif path == "/meta":
                    self._send(200, member.meta())
                elif path == "/admin/trace":
                    # live span pull: tools.traceview merges these
                    # across fleet members into one timeline
                    self._send(200, obs.dump_dict())
                else:
                    self._send(404, {"error": "try /healthz or /meta"})

            def log_message(self, *args):   # requests are not log lines
                pass

        self._server, t = _start_http(
            _Handler, self._http_host, self._http_port,
            "paddle_tpu-replica-%d" % self.replica_id)
        self._threads.append(t)
        self.address = "%s:%d" % self._server.server_address[:2]

    def _load_predictor(self, dirname, account=True, gen=None):
        """Load + warm a predictor from ``dirname`` and swap it in.
        ``account=True`` (every refresh after the first) records the
        artifact movement as state-ship bytes, the rolling-deploy twin
        of the elastic rejoin ship. ``gen`` pins the generation (a
        rejoiner adopting the fleet's current artifact takes the
        fleet's generation, not its own +1)."""
        from .serving import ServingPredictor
        pred = ServingPredictor(dirname,
                                max_in_flight=self._max_in_flight,
                                deadline_s=self._deadline_s,
                                place=self.place)
        if self._artifact_compress == "q8" \
                and pred.weight_compress != "q8":
            # deploy-time guard: a replica provisioned for quantized
            # artifacts (the shrunken ship-bytes budget) must refuse a
            # full-precision artifact at LOAD, not discover the 4x
            # state-ship blowup on its next rolling deploy
            raise FleetError(
                "replica %d runs with artifact_compress='q8' but %s "
                "is a full-precision export — re-export it with "
                "weight_compress='q8'" % (self.replica_id, dirname))
        if self._warmup:
            pred.warmup()
        if account:
            try:
                raw, wire = _artifact_wire_bytes(dirname,
                                                 self._ship_compress)
                resilience.record_bytes("stateship", raw, wire)
            except OSError:   # accounting must never fail a deploy
                pass
        with self._pred_lock:
            self._pred = pred
            self._artifact_dir = str(dirname)
            self._generation = self._generation + 1 if gen is None \
                else int(gen)

    def _predictor(self):
        with self._pred_lock:
            return self._pred

    @property
    def generation(self):
        with self._pred_lock:
            return self._generation

    def health(self):
        pred = self._predictor()
        snap = pred.health()
        with self._pred_lock:
            expired_refused = self._expired_refused
        snap.update({"replica": self.replica_id,
                     "generation": self.generation,
                     "artifact_dir": self._artifact_dir,
                     "expired_refused": expired_refused})
        snap.update(_device_counters(self.place))
        return snap

    def meta(self):
        pred = self._predictor()
        return {"feed_names": pred.get_input_names(),
                "fetch_names": pred.get_output_names(),
                "feed_batch_factors": pred.feed_batch_factors(),
                "fetch_batch_factors": pred.fetch_batch_factors(),
                "feed_dtypes": pred.feed_dtypes(),
                "feed_inner_shapes": pred.feed_inner_shapes(),
                "dynamic_batch": pred.dynamic_batch,
                "max_bucket": pred.max_bucket}

    def _handle_infer(self, body, tenant=None, deadline_ms=None):
        import numpy as np
        pred = self._predictor()
        feeds_json = body.get("feeds")
        if not isinstance(feeds_json, dict):
            return 400, {"error": 'infer needs {"feeds": {name: rows}}'}
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return 400, {"error": "deadline_s must be a number, "
                             "got %r" % (deadline_s,)}
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError):
                return 400, {"error": "x-deadline-ms must be a "
                             "number, got %r" % (deadline_ms,)}
            if deadline_ms <= 0:
                # the propagated budget is already SPENT: refuse
                # before the predictor burns a batch slot — the
                # caller's _finish_pending gave up long ago, so any
                # work here is pure waste (satellite guard; the
                # "replica" series must stay 0 in a healthy fleet)
                with self._pred_lock:
                    self._expired_refused += 1
                resilience.record_router_expired("replica",
                                                 tenant=tenant)
                return 504, {"error": "deadline budget exhausted "
                             "before serving — refused without "
                             "entering the batch window",
                             "kind": "deadline"}
            budget_s = deadline_ms / 1000.0
            deadline_s = budget_s if deadline_s is None \
                else min(deadline_s, budget_s)
        dtypes = pred.feed_dtypes()
        try:
            feeds = {n: np.asarray(v, dtype=np.dtype(dtypes[n]))
                     for n, v in feeds_json.items() if n in dtypes}
            # an injected raise surfaces as this replica's 500 — the
            # router treats it like any replica fault and retries the
            # batch on a sibling (``host`` filter = this replica's id)
            feeds = faultinject.hit("serving.infer", feeds,
                                    host=self.replica_id)
            if feeds is faultinject.DROP:
                raise RuntimeError("serving.infer: request dropped by "
                                   "failpoint")
            outs = pred.run(feeds, deadline_s=deadline_s)
        except ServerOverloadedError as e:
            return 503, {"error": str(e), "kind": "overloaded"}
        except DeadlineExceededError as e:
            return 504, {"error": str(e), "kind": "deadline"}
        except Exception as e:
            return 500, {"error": "%s: %s" % (type(e).__name__, e),
                         "kind": "error"}
        outs = [np.asarray(o) for o in outs]
        return 200, {"outputs": [o.tolist() for o in outs],
                     "dtypes": [str(o.dtype) for o in outs],
                     "replica": self.replica_id,
                     "generation": self.generation}

    # -- control plane -----------------------------------------------------
    def _publish_info(self, ready=True):
        try:
            self._co.put_info({"kind": "replica", "addr": self.address,
                               "gen": self.generation,
                               "dir": self._artifact_dir,
                               "ready": bool(ready)})
        except (CoordinationError, ConnectionError):
            pass   # the next publish (rejoin/deploy) retries

    def _sync_value(self):
        return [self._k, self.generation, self._artifact_dir]

    def _adopt_sync(self, sync):
        self._k = int(sync[0])
        sync_gen = int(sync[1]) if len(sync) > 1 else -1
        sync_dir = sync[2] if len(sync) > 2 else ""
        # The admission sync orders by round counter FIRST, so it can
        # carry a router-only survivor's [k, -1, ""] (1-replica fleet)
        # or a counter-leading member's lagging artifact view. The
        # member registry holds every replica's last published
        # (gen, dir) — including THIS id's previous incarnation — so
        # the fleet's true current artifact is the max over both.
        try:
            m = self._co.members()
            for info in m["info"].values():
                if isinstance(info, dict) \
                        and info.get("kind") == "replica" \
                        and info.get("dir") \
                        and int(info.get("gen") or -1) > sync_gen:
                    sync_gen = int(info["gen"])
                    sync_dir = info["dir"]
        except (CoordinationError, ConnectionError):
            pass
        # adopt the fleet's artifact only when it is genuinely NEWER
        # (a higher fleet generation): a deploy-refreshed replica
        # rejoining must not be flipped BACK to the survivors' not-yet-
        # refreshed artifact by its own admission sync
        if sync_dir and sync_gen > self.generation \
                and sync_dir != self._artifact_dir \
                and os.path.isdir(sync_dir):
            try:
                self._load_predictor(sync_dir, gen=sync_gen)
                record_event("fleet_adopt", member=self._host_id,
                             generation=sync_gen)
            except Exception as e:
                record_event("fleet_adopt_failed", member=self._host_id,
                             error=type(e).__name__)

    def request_refresh(self, artifact_dir):
        """Queue a rolling-deploy weight refresh; the control thread
        executes it at its next tick (fence -> reload + warm -> rejoin
        — the HTTP server answers throughout, so in-flight and
        concurrent requests ride the old weights, never the floor).
        Returns False (HTTP 409) while another refresh is already
        queued — a racing second deploy must not silently overwrite
        the first (the test-and-set is locked against both a
        concurrent second request and the control thread's claim)."""
        with self._refresh_lock:
            if self._refresh_req is not None:
                return False
            self._refresh_req = str(artifact_dir)
        return True

    def drain(self):
        """PLANNED scale-in (the Autoscaler's shrink path): fence
        self, stop rejoining, and unpublish — in-flight requests still
        complete (the HTTP server keeps answering), but the routing
        tables drop this replica on their next poll and the drained
        slot can then be resized away. Returns False when the
        coordinator was unreachable (the caller retries)."""
        with self._refresh_lock:
            self._draining = True
        try:
            self._co.mark_lost(self._host_id,
                               "autoscale: drained for scale-in")
        except (CoordinationError, ConnectionError):
            with self._refresh_lock:
                self._draining = False
            return False
        self._publish_info(ready=False)
        record_event("fleet_drained", member=self._host_id)
        return True

    def _ctl_tick(self):
        with self._refresh_lock:
            if self._draining:
                # a drained member neither gathers nor rejoins: it is
                # leaving the group for good (the slot is resized away)
                return True
            req, self._refresh_req = self._refresh_req, None
        if req is not None:
            self._do_refresh(req)
            return True
        return super(ReplicaMember, self)._ctl_tick()

    def _other_live_members(self):
        """Un-fenced members with a LIVE-LOOKING lease besides this
        one — when empty (a one-replica fleet with no router, or the
        router cleanly shut down), the fence/rejoin dance has no
        survivor to admit us back, so a refresh swaps in place. A
        lease older than the server's own fencing deadline does not
        count: a cleanly-closed member's entry lingers in the hb map,
        and self-fencing on the strength of a peer that cannot admit
        would strand this replica."""
        return _live_peers(self._co, self._host_id)

    def _do_refresh(self, new_dir):
        record_event("fleet_deploy_begin", member=self._host_id,
                     dir=new_dir)
        survivors = self._other_live_members()
        if survivors:
            # a PLANNED loss (the drain shape): the router stops
            # routing here the moment its members poll sees the
            # tombstone; accepted work still completes
            try:
                self._co.mark_lost(self._host_id,
                                   "deploy: rolling weight refresh")
            except (CoordinationError, ConnectionError) as e:
                # coordinator unreachable: the admission protocol
                # cannot complete either — abort this refresh on the
                # OLD weights (the rolling deploy times out and
                # reports) instead of fencing into a dead end
                record_event("fleet_deploy_failed",
                             member=self._host_id,
                             error=type(e).__name__)
                return
        try:
            self._load_predictor(new_dir)
        except Exception as e:
            record_event("fleet_deploy_failed", member=self._host_id,
                         error=type(e).__name__)
            # return to rotation on the OLD weights — a broken artifact
            # must degrade the deploy, not the fleet
            if survivors:
                self._rejoin()
            else:
                self._publish_info()
            return
        if survivors:
            if not self._rejoin():
                record_event("fleet_deploy_stranded",
                             member=self._host_id)
                return
        else:
            self._publish_info()
        record_event("fleet_deploy_done", member=self._host_id,
                     generation=self.generation)

    def close(self):
        if self._co is not None:
            self._publish_info(ready=False)
        # HTTP first: its serve_forever thread sits in _threads, and
        # the base close joins them — a still-serving listener would
        # ride out the whole join timeout
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        super(ReplicaMember, self).close()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

DEFAULT_TENANT = "default"


class TenantClass(object):
    """One QoS class: the knobs a router schedules a tenant by.

    ``weight``       weighted-fair share of the batch cut (start-time
                     fair queuing — a weight-4 class drains 4x a
                     weight-1 class's rows under contention)
    ``priority``     brownout rank: under sustained overload the
                     router sheds the LOWEST live priority first; the
                     highest class is never floor-shed
    ``rate``/``burst``   token-bucket admission quota (requests/s,
                     bucket size; None = unmetered)
    ``max_inflight`` per-tenant cap on requests admitted and not yet
                     finished (None = uncapped)
    ``tenants``      explicit tenant ids mapped to this class; a
                     tenant naming no class maps by its own name,
                     else to the "default" class"""

    __slots__ = ("name", "weight", "priority", "rate", "burst",
                 "max_inflight", "tenants")

    def __init__(self, name, weight=1.0, priority=0, rate=None,
                 burst=None, max_inflight=None, tenants=()):
        self.name = str(name)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("tenant class %r needs weight > 0, got "
                             "%r" % (name, weight))
        self.priority = int(priority)
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError("tenant class %r needs rate > 0 (or "
                             "None), got %r" % (name, rate))
        if burst is not None:
            self.burst = float(burst)
        else:
            self.burst = None if self.rate is None \
                else max(1.0, self.rate)
        if self.burst is not None and self.burst < 1:
            raise ValueError("tenant class %r needs burst >= 1, got "
                             "%r" % (name, burst))
        self.max_inflight = None if max_inflight is None \
            else int(max_inflight)
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("tenant class %r needs max_inflight >= 1"
                             " (or None), got %r"
                             % (name, max_inflight))
        self.tenants = frozenset(str(t) for t in tenants)


def parse_tenant_classes(spec):
    """{class_name: TenantClass} from a config mapping (or a list of
    dicts carrying "name") — the ``--tenant-classes`` JSON shape:

        {"gold":   {"weight": 4, "priority": 2},
         "silver": {"weight": 2, "priority": 1},
         "bronze": {"weight": 1, "priority": 0,
                    "rate": 50, "max_inflight": 8,
                    "tenants": ["batch-jobs", "crawler"]}}

    Empty/None disables QoS entirely (the router runs the classic
    single-FIFO path)."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        items = spec.items()
    else:
        items = [(c.get("name"), c) for c in spec]
    out = {}
    for name, cfg in items:
        if name is None:
            raise ValueError("tenant class list entries need a "
                             '"name" key')
        cfg = {k: v for k, v in dict(cfg or {}).items() if k != "name"}
        unknown = set(cfg) - {"weight", "priority", "rate", "burst",
                              "max_inflight", "tenants"}
        if unknown:
            raise ValueError("tenant class %r has unknown keys %s"
                             % (name, sorted(unknown)))
        out[str(name)] = TenantClass(name, **cfg)
    return out


class _Pending(object):
    __slots__ = ("feeds", "n", "deadline", "enqueued", "event",
                 "result", "error", "abandoned", "trace", "span",
                 "t_enq", "tenant", "retry_budget", "vstart",
                 "vfinish")

    def __init__(self, feeds, n, deadline, tenant=DEFAULT_TENANT,
                 retry_budget=None):
        self.feeds = feeds
        self.n = n
        self.deadline = deadline
        self.enqueued = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False
        # trace context (obs tentpole): the request's trace id, the
        # router serve span the queue/dispatch child spans parent
        # under, and the obs-time enqueue stamp the retroactive queue
        # span starts at — all None while tracing is off
        self.trace = None
        self.span = None
        self.t_enq = None
        # QoS context: the owning tenant, the bounded cross-hop retry
        # budget (None = unbounded, the historical behavior) and the
        # start-time-fair-queuing virtual tags the WFQ cut orders by
        self.tenant = tenant
        self.retry_budget = retry_budget
        self.vstart = 0.0
        self.vfinish = 0.0


class FleetRouter(_FleetMember):
    """The fleet's front door: continuous micro-batching over the live
    replica set.

    Endpoints:
      ``POST /infer``          same body as a replica's; coalesced,
                               dispatched, split back — the caller
                               cannot tell the fleet from one replica
      ``GET /healthz``         routing table + queue depth
      ``GET /metrics``         the live resilience exposition (router
                               series included)
      ``POST /admin/deploy``   {"dir": artifact_dir} — rolling weight
                               refresh across every live replica, one
                               at a time (synchronous; zero dropped
                               traffic)

    The router is itself a group member (host ``n_replicas``): it
    heartbeats, votes in control rounds and admits rejoining replicas
    — so even a 1-replica fleet has a survivor to re-admit a
    restarted replica, and a restarted ROUTER re-admits itself the
    same way (serving continues meanwhile: routing needs only the
    members snapshot, not membership)."""

    # completed/in-flight request tokens kept for idempotent replay
    # (a FleetClient that failed over back, or re-sent after a torn
    # response) — bounded so a long-lived router cannot grow forever
    TOKEN_CACHE = 4096

    def __init__(self, coord_address, n_replicas, port=0,
                 host="127.0.0.1", max_batch=8, batch_deadline_s=0.005,
                 max_queue=128, request_deadline_s=10.0,
                 poll_interval_s=0.05, ctl_interval_s=0.1,
                 hb_interval_s=0.25, timeout_s=30.0,
                 join_timeout_s=30.0, router_id=0, n_routers=1,
                 group_size=None, tenant_classes=None,
                 brownout_queue_depth=None, brownout_shed_rate=0.5,
                 qos_interval_s=0.1, qos_hysteresis=3):
        if not 0 <= int(router_id) < int(n_routers):
            raise ValueError("router_id %r out of range for %d "
                             "routers" % (router_id, n_routers))
        super(FleetRouter, self).__init__(
            coord_address, n_replicas,
            router_host_id(n_replicas, router_id),
            ctl_interval_s=ctl_interval_s, hb_interval_s=hb_interval_s,
            timeout_s=timeout_s, join_timeout_s=join_timeout_s,
            n_routers=n_routers, group_size=group_size)
        if int(max_batch) < 1:
            raise ValueError("max_batch must be >= 1")
        self.router_id = int(router_id)
        self._http_host = host
        self._http_port = int(port)
        self.max_batch = int(max_batch)
        self.batch_deadline_s = float(batch_deadline_s)
        self.max_queue = int(max_queue)
        self.request_deadline_s = float(request_deadline_s)
        self._poll_interval_s = float(poll_interval_s)
        self._queue = collections.deque()
        self._qcond = threading.Condition()
        # -- multi-tenant QoS (tentpole). No classes configured =
        # QoS OFF: every request takes the classic single-FIFO path
        # bit-for-bit; the per-tenant structures below stay empty.
        self._classes = parse_tenant_classes(tenant_classes)
        self._qos = bool(self._classes)
        self._class_default = self._classes.get(
            DEFAULT_TENANT, TenantClass(DEFAULT_TENANT))
        self._tenant_to_class = {}
        for c in self._classes.values():
            for t in c.tenants:
                self._tenant_to_class[t] = c
        # WFQ state, all under _qcond: per-tenant FIFO queues, the
        # start-time-fair-queuing virtual clock, and per-tenant
        # {finish tag, token bucket, inflight} scheduler state
        self._tqueues = {}
        self._tstate = {}
        self._vclock = 0.0
        # brownout (priority shed): the enacted verdict is a MINIMUM
        # admissible priority, escalated/relaxed only by the QoS
        # sampling thread on hysteresis streaks — admission reads the
        # frozen verdict, never the raw signals (the autoscaler's
        # frozen-signal discipline)
        self._bo_floor = None
        self._bo_levels = sorted(set(
            [c.priority for c in self._classes.values()]
            + [self._class_default.priority]))
        self._bo_hot = 0
        self._bo_cool = 0
        self._bo_prev = None
        self._brownout_queue_depth = (
            max(2, int(0.75 * int(max_queue)))
            if brownout_queue_depth is None
            else int(brownout_queue_depth))
        self._brownout_shed_rate = float(brownout_shed_rate)
        self._qos_interval_s = float(qos_interval_s)
        self._qos_hysteresis = int(qos_hysteresis)
        self._members_lock = threading.Lock()
        self._members = {}
        self._members_sig = None
        self._inflight = {}
        self._peer_inflight = {}
        self._peer_router_load = {}
        self._pick_seq = 0
        self._meta = None
        self._meta_lock = threading.Lock()
        self._deploy_lock = threading.Lock()
        # admission-leader state (term-stamped in the member registry)
        self._leader_lock = threading.Lock()
        self._is_leader = False
        self._leader_term = 0
        self._pub_sig = None
        # idempotent request replay: token -> _Pending (completed
        # entries keep their result until evicted)
        self._tokens = collections.OrderedDict()
        self._token_lock = threading.Lock()
        self._server = None
        self.address = None
        self.url = None

    # -- lifecycle ---------------------------------------------------------
    def _prepare(self):
        obs.set_service("router%d" % self.router_id, force=False)
        router = self
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, status, payload, raw=None):
                body = raw if raw is not None \
                    else json.dumps(payload).encode()
                self.send_response(status)
                ctype = "application/json" if raw is None else \
                    "text/plain; version=0.0.4; charset=utf-8"
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):   # noqa: N802 - stdlib naming
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    self._send(400, {"error": "malformed JSON body"})
                    return
                path = self.path.split("?", 1)[0]
                if path == "/infer":
                    self._send(*router._handle_infer(
                        body,
                        trace_header=self.headers.get("x-trace-id"),
                        headers={
                            "x-tenant":
                                self.headers.get("x-tenant"),
                            "x-deadline-ms":
                                self.headers.get("x-deadline-ms"),
                            "x-retry-budget":
                                self.headers.get("x-retry-budget")}))
                elif path == "/admin/deploy":
                    new_dir = body.get("dir")
                    if not new_dir:
                        self._send(400, {"error": "deploy needs "
                                         '{"dir": artifact_dir}'})
                        return
                    try:
                        timeout = float(
                            body.get("per_replica_timeout_s", 60.0))
                    except (TypeError, ValueError):
                        self._send(400, {"error":
                                         "per_replica_timeout_s must "
                                         "be a number"})
                        return
                    try:
                        summary = router.rolling_deploy(
                            new_dir, per_replica_timeout_s=timeout)
                        self._send(200, summary)
                    except FleetError as e:
                        self._send(500, {"error": str(e)})
                else:
                    self._send(404, {"error": "try /infer"})

            def do_GET(self):    # noqa: N802 - stdlib naming
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    text = resilience.metrics_text(
                        resilience.metrics(by_host=True))
                    self._send(200, None, raw=text.encode())
                elif path == "/healthz":
                    self._send(200, router.health())
                elif path == "/admin/trace":
                    self._send(200, obs.dump_dict())
                else:
                    self._send(404, {"error": "try /infer, /healthz "
                                     "or /metrics"})

            def log_message(self, *args):
                pass

        self._server, t = _start_http(
            _Handler, self._http_host, self._http_port,
            "paddle_tpu-fleet-router")
        self._threads.append(t)
        self.address = "%s:%d" % self._server.server_address[:2]
        self.url = "http://%s" % self.address
        bt = threading.Thread(target=self._batch_loop, daemon=True,
                              name="paddle_tpu-fleet-batcher")
        bt.start()
        self._threads.append(bt)
        if self._qos:
            qt = threading.Thread(target=self._qos_loop, daemon=True,
                                  name="paddle_tpu-fleet-qos")
            qt.start()
            self._threads.append(qt)

    def _after_join(self):
        pt = threading.Thread(target=self._members_loop, daemon=True,
                              name="paddle_tpu-fleet-members")
        pt.start()
        self._threads.append(pt)
        self._refresh_members()

    def _publish_info(self):
        """Advertise this router's blob: address (clients/tools
        discover the tier), its admission-leader claim (``lterm`` /
        ``leader`` — the term stamp a stale ex-leader is refused by),
        its per-replica in-flight counts (so sibling routers'
        least-loaded dispatch sees the REAL load, not just their own
        slice) and its queue/shed load signals (so the admission
        leader's autoscaler sees overload concentrated on a FOLLOWER
        — clients pin one endpoint, and in a multi-process tier the
        leader cannot read a sibling's process-local counters)."""
        with self._members_lock:
            inflight = {str(h): int(n)
                        for h, n in self._inflight.items() if n}
        with self._leader_lock:
            lterm, leader = self._leader_term, self._is_leader
        queue, shed, total = self._load_signals()
        try:
            self._co.put_info({"kind": "router", "addr": self.address,
                               "url": self.url,
                               "router_id": self.router_id,
                               "lterm": lterm, "leader": leader,
                               "inflight": inflight, "ready": False,
                               "queue": queue, "shed": shed,
                               "reqs": total,
                               "hq": self.high_priority_queue_depth()})
        except (CoordinationError, ConnectionError):
            return False
        return True

    def close(self):
        self._stop.set()
        with self._qcond:
            # requests still waiting to be coalesced will never be
            # dispatched: fail them NOW instead of letting each
            # caller block out its full request deadline
            stranded = list(self._queue)
            self._queue.clear()
            for q in self._tqueues.values():
                stranded.extend(q)
                q.clear()
            self._qcond.notify_all()
        self._fail(stranded, ServerOverloadedError(
            "router is closing — retry against its replacement"))
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        super(FleetRouter, self).close()

    # -- membership --------------------------------------------------------
    def _members_loop(self):
        while not self._stop.wait(self._poll_interval_s):
            self._refresh_members()

    def _refresh_members(self):
        try:
            m = self._co.members()
        except (CoordinationError, ConnectionError):
            return   # keep the last known table; the poll retries
        dl = m.get("hb_deadline_s")
        table, routers = {}, {}
        peer_inflight, peer_rload = {}, {}
        for h, info in m["info"].items():
            if not isinstance(info, dict) or h in m["lost"]:
                continue
            if info.get("kind") == "router":
                age = m["hb_age"].get(h)
                live = h == self._host_id or (
                    age is not None and (dl is None or age <= dl))
                if not live:
                    continue
                routers[h] = info
                if h != self._host_id:
                    for rid, n in (info.get("inflight") or {}).items():
                        try:
                            rid = int(rid)
                        except (TypeError, ValueError):
                            continue
                        peer_inflight[rid] = \
                            peer_inflight.get(rid, 0) + int(n)
                    peer_rload[h] = {
                        "queue": int(info.get("queue") or 0),
                        "shed": int(info.get("shed") or 0),
                        "reqs": int(info.get("reqs") or 0),
                        "hq": int(info.get("hq") or 0)}
                continue
            if info.get("kind") != "replica" \
                    or not info.get("ready") or not info.get("addr"):
                continue
            table[h] = {"addr": info["addr"],
                        "gen": info.get("gen"),
                        "dir": info.get("dir"),
                        "hb_age": m["hb_age"].get(h, 0.0)}
        # any artifact change in the table (a deploy step landing, a
        # direct per-replica /admin/refresh) invalidates the cached
        # export contract — batches must never be merged/split by a
        # stale factor map while replicas already serve a new artifact
        sig = tuple(sorted((h, v["gen"], v["dir"])
                           for h, v in table.items()))
        with self._members_lock:
            self._members = table
            self._peer_inflight = peer_inflight
            self._peer_router_load = peer_rload
        if sig != self._members_sig:
            self._members_sig = sig
            with self._meta_lock:
                self._meta = None
        self._update_leadership(m, routers)
        self._maybe_publish()

    def _update_leadership(self, m, routers):
        """Admission-leader election from the live member snapshot.
        Incumbency is STICKY: the live-looking router advertising the
        highest leader claim keeps the lease (a restarted ex-leader
        rejoins as a follower); only when no live claim exists does
        the lowest live router id take over, with a term bumped past
        every observed claim — the transport's term discipline."""
        with self._leader_lock:
            my_term, was_leader = self._leader_term, self._is_leader
        fenced = self._host_id in m["lost"]
        claims = []       # (lterm, router_host_id) of live claimants
        max_term = my_term
        for h, info in routers.items():
            term = int(info.get("lterm") or 0)
            if h == self._host_id:
                # the registry may lag our own state: use it live
                term, is_leader = my_term, was_leader and not fenced
            else:
                is_leader = bool(info.get("leader"))
            max_term = max(max_term, term)
            if is_leader:
                claims.append((term, h))
        # highest term wins; a same-term double claim (two routers that
        # raced the first election) breaks to the LOWEST router id
        incumbent = max(claims, key=lambda c: (c[0], -c[1])) \
            if claims else None
        if incumbent is not None and incumbent[0] >= max_term:
            leader_id = incumbent[1]
            new_term = incumbent[0]
        else:
            leader_id = min(routers) if routers else None
            new_term = max_term + 1     # takeover: fence every claim
        changed = False
        with self._leader_lock:
            if fenced or leader_id != self._host_id:
                if self._is_leader:
                    record_event("fleet_leader_demote",
                                 router=self._host_id, term=max_term)
                    changed = True
                self._is_leader = False
                if max_term > self._leader_term:
                    self._leader_term = max_term
                    changed = True
            elif not self._is_leader:
                self._is_leader = True
                self._leader_term = max(new_term, self._leader_term)
                record_event("fleet_leader_elect",
                             router=self._host_id,
                             term=self._leader_term)
                changed = True
            term_now = self._leader_term
        if changed:
            record_event("fleet_leader_term", router=self._host_id,
                         term=term_now)

    def _maybe_publish(self):
        """Republish the info blob only when it changed (leadership,
        the in-flight map, or the queue/shed load signals) — put_info
        is a sync-replicated op and must not run at poll rate for an
        IDLE router (an idle router's queue is 0 and its counters are
        static, so the signature holds still)."""
        with self._members_lock:
            inflight = tuple(sorted((h, int(n))
                             for h, n in self._inflight.items() if n))
        load = self._load_signals() + (
            self.high_priority_queue_depth(),)
        with self._leader_lock:
            sig = (self._is_leader, self._leader_term, inflight, load)
        # cache the signature only once the put LANDED: a publish
        # swallowed during a coordinator failover must be retried on
        # the next poll, or siblings read a stale leader claim and
        # stale in-flight counts until the state next changes
        if sig != self._pub_sig and self._publish_info():
            self._pub_sig = sig

    def is_leader(self):
        """Whether this router currently holds the admission lease."""
        with self._leader_lock:
            return self._is_leader

    @property
    def leader_term(self):
        with self._leader_lock:
            return self._leader_term

    def queue_depth(self):
        with self._qcond:
            return self._qdepth_locked()

    def _qdepth_locked(self):
        # exactly one of the two layouts holds requests: the single
        # FIFO (QoS off) or the per-tenant WFQ queues (QoS on)
        return len(self._queue) + sum(len(q)
                                      for q in self._tqueues.values())

    def high_priority_queue_depth(self):
        """Waiting requests belonging to the HIGHEST-priority class —
        the autoscaler's class-aware pressure signal: sustained
        high-class queueing grows the fleet even while total depth
        looks tame (the brownout already shed the rest). 0 when QoS
        is off."""
        if not self._qos:
            return 0
        hi = self._bo_levels[-1]
        with self._qcond:
            return sum(len(q) for t, q in self._tqueues.items()
                       if self._class_of(t).priority >= hi)

    def _load_signals(self):
        """``(queue_depth, shed_total, requests_total)`` for THIS
        router — its process-local slice of the fleet-wide autoscale
        signal (shared with siblings through the info blob)."""
        totals = resilience.router_totals(by_router=True).get(
            str(self._host_id), None)
        reqs = (totals or {"requests": {}})["requests"]
        return (self.queue_depth(), int(reqs.get("shed", 0)),
                int(sum(reqs.values())))

    def peer_router_load(self):
        """{router_host_id: {"queue", "shed", "reqs"}} last read from
        each live SIBLING router's info blob."""
        with self._members_lock:
            return {h: dict(v)
                    for h, v in self._peer_router_load.items()}

    def _admission_enactor(self):
        """Only the admission leader enacts — and even the leader
        re-checks the member registry AT ENACT TIME: a higher term
        stamped by any router means we are the stale ex-leader the
        term fence exists for, and the enactment is refused."""
        with self._leader_lock:
            if not self._is_leader:
                return False
            term = self._leader_term
        try:
            m = self._co.members()
        except (CoordinationError, ConnectionError):
            return False
        if self._host_id in m["lost"]:
            return False
        for h, info in m["info"].items():
            if h != self._host_id and isinstance(info, dict) \
                    and info.get("kind") == "router" \
                    and int(info.get("lterm") or 0) > term:
                with self._leader_lock:
                    self._is_leader = False
                    self._leader_term = max(self._leader_term,
                                            int(info["lterm"]))
                record_event("fleet_leader_stale",
                             router=self._host_id,
                             term=int(info["lterm"]))
                return False
        return True

    def routable(self):
        """{replica_id: {"addr", "gen", "dir", "hb_age"}} of every
        replica the router would currently dispatch to."""
        with self._members_lock:
            return {h: dict(v) for h, v in self._members.items()}

    def health(self):
        with self._qcond:
            depth = self._qdepth_locked()
            tenant_depth = {t: len(q)
                            for t, q in self._tqueues.items() if q}
            bo_floor = self._bo_floor
        with self._members_lock:
            inflight = dict(self._inflight)
        with self._leader_lock:
            leader, lterm = self._is_leader, self._leader_term
        out = {"live": True, "replicas": self.routable(),
               "queue_depth": depth, "inflight": inflight,
               "n_replicas": self.n_replicas,
               "router_id": self.router_id,
               "n_routers": self.n_routers,
               "group_size": self.group_size,
               "leader": leader, "leader_term": lterm,
               "max_batch": self.max_batch,
               "batch_deadline_s": self.batch_deadline_s}
        if self._qos:
            out["qos"] = {
                "classes": sorted(self._classes),
                "tenant_queue_depth": tenant_depth,
                "brownout_floor": bo_floor,
                "high_priority_queue_depth":
                    self.high_priority_queue_depth()}
        return out

    def _pick_replica(self, tried):
        """Least-loaded live replica not yet tried for this batch:
        fewest FLEET-WIDE router-dispatched batches in flight (own
        counts plus every sibling router's, shared through the member
        registry's info blobs — a failed-over request must not
        double-count a replica's load); equally-loaded replicas rotate
        round-robin. (NOT heartbeat freshness: the lease cadences of
        healthy replicas phase-lock against the members poll, and a
        fixed freshness tie-break then shadows one replica completely
        — it never takes traffic and its buckets go cold.)"""
        with self._members_lock:
            peers = self._peer_inflight
            cands = sorted((self._inflight.get(h, 0)
                            + peers.get(h, 0), h, v["addr"])
                           for h, v in self._members.items()
                           if h not in tried)
            if not cands:
                return None
            least = [c for c in cands if c[0] == cands[0][0]]
            self._pick_seq += 1
            _, h, addr = least[self._pick_seq % len(least)]
        return h, addr

    def _inc_inflight(self, rid, d):
        with self._members_lock:
            n = self._inflight.get(rid, 0) + d
            self._inflight[rid] = max(0, n)
            # the gauge write stays under the lock: published outside
            # it, a racing +1/-1 pair can land out of order and strand
            # the exported series at a stale nonzero value
            resilience.set_router_inflight(
                rid, self._inflight[rid], router=self._host_id)

    # -- the export contract (what batching splits by) ---------------------
    def _get_meta(self):
        with self._meta_lock:
            if self._meta is not None:
                return self._meta
        for rid, ent in sorted(self.routable().items()):
            try:
                status, resp = http_json(
                    "GET", "http://%s/meta" % ent["addr"],
                    timeout_s=5.0)
            except (OSError, ValueError):
                continue
            if status == 200 and "feed_names" in resp:
                with self._meta_lock:
                    self._meta = resp
                return resp
        return None

    def _request_rows(self, feeds, meta):
        """The request batch implied by its dynamic feeds' row counts
        — the export's recorded factors, exactly the ServingPredictor
        bucket math (dim0 = factor * batch) — plus a DEEP shape check
        against the export's fixed dims. Validation lives here, at
        admission: a malformed request (ragged rows, wrong width, a
        missing feed) coalesced into a micro-batch would otherwise
        fail on the replica and take every innocent sibling in the
        batch down with it."""
        n = None
        if meta["dynamic_batch"]:
            for name, f in meta["feed_batch_factors"].items():
                if not f:
                    continue
                if name not in feeds:
                    raise ValueError("request is missing feed %r"
                                     % name)
                rows = len(feeds[name])
                if rows % f:
                    raise ValueError(
                        "feed %r has %d rows, not a multiple of its "
                        "batch factor %d" % (name, rows, f))
                got = rows // f
                if n is None:
                    n = got
                elif got != n:
                    raise ValueError(
                        "batch-dynamic feeds disagree on the batch: "
                        "feed %r implies %d, earlier feeds %d"
                        % (name, got, n))
        n = 1 if n is None else n
        inner = meta.get("feed_inner_shapes")
        if inner:
            import numpy as np
            factors = meta["feed_batch_factors"]
            for name in meta["feed_names"]:
                if name not in feeds:
                    raise ValueError("request is missing feed %r"
                                     % name)
                f = factors.get(name, 0)
                want = ([n * f] + list(inner[name])) if f \
                    else list(inner[name])
                try:
                    arr = np.asarray(feeds[name])
                except Exception:   # ragged nesting raises in numpy
                    raise ValueError(
                        "feed %r is ragged/malformed, expected shape "
                        "%s" % (name, want))
                if arr.dtype == object or list(arr.shape) != want:
                    raise ValueError(
                        "feed %r has shape %s, expected %s"
                        % (name, list(arr.shape), want))
        return n

    # -- request intake ----------------------------------------------------
    def _finish_pending(self, p, deadline, outcome_replayed=False):
        """Wait out one pending request and account its terminal
        outcome (``replay`` for a token replay riding the original —
        the caller's view stays one request, the counters stay
        honest). Non-replay completions additionally feed the top-K
        slow-request exemplars (latency + trace id) that
        ``router_totals()`` exports — the bridge from a fat p99 to
        the exact timeline behind it."""
        if not p.event.wait(max(0.0, deadline - time.monotonic())
                            + 0.05):
            p.abandoned = True
            resilience.record_router_request("deadline",
                                             router=self._host_id,
                                             tenant=p.tenant)
            if not outcome_replayed:
                # a token replay waiting out the same _Pending must
                # not double-spend a top-K exemplar slot on one
                # logical request
                resilience.record_router_slow(
                    time.monotonic() - p.enqueued, trace=p.trace,
                    router=self._host_id, tenant=p.tenant)
            raise DeadlineExceededError(
                "request did not complete within its deadline")
        if not outcome_replayed:
            resilience.record_router_slow(
                time.monotonic() - p.enqueued, trace=p.trace,
                router=self._host_id, tenant=p.tenant)
        if p.error is not None:
            resilience.record_router_request(
                "shed" if isinstance(p.error, ServerOverloadedError)
                else "deadline"
                if isinstance(p.error, DeadlineExceededError)
                else "error", router=self._host_id, tenant=p.tenant)
            raise p.error
        resilience.record_router_request(
            "replay" if outcome_replayed else "ok",
            router=self._host_id, tenant=p.tenant)
        return p.result

    def _remember_token(self, token, p):
        with self._token_lock:
            self._tokens[token] = p
            while len(self._tokens) > self.TOKEN_CACHE:
                self._tokens.popitem(last=False)

    def submit(self, feeds, deadline_s=None, token=None, trace=None,
               tenant=None, deadline_budget_ms=None,
               retry_budget=None):
        """Route one request (dict name -> rows as nested lists).
        Returns ``{"outputs", "dtypes", "replica", "generation"}``.
        ``token`` (an opaque client string) makes the request
        IDEMPOTENT on this router: a replay with the same token rides
        the original in-flight request (or returns its cached result)
        instead of enqueueing a duplicate — what lets a FleetClient
        re-send blindly after a torn response or a failover loop back.
        ``trace`` is the propagated ``(trace_id, parent_span_id)``
        context from the caller's ``x-trace-id`` header — the request
        gets a ``router.serve`` span (with queue/dispatch children)
        under the caller's trace, so one client request is one
        timeline across processes.
        ``tenant`` is the request's QoS identity (the ``x-tenant``
        header / ``"tenant"`` body field; absent = ``"default"``):
        with tenant classes configured it selects the class whose
        weight/quota/priority govern admission and queueing, and it
        labels every counter, exemplar and span either way.
        ``deadline_budget_ms`` is the REMAINING cross-hop deadline
        budget (the ``x-deadline-ms`` header): it caps ``deadline_s``,
        an already-spent budget is refused 504-style WITHOUT queueing,
        and whatever is left at dispatch time rides the next hop's
        ``x-deadline-ms``. ``retry_budget`` (``x-retry-budget``) caps
        how many replica attempts this request may burn across
        retry-on-sibling.
        Raises ServerOverloadedError (queue full / quota or brownout
        shed / every replica shedding), DeadlineExceededError,
        ValueError (malformed request) or RuntimeError (upstream
        failure after retries)."""
        tr, parent = trace if trace else (None, None)
        tenant = tenant or DEFAULT_TENANT
        with obs.span("router.serve", trace_id=tr, parent=parent,
                      router=self._host_id, tenant=tenant) as sp:
            return self._submit_traced(feeds, deadline_s, token, sp,
                                       tenant, deadline_budget_ms,
                                       retry_budget)

    def _submit_traced(self, feeds, deadline_s, token, sp, tenant,
                       deadline_budget_ms, retry_budget):
        if deadline_budget_ms is not None:
            budget_s = float(deadline_budget_ms) / 1000.0
            if budget_s <= 0:
                # the budget died upstream (a slow client hop, a
                # queueing router ahead of us): refuse WITHOUT
                # queueing — dispatching would burn replica time on
                # an answer nobody is waiting for
                resilience.record_router_expired(
                    "queue", tenant=tenant, router=self._host_id)
                resilience.record_router_request(
                    "deadline", router=self._host_id, tenant=tenant)
                raise DeadlineExceededError(
                    "deadline budget exhausted before admission — "
                    "refused without queueing")
            deadline_s = budget_s if deadline_s is None \
                else min(float(deadline_s), budget_s)
        deadline = time.monotonic() + (
            self.request_deadline_s if deadline_s is None
            else float(deadline_s))
        if token:
            with self._token_lock:
                prev = self._tokens.get(token)
            # a replay rides only an IN-FLIGHT or SUCCEEDED original.
            # A failed/abandoned one must NOT answer from the cache:
            # the client retrying a shed against a single-router
            # endpoint list would be replayed its own stale failure
            # forever — the retry re-enqueues fresh (last write wins
            # in the token cache)
            if prev is not None and prev.error is None \
                    and not prev.abandoned:
                return self._finish_pending(prev, deadline,
                                            outcome_replayed=True)
        meta = self._get_meta()
        if meta is None:
            resilience.record_router_request("error",
                                             router=self._host_id,
                                             tenant=tenant)
            raise FleetError("no live replica to learn the export "
                             "contract from — is the fleet up?")
        try:
            n = self._request_rows(feeds, meta)
            if meta["dynamic_batch"] and meta.get("max_bucket") \
                    and n > int(meta["max_bucket"]):
                # reject at ADMISSION: dispatched, this request would
                # 500 deterministically on every replica — burning a
                # retry per sibling to turn a client error into a 502
                raise ValueError(
                    "request batch %d exceeds the largest exported "
                    "bucket %d — re-export with a larger batch_sizes "
                    "entry" % (n, int(meta["max_bucket"])))
        except ValueError:
            resilience.record_router_request("error",
                                             router=self._host_id,
                                             tenant=tenant)
            raise
        p = _Pending(feeds, n, deadline, tenant=tenant,
                     retry_budget=retry_budget)
        if sp.trace is not None:
            p.trace, p.span, p.t_enq = sp.trace, sp.id, obs.now()
        with self._qcond:
            if self._qos:
                msg = self._qos_admit_locked(p, time.monotonic())
                if msg is not None:
                    resilience.record_router_request(
                        "shed", router=self._host_id, tenant=tenant)
                    raise ServerOverloadedError(msg)
            else:
                if len(self._queue) >= self.max_queue:
                    resilience.record_router_request(
                        "shed", router=self._host_id, tenant=tenant)
                    raise ServerOverloadedError(
                        "router queue is full (%d waiting) — "
                        "shedding load; retry with backoff"
                        % self.max_queue)
                self._queue.append(p)
                resilience.set_router_queue_depth(
                    len(self._queue), router=self._host_id)
            self._qcond.notify_all()
        if token:
            self._remember_token(token, p)
        if not self._qos:
            return self._finish_pending(p, deadline)
        try:
            return self._finish_pending(p, deadline)
        finally:
            # the in-flight quota covers admission -> completion
            # (queued OR dispatched), whatever path ended it
            with self._qcond:
                self._tstate_for(p.tenant)["inflight"] -= 1

    def _handle_infer(self, body, trace_header=None, headers=None):
        headers = headers or {}
        feeds = body.get("feeds")
        if not isinstance(feeds, dict):
            return 400, {"error": 'infer needs {"feeds": {name: rows}}'}
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                return 400, {"error": "deadline_s must be a number, "
                             "got %r" % (deadline_s,)}
        token = body.get("token")
        if token is not None and not isinstance(token, str):
            return 400, {"error": "token must be a string"}
        tenant = headers.get("x-tenant") or body.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            return 400, {"error": "tenant must be a string"}
        deadline_budget_ms = headers.get("x-deadline-ms")
        if deadline_budget_ms is not None:
            try:
                deadline_budget_ms = float(deadline_budget_ms)
            except (TypeError, ValueError):
                return 400, {"error": "x-deadline-ms must be a "
                             "number, got %r" % (deadline_budget_ms,)}
        retry_budget = headers.get("x-retry-budget")
        if retry_budget is not None:
            try:
                retry_budget = int(retry_budget)
            except (TypeError, ValueError):
                return 400, {"error": "x-retry-budget must be an "
                             "integer, got %r" % (retry_budget,)}
            if retry_budget < 1:
                return 400, {"error": "x-retry-budget must be >= 1"}
        try:
            return 200, self.submit(
                feeds, deadline_s=deadline_s, token=token,
                trace=obs.parse_header(trace_header), tenant=tenant,
                deadline_budget_ms=deadline_budget_ms,
                retry_budget=retry_budget)
        except ServerOverloadedError as e:
            return 503, {"error": str(e), "kind": "overloaded"}
        except DeadlineExceededError as e:
            return 504, {"error": str(e), "kind": "deadline"}
        except ValueError as e:
            return 400, {"error": str(e)}
        except (FleetError, RuntimeError, OSError) as e:
            # OSError covers the ConnectionError a batch fails with
            # when EVERY live replica was unreachable — the caller
            # must see a status code, never an aborted connection
            return 502, {"error": str(e), "kind": "upstream"}

    # -- multi-tenant QoS --------------------------------------------------
    def _class_of(self, tenant):
        """Resolve a tenant to its :class:`TenantClass`: an explicit
        ``tenants`` membership wins, then a class NAMED like the
        tenant, then the ``default`` class (implicit weight-1
        priority-0 unless configured)."""
        c = self._tenant_to_class.get(tenant)
        if c is not None:
            return c
        return self._classes.get(tenant, self._class_default)

    def _tstate_for(self, tenant):
        """Per-tenant mutable QoS state (caller holds ``_qcond``):
        token-bucket level, in-flight count and the SFQ finish tag of
        the tenant's last admitted request."""
        st = self._tstate.get(tenant)
        if st is None:
            c = self._class_of(tenant)
            st = self._tstate[tenant] = {
                "tokens": c.burst if c.burst is not None else 0.0,
                "t_tok": time.monotonic(),
                "inflight": 0, "finish": 0.0}
        return st

    def _qos_admit_locked(self, p, now):
        """Classed admission (caller holds ``_qcond``): brownout
        floor, global queue cap, token-bucket rate, in-flight quota —
        in that order, so a browned-out class cannot drain tokens it
        would not get to spend. Returns the shed reason (``None`` =
        admitted: the request is tagged with its SFQ virtual times
        and appended to its tenant's queue)."""
        c = self._class_of(p.tenant)
        if self._bo_floor is not None and c.priority < self._bo_floor:
            return ("brownout shed: class %r (priority %d) is below "
                    "the current floor %d — the router keeps only "
                    "its highest classes under overload; retry with "
                    "backoff" % (c.name, c.priority, self._bo_floor))
        if self._qdepth_locked() >= self.max_queue:
            return ("router queue is full (%d waiting) — shedding "
                    "load; retry with backoff" % self.max_queue)
        st = self._tstate_for(p.tenant)
        if c.rate is not None:
            st["tokens"] = min(c.burst, st["tokens"]
                               + (now - st["t_tok"]) * c.rate)
            st["t_tok"] = now
            if st["tokens"] < 1.0:
                return ("tenant %r is over class %r's rate quota "
                        "(%g req/s) — shedding; retry with backoff"
                        % (p.tenant, c.name, c.rate))
            st["tokens"] -= 1.0
        if c.max_inflight is not None \
                and st["inflight"] >= c.max_inflight:
            return ("tenant %r is at class %r's in-flight quota (%d) "
                    "— shedding; retry with backoff"
                    % (p.tenant, c.name, c.max_inflight))
        st["inflight"] += 1
        p.vstart = max(self._vclock, st["finish"])
        p.vfinish = p.vstart + p.n / c.weight
        st["finish"] = p.vfinish
        q = self._tqueues.get(p.tenant)
        if q is None:
            q = self._tqueues[p.tenant] = collections.deque()
        q.append(p)
        resilience.set_router_tenant_queue_depth(
            p.tenant, len(q), router=self._host_id)
        resilience.set_router_queue_depth(self._qdepth_locked(),
                                          router=self._host_id)
        return None

    def _qos_loop(self):
        while not self._stop.wait(self._qos_interval_s):
            self._qos_tick()

    def _qos_tick(self):
        """Brownout controller tick — the autoscaler's frozen-signal
        discipline applied to shedding: sample queue depth and the
        shed-rate delta, and only a ``qos_hysteresis``-long streak of
        hot (cool) samples moves the admissible-priority floor one
        class level up (down). Admission reads the FROZEN verdict
        (``_bo_floor``) — per-request heuristics would flap at
        request rate. The floor never exceeds the highest configured
        priority, so the highest class is never browned out."""
        depth = self.queue_depth()
        _, shed, total = self._load_signals()
        prev = self._bo_prev
        self._bo_prev = (shed, total)
        if prev is None:
            return
        d_shed, d_total = shed - prev[0], total - prev[1]
        rate = float(d_shed) / d_total if d_total > 0 else 0.0
        hot = depth >= self._brownout_queue_depth \
            or rate >= self._brownout_shed_rate
        with self._qcond:
            levels, cur = self._bo_levels, self._bo_floor
            nxt = cur
            if hot:
                self._bo_hot += 1
                self._bo_cool = 0
                if self._bo_hot >= self._qos_hysteresis:
                    above = [lv for lv in levels
                             if cur is None or lv > cur]
                    # the top level stays admissible: the floor may
                    # reach levels[-1] (only the highest class kept),
                    # never pass it
                    if len(above) > (1 if cur is None else 0):
                        nxt = above[1] if cur is None else above[0]
            else:
                self._bo_cool += 1
                self._bo_hot = 0
                if self._bo_cool >= self._qos_hysteresis \
                        and cur is not None:
                    idx = levels.index(cur)
                    nxt = levels[idx - 1] if idx > 1 else None
            if nxt != cur:
                self._bo_floor = nxt
                self._bo_hot = self._bo_cool = 0
        if nxt != cur:
            record_event("router_brownout", router=self._host_id,
                         floor=nxt, queue=depth,
                         shed_rate=round(rate, 3))

    # -- continuous micro-batching -----------------------------------------
    def _batch_loop(self):
        cut = self._cut_batch_wfq if self._qos else self._cut_batch
        while not self._stop.is_set():
            batch = cut()
            if batch:
                resilience.observe_router_batch(len(batch),
                                                router=self._host_id)
                t = threading.Thread(target=self._dispatch,
                                     args=(batch,), daemon=True,
                                     name="paddle_tpu-fleet-dispatch")
                t.start()

    def _cut_batch(self):
        """Block until a batch is due, then cut it: requests coalesce
        in arrival order while their summed request-batch stays within
        ``max_batch``; the cut happens the moment the cap is reached
        or the OLDEST waiting request has aged ``batch_deadline_s``.
        Expired/abandoned requests are dropped here (their callers
        already took the deadline path)."""
        while not self._stop.is_set():
            # meta resolution happens OUTSIDE _qcond: a cold cache is
            # an HTTP GET /meta (5s timeout per replica), and holding
            # the condition through it would stall every submit(),
            # shed and health() exactly when the fleet is degraded
            meta = self._get_meta()
            if meta is None:
                self._stop.wait(0.05)
                continue
            coalescing = bool(meta["dynamic_batch"])
            # the coalescing cap must respect the EXPORT: a merged
            # batch larger than the biggest exported bucket would be
            # a deterministic ValueError on every replica — a
            # fleet-wide failure that only appears under load
            cap = self.max_batch
            if coalescing and meta.get("max_bucket"):
                cap = min(cap, int(meta["max_bucket"]))
            # static (factor-0) feeds are shipped ONCE per merged
            # batch, so requests may only share a batch when their
            # static tensors are EQUAL — silently computing B's
            # outputs from A's static feed would be wrong data, not
            # even an error
            static_names = [nm for nm, f
                            in meta["feed_batch_factors"].items()
                            if not f]
            with self._qcond:
                now = time.monotonic()
                while self._queue and (self._queue[0].abandoned
                                       or now > self._queue[0].deadline):
                    self._drop_expired_locked(self._queue.popleft(),
                                              now)
                if not self._queue:
                    resilience.set_router_queue_depth(
                        0, router=self._host_id)
                    self._qcond.wait(0.05)
                    continue
                first = self._queue[0]
                rows = 0
                for p in self._queue:
                    if p.abandoned or now > p.deadline:
                        continue
                    rows += p.n
                cut_at = first.enqueued + self.batch_deadline_s
                if coalescing and rows < cap and now < cut_at:
                    self._qcond.wait(min(cut_at - now, 0.05))
                    continue
                batch, rows = [], 0
                while self._queue:
                    p = self._queue[0]
                    if p.abandoned or now > p.deadline:
                        self._drop_expired_locked(
                            self._queue.popleft(), now)
                        continue
                    if batch and (not coalescing
                                  or rows + p.n > cap
                                  or any(p.feeds.get(nm)
                                         != batch[0].feeds.get(nm)
                                         for nm in static_names)):
                        break
                    self._queue.popleft()
                    batch.append(p)
                    rows += p.n
                resilience.set_router_queue_depth(len(self._queue),
                                                  router=self._host_id)
                if batch and obs.enabled():
                    self._record_cut_spans(batch)
                return batch
        return []

    def _drop_expired_locked(self, p, now):
        """Account one request dropped from a queue without ever
        being dispatched. ``where="queue"`` on the deadline-expired
        counter is the propagated-budget discipline in action: the
        budget died while the request waited, so no replica slot is
        burnt on it (the caller already took the deadline path)."""
        if now > p.deadline:
            resilience.record_router_expired(
                "queue", tenant=p.tenant, router=self._host_id)

    def _record_cut_spans(self, batch):
        # retroactive per-request queue spans (enqueue -> cut) + one
        # coalesce span on the oldest member: "was the latency queue
        # wait or replica time" is answerable per request
        t_cut = obs.now()
        lead = next((p for p in batch if p.trace is not None), None)
        if lead is not None:
            obs.record("router.coalesce", lead.t_enq, t_cut,
                       trace_id=lead.trace, parent=lead.span,
                       batch=len(batch))
        for p in batch:
            if p.trace is not None:
                obs.record("router.queue", p.t_enq, t_cut,
                           trace_id=p.trace, parent=p.span,
                           tenant=p.tenant)

    def _cut_batch_wfq(self):
        """The QoS cutter: like :meth:`_cut_batch`, but requests wait
        in PER-TENANT queues and the cut drains them by start-time
        fair queueing — each queue head carries a virtual finish tag
        stamped at admission (``vstart = max(vclock, tenant's last
        finish)``, ``vfinish = vstart + rows / weight``) and the
        cutter repeatedly picks the smallest ``vfinish`` among heads,
        advancing the virtual clock to the pick's ``vstart``. Over
        any busy interval each tenant's served rows converge to its
        weight share, an idle tenant builds no credit (its next
        vstart jumps to the live vclock), and a flooding tenant only
        queues behind its own backlog — the isolation the single
        FIFO cannot give."""
        while not self._stop.is_set():
            meta = self._get_meta()
            if meta is None:
                self._stop.wait(0.05)
                continue
            coalescing = bool(meta["dynamic_batch"])
            cap = self.max_batch
            if coalescing and meta.get("max_bucket"):
                cap = min(cap, int(meta["max_bucket"]))
            static_names = [nm for nm, f
                            in meta["feed_batch_factors"].items()
                            if not f]
            with self._qcond:
                now = time.monotonic()
                for t, q in self._tqueues.items():
                    while q and (q[0].abandoned
                                 or now > q[0].deadline):
                        self._drop_expired_locked(q.popleft(), now)
                heads = [q[0] for q in self._tqueues.values() if q]
                if not heads:
                    resilience.set_router_queue_depth(
                        0, router=self._host_id)
                    self._qcond.wait(0.05)
                    continue
                rows = sum(p.n for q in self._tqueues.values()
                           for p in q
                           if not (p.abandoned or now > p.deadline))
                cut_at = min(p.enqueued for p in heads) \
                    + self.batch_deadline_s
                if coalescing and rows < cap and now < cut_at:
                    self._qcond.wait(min(cut_at - now, 0.05))
                    continue
                batch, rows = [], 0
                while True:
                    head = None
                    for q in self._tqueues.values():
                        if q and (head is None
                                  or q[0].vfinish < head[0].vfinish):
                            head = q
                    if head is None:
                        break
                    p = head[0]
                    if p.abandoned or now > p.deadline:
                        self._drop_expired_locked(head.popleft(), now)
                        continue
                    if batch and (not coalescing
                                  or rows + p.n > cap
                                  or any(p.feeds.get(nm)
                                         != batch[0].feeds.get(nm)
                                         for nm in static_names)):
                        break
                    head.popleft()
                    self._vclock = max(self._vclock, p.vstart)
                    batch.append(p)
                    rows += p.n
                for t, q in self._tqueues.items():
                    resilience.set_router_tenant_queue_depth(
                        t, len(q), router=self._host_id)
                resilience.set_router_queue_depth(
                    self._qdepth_locked(), router=self._host_id)
                if not batch:
                    continue   # everything waiting had expired
                if obs.enabled():
                    self._record_cut_spans(batch)
                return batch
        return []

    @staticmethod
    def _merge(batch, meta):
        merged = {}
        for name in meta["feed_names"]:
            merged[name] = []
            for p in batch:
                merged[name].extend(p.feeds.get(name, []))
        # a static feed (factor 0) must not be concatenated: every
        # request carries the same full tensor — ship the first
        for name, f in meta["feed_batch_factors"].items():
            if not f and batch:
                merged[name] = batch[0].feeds.get(name, [])
        return merged

    def _dispatch(self, batch):
        """Send one coalesced batch to the least-loaded live replica,
        retrying on an untried sibling while the deadlines allow — a
        replica death mid-flight costs a retry, not a failure. The
        dispatch budget is the batch's MINIMUM remaining deadline, so
        when a short-deadline member expires it is failed ALONE and
        the survivors are re-merged and retried on their own budget —
        one impatient caller must not poison its coalesced siblings."""
        meta = self._get_meta()
        if meta is None:
            self._fail(batch, FleetError("no live replica"))
            return
        tried = set()
        last_err = None
        merged = None
        attempt = 0
        # retry-on-sibling is bounded by the STRICTEST member budget
        # (x-retry-budget): a replica outage under load must cost a
        # bounded number of attempts per request, not a retry storm
        retry_budget = None
        for p in batch:
            if p.retry_budget is not None:
                retry_budget = p.retry_budget if retry_budget is None \
                    else min(retry_budget, p.retry_budget)
        n_attempts = 0
        while True:
            now = time.monotonic()
            expired = [p for p in batch if now > p.deadline]
            if expired:
                for p in expired:
                    # cut but never answered: the budget died between
                    # the cut and a successful dispatch
                    resilience.record_router_expired(
                        "dispatch", tenant=p.tenant,
                        router=self._host_id)
                self._fail(expired,
                           last_err or DeadlineExceededError(
                               "request deadline expired before any "
                               "replica answered"))
                batch = [p for p in batch if now <= p.deadline]
                # the recomposed batch is a NEW dispatch: earlier
                # failures belonged to the old composition (a replica
                # that 504'd the impatient member's budget can serve
                # the survivors' own), so the replica set reopens
                merged = None
                tried = set()
                last_err = None
            if not batch:
                return
            if retry_budget is not None and n_attempts >= retry_budget:
                self._fail(batch, last_err or ServerOverloadedError(
                    "retry budget (%d attempts) exhausted"
                    % retry_budget))
                return
            if merged is None:
                merged = self._merge(batch, meta)
            remaining = min(p.deadline for p in batch) - now
            if remaining <= 0:
                continue             # the loop top expires them
            target = self._pick_replica(tried)
            if target is None:
                self._fail(batch, last_err or ServerOverloadedError(
                    "no live replica to dispatch to"))
                return
            rid, addr = target
            payload = {"feeds": merged, "deadline_s": remaining}
            # the remaining budget rides the next hop as x-deadline-ms
            # (RE-COMPUTED per attempt — each retry ships a smaller
            # budget), so the replica can refuse already-expired work
            # before burning a batch slot on it. x-tenant carries the
            # LEAD member's identity (a coalesced batch may mix
            # tenants; per-request identity lives router-side)
            headers = {"x-deadline-ms": "%d" % int(remaining * 1000.0),
                       "x-tenant": batch[0].tenant}
            n_attempts += 1
            # propagate the (lead) trace context to the replica so its
            # serve span joins the same timeline; the per-attempt
            # dispatch spans below are recorded per coalesced request,
            # tagged replica + outcome — a retry-on-sibling is two
            # dispatch spans under one router.serve parent
            traced = obs.enabled()
            if traced:
                attempt += 1
                t_att = obs.now()
                lead = next((p for p in batch
                             if p.trace is not None), None)
                if lead is not None:
                    headers["x-trace-id"] = \
                        "%s:%s" % (lead.trace, lead.span)
            self._inc_inflight(rid, +1)
            try:
                # inside the try on purpose: an injected OSError takes
                # the exact retry-on-sibling path a dead replica does
                # (``host`` filter = target replica id)
                faultinject.hit("serving.dispatch", host=rid)
                status, resp = http_json(
                    "POST", "http://%s/infer" % addr, payload,
                    timeout_s=remaining + 0.5, headers=headers)
            except (OSError, ValueError) as e:
                # a SIGKILLed replica mid-flight lands here: the
                # connection resets, the batch retries on a sibling.
                # Connection-level failures are RARE (a death, not
                # load) — they warrant an event as well as the counter
                last_err = ConnectionError(
                    "replica %d unreachable: %s" % (rid, e))
                tried.add(rid)
                resilience.record_router_retry(rid,
                                               router=self._host_id)
                record_event("router_retry", replica=rid,
                             error=type(e).__name__)
                if traced:
                    self._record_dispatch(batch, t_att, rid,
                                          "unreachable", attempt)
                continue
            finally:
                self._inc_inflight(rid, -1)
            if status == 200:
                if traced:
                    self._record_dispatch(batch, t_att, rid, "ok",
                                          attempt)
                self._split(batch, resp, meta)
                return
            tried.add(rid)
            if status == 503:
                outcome = "shed"
                last_err = ServerOverloadedError(
                    resp.get("error", "replica %d is shedding" % rid))
            elif status == 504:
                outcome = "deadline"
                last_err = DeadlineExceededError(
                    resp.get("error", "replica %d deadline" % rid))
            else:
                outcome = "error"
                last_err = RuntimeError(
                    resp.get("error",
                             "replica %d answered HTTP %d"
                             % (rid, status)))
            if traced:
                self._record_dispatch(batch, t_att, rid, outcome,
                                      attempt)
            # 5xx retries are LOAD-driven (a shed storm emits one per
            # tried replica per batch, at request rate): counter only,
            # never the bounded event log
            resilience.record_router_retry(rid, router=self._host_id)

    @staticmethod
    def _record_dispatch(batch, t0, rid, outcome, attempt):
        """One finished dispatch-attempt span per coalesced traced
        request, parented under its router.serve span."""
        t1 = obs.now()
        for p in batch:
            if p.trace is not None:
                obs.record("router.dispatch", t0, t1,
                           trace_id=p.trace, parent=p.span,
                           replica=rid, outcome=outcome,
                           attempt=attempt, tenant=p.tenant)

    @staticmethod
    def _fail(batch, err):
        for p in batch:
            p.error = err
            # terminal: a token replay answers from result/error only,
            # so drop the payload instead of pinning it in the token
            # cache until 4096 newer requests evict it
            p.feeds = None
            p.event.set()

    def _split(self, batch, resp, meta):
        """Give each coalesced request its own slice of the batched
        outputs, by the EXPORT's fetch factors (factor 0 = static
        output, replicated to every caller)."""
        outs = resp.get("outputs", [])
        dtypes = resp.get("dtypes", [])
        factors = [meta["fetch_batch_factors"].get(name, 0)
                   for name in meta["fetch_names"]]
        off = 0
        for p in batch:
            mine = []
            for o, f in zip(outs, factors):
                if f and isinstance(o, list):
                    mine.append(o[off * f:(off + p.n) * f])
                else:
                    mine.append(o)
            p.result = {"outputs": mine, "dtypes": dtypes,
                        "replica": resp.get("replica"),
                        "generation": resp.get("generation")}
            p.error = None
            # terminal: replay reads result only — don't pin the
            # request payload in the token cache
            p.feeds = None
            p.event.set()
            off += p.n

    # -- rolling weight refresh --------------------------------------------
    def rolling_deploy(self, artifact_dir, per_replica_timeout_s=60.0):
        """Refresh every live replica's weights to ``artifact_dir``,
        ONE replica at a time: ask it to refresh (it self-fences,
        reloads + warms, rejoins), wait until it is back in rotation
        on the new artifact, then move to the next — traffic keeps
        flowing to the rest throughout, so a deploy drops nothing.
        Returns ``{"refreshed": [ids], "dir": dir}``; raises
        :class:`FleetError` when a replica does not come back in
        time (the deploy stops there — the fleet keeps serving on the
        replicas already refreshed plus the untouched tail), or when
        another deploy is already in progress (two interleaved
        deploys would fence more than one replica at a time).

        A rolling refresh assumes the new artifact keeps the OLD
        export contract (feed/fetch names and factors) — mixed
        generations serve side by side mid-deploy. A contract-changing
        model update needs a blue-green fleet swap instead."""
        artifact_dir = str(artifact_dir)
        if not self._deploy_lock.acquire(blocking=False):
            raise FleetError("a rolling deploy is already in progress")
        try:
            return self._rolling_deploy_locked(artifact_dir,
                                               per_replica_timeout_s)
        finally:
            self._deploy_lock.release()

    def _rolling_deploy_locked(self, artifact_dir,
                               per_replica_timeout_s):
        targets = sorted(self.routable())
        if not targets:
            raise FleetError("no live replica to deploy to")
        refreshed = []
        for rid in targets:
            ent = self.routable().get(rid)
            if ent is None:
                continue    # died since the plan was cut: skip it
            if ent.get("dir") == artifact_dir:
                refreshed.append(rid)
                continue
            try:
                status, resp = http_json(
                    "POST", "http://%s/admin/refresh" % ent["addr"],
                    {"dir": artifact_dir}, timeout_s=5.0)
            except (OSError, ValueError) as e:
                raise FleetError("replica %d refused the refresh: %s"
                                 % (rid, e))
            if status != 200:
                raise FleetError("replica %d refused the refresh: %s"
                                 % (rid, resp.get("error", status)))
            deadline = time.monotonic() + float(per_replica_timeout_s)
            back = False
            while time.monotonic() < deadline:
                ent = self.routable().get(rid)
                if ent is not None and ent.get("dir") == artifact_dir:
                    back = True
                    break
                self._stop.wait(0.05)
                if self._stop.is_set():
                    raise FleetError("router closed mid-deploy")
            if not back:
                raise FleetError(
                    "replica %d did not return to rotation on %s "
                    "within %.1fs — deploy stopped (already "
                    "refreshed: %s)" % (rid, artifact_dir,
                                        per_replica_timeout_s,
                                        refreshed))
            refreshed.append(rid)
        with self._meta_lock:
            self._meta = None   # a deploy may change the contract
        record_event("fleet_deploy_complete", refreshed=refreshed,
                     dir=artifact_dir)
        return {"refreshed": refreshed, "dir": artifact_dir}


# ---------------------------------------------------------------------------
# client-side router failover
# ---------------------------------------------------------------------------

class FleetClient(object):
    """Thin fail-over client for the replicated router tier.

    Takes a LIST of router endpoints (``"h:p0,h:p1"``, full URLs, or a
    list of either) and rotates on connection error / 5xx — a router
    SIGKILL costs one rotation, never a failed request. Every request
    carries a fresh random TOKEN; replays (a torn response, a failover
    that loops back to the original router) are IDEMPOTENT router-side
    — the router returns the original request's result instead of
    enqueueing a duplicate. 503 (the whole fleet shedding) and 5xx are
    retried with a tiny backoff until the request deadline, so the
    caller sees an error only when the deadline is truly spent.

    Thread-safe: N load threads may share one client (the chaos
    batteries and ``servingsvc client`` do)."""

    def __init__(self, endpoints, request_deadline_s=10.0,
                 backoff_s=0.05, tenant=None, retry_budget=None):
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",")
                         if e.strip()]
        self.urls = [u if "://" in u else "http://" + u
                     for u in endpoints]
        if not self.urls:
            raise ValueError("FleetClient needs at least one router "
                             "endpoint")
        self.request_deadline_s = float(request_deadline_s)
        self._backoff_s = float(backoff_s)
        # QoS identity: rides every request as x-tenant (None = the
        # router's "default" tenant); retry_budget bounds the total
        # replica attempts a request may burn ACROSS hops — it rides
        # as x-retry-budget and bounds this client's own router
        # attempts too, so an outage under load cannot amplify into
        # attempts(client) x attempts(router) retries
        self.tenant = tenant if tenant is None else str(tenant)
        self.retry_budget = retry_budget if retry_budget is None \
            else int(retry_budget)
        if self.retry_budget is not None and self.retry_budget < 1:
            raise ValueError("retry_budget must be >= 1")
        self._lock = threading.Lock()
        self._i = 0

    def _url(self):
        with self._lock:
            return self.urls[self._i % len(self.urls)]

    def _rotate(self):
        with self._lock:
            self._i = (self._i + 1) % len(self.urls)

    def infer(self, feeds, deadline_s=None):
        """One idempotent request against the router tier. Returns the
        response dict ({"outputs", "dtypes", "replica", ...}); raises
        the last error (ConnectionError every router unreachable,
        ServerOverloadedError whole-fleet shed, DeadlineExceededError,
        ValueError for a malformed request — never retried) once the
        deadline is spent.

        With the obs spans engine enabled, each request is the ROOT of
        a distributed trace: the ``client.infer`` span's context rides
        the ``x-trace-id`` header into the router (and on to the
        replica), so ``tools.traceview`` can render one client
        request end to end across the fleet's processes."""
        with obs.span("client.infer") as sp:
            return self._infer_traced(feeds, deadline_s, sp)

    def _infer_traced(self, feeds, deadline_s, sp):
        import uuid
        deadline = time.monotonic() + (
            self.request_deadline_s if deadline_s is None
            else float(deadline_s))
        token = uuid.uuid4().hex
        if sp.trace is not None:
            sp.set(token=token)
            if self.tenant is not None:
                sp.set(tenant=self.tenant)
        last_err = None
        attempts = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise last_err if last_err is not None else \
                    DeadlineExceededError(
                        "no router answered within the deadline")
            if self.retry_budget is not None \
                    and attempts >= self.retry_budget:
                raise last_err if last_err is not None else \
                    ServerOverloadedError(
                        "retry budget (%d attempts) exhausted"
                        % self.retry_budget)
            url = self._url()
            # the deadline budget is RE-STAMPED per attempt: each hop
            # (and each retry) ships only what is left, so a request
            # that dies in a queue somewhere is refused downstream
            # instead of dispatched into the void
            headers = {"x-deadline-ms": "%d" % int(remaining * 1000.0)}
            if self.tenant is not None:
                headers["x-tenant"] = self.tenant
            if self.retry_budget is not None:
                headers["x-retry-budget"] = \
                    "%d" % (self.retry_budget - attempts)
            if sp.trace is not None:
                headers["x-trace-id"] = "%s:%s" % (sp.trace, sp.id)
            attempts += 1
            try:
                status, resp = http_json(
                    "POST", url + "/infer",
                    {"feeds": feeds, "deadline_s": remaining,
                     "token": token},
                    timeout_s=remaining + 0.5, headers=headers)
            except (OSError, ValueError) as e:
                # a dead/SIGKILLed router: rotate and REPLAY by token
                # (idempotent even when the loop lands back here)
                last_err = ConnectionError(
                    "router %s unreachable: %s" % (url, e))
                self._rotate()
                time.sleep(min(self._backoff_s,
                               max(0.0, deadline - time.monotonic())))
                continue
            if status == 200:
                sp.set(outcome="ok", replica=resp.get("replica"))
                return resp
            if status == 400:
                # malformed request: deterministic on every router —
                # retrying would only burn the deadline
                raise ValueError(resp.get("error", "bad request"))
            if status == 503:
                last_err = ServerOverloadedError(
                    resp.get("error", "fleet is shedding"))
            elif status == 504:
                last_err = DeadlineExceededError(
                    resp.get("error", "fleet deadline"))
            else:
                last_err = RuntimeError(
                    resp.get("error",
                             "router answered HTTP %d" % status))
            self._rotate()
            time.sleep(min(self._backoff_s,
                           max(0.0, deadline - time.monotonic())))


# ---------------------------------------------------------------------------
# replica autoscaling (policy loop on the admission leader)
# ---------------------------------------------------------------------------

class Autoscaler(object):
    """Replica autoscaling policy loop, leader-gated.

    Attached to a :class:`FleetRouter`; every ``interval_s`` it samples
    the router's queue depth, its shed rate (per-router
    ``router_requests_total`` deltas) and the fleet-wide in-flight
    total, over a sliding ``window``. Only the ADMISSION LEADER acts
    (followers keep sampling so a takeover starts warm, but their
    streaks reset on the leadership edge — a new leader must re-observe
    before acting):

      * **grow** — ``hysteresis`` consecutive samples with queue depth
        >= ``grow_queue_depth`` OR window shed rate >=
        ``grow_shed_rate``: the group is RESIZED one slot larger
        (``Coordinator.resize`` — the new slot is born fenced) and
        ``spawner(new_host_id, new_group_size)`` launches the replica,
        which joins through the ordinary announce/admit/join path.
      * **shrink** — a full window of idle samples (zero queue, zero
        in-flight, zero sheds): the HIGHEST grown replica id (only
        slots above the router range are removable — the id space is
        contiguous, so only the top can be resized away) is asked to
        DRAIN (``POST /admin/drain``: it fences itself and stops
        rejoining), waited out of rotation, the group resized one slot
        smaller, and ``stopper(host_id)`` reaps the process.

    Hysteresis + ``cooldown_s`` after every action keep a noisy load
    signal from flapping the fleet. ``min_replicas``/``max_replicas``
    bound the replica tier — max is enforced against ALLOCATED slots
    as well as live replicas, so a spawner whose replicas die before
    joining cannot grow the group without bound; min defaults to the
    base tier (base replicas are permanent members; the resize seam
    only moves the top of the id range). Decisions land as
    ``fleet_autoscale`` events and the ``fleet_target_replicas``
    gauge."""

    def __init__(self, router, spawner=None, stopper=None,
                 min_replicas=None, max_replicas=None,
                 interval_s=0.25, window=8, grow_queue_depth=4.0,
                 grow_shed_rate=0.05, hysteresis=3, cooldown_s=5.0,
                 drain_timeout_s=15.0, grow_high_queue_depth=None):
        self.router = router
        self.spawner = spawner
        self.stopper = stopper
        self.min_replicas = int(min_replicas) \
            if min_replicas is not None else router.n_replicas
        self.max_replicas = int(max_replicas) \
            if max_replicas is not None else router.n_replicas + 4
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 1 <= min_replicas (%d) <= max_replicas (%d)"
                % (self.min_replicas, self.max_replicas))
        self.interval_s = float(interval_s)
        self.window = int(window)
        self.grow_queue_depth = float(grow_queue_depth)
        # class-aware growth: sustained HIGHEST-priority-class queue
        # depth grows the fleet even when brownout shedding keeps the
        # total depth under grow_queue_depth — paying for capacity is
        # the remedy for high-class pressure, shedding is not.
        # Defaults to half the global threshold (min 1) with tenant
        # classes configured; no-op on a classless router (hq == 0)
        self.grow_high_queue_depth = float(grow_high_queue_depth) \
            if grow_high_queue_depth is not None \
            else max(1.0, self.grow_queue_depth / 2.0)
        self.grow_shed_rate = float(grow_shed_rate)
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._samples = collections.deque(maxlen=self.window)
        self._grow_streak = 0
        self._ceiling_warned = False
        self._was_leader = False
        self._last_action_t = None
        self._last_shed = None
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle_tpu-fleet-autoscale-%d"
            % self.router._host_id)
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.drain_timeout_s + 5.0)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception as e:   # noqa: BLE001 - the loop IS the
                # policy plane: an error costs one tick, not the thread
                record_event("fleet_autoscale_error",
                             error=type(e).__name__)

    # -- signal sampling ---------------------------------------------------
    def _sample(self):
        """One FLEET-WIDE load sample: this router's own queue/shed
        plus every live sibling's, read from their info blobs —
        clients pin one endpoint, so overload routinely lands on a
        FOLLOWER the leader process cannot observe locally. Queue
        depth takes the max (the threshold means "some router's queue
        is this deep"), counters sum."""
        r = self.router
        queue, shed, total = r._load_signals()
        hq = r.high_priority_queue_depth()
        with r._members_lock:
            inflight = sum(r._inflight.values()) \
                + sum(r._peer_inflight.values())
            peers = [dict(v) for v in r._peer_router_load.values()]
        for p in peers:
            queue = max(queue, p.get("queue", 0))
            hq = max(hq, p.get("hq", 0))
            shed += p.get("shed", 0)
            total += p.get("reqs", 0)
        return {"queue": queue, "shed": shed,
                "total": total, "inflight": inflight, "hq": hq}

    def _window_shed_rate(self):
        if len(self._samples) < 2:
            return 0.0
        first, last = self._samples[0], self._samples[-1]
        d_total = last["total"] - first["total"]
        d_shed = last["shed"] - first["shed"]
        return d_shed / float(d_total) if d_total > 0 else 0.0

    def _tick(self):
        leader = self.router.is_leader()
        if leader != self._was_leader:
            # leadership edge: a fresh leader re-observes before it
            # may act — inherited streaks belong to another router
            self._grow_streak = 0
            self._samples.clear()
            self._was_leader = leader
        s = self._sample()
        self._samples.append(s)
        if s["queue"] >= self.grow_queue_depth \
                or s["hq"] >= self.grow_high_queue_depth \
                or (len(self._samples) >= 2
                    and self._window_shed_rate()
                    >= self.grow_shed_rate):
            self._grow_streak += 1
        else:
            self._grow_streak = 0
        if not leader:
            return
        if self._last_action_t is not None and \
                time.monotonic() - self._last_action_t \
                < self.cooldown_s:
            return
        live = sorted(self.router.routable())
        n_live = len(live)
        if self._grow_streak >= self.hysteresis \
                and n_live < self.max_replicas:
            self._grow(n_live)
        elif len(self._samples) == self.window \
                and all(x["queue"] == 0 and x["inflight"] == 0
                        for x in self._samples) \
                and self._samples[-1]["shed"] \
                == self._samples[0]["shed"]:
            if n_live > self.min_replicas:
                self._shrink(live)
            else:
                # even at the live floor an idle window may have a
                # LEFTOVER to reap: a fenced top slot holds no live
                # replica, so it never counts toward n_live but wedges
                # all future scale-in until resized away
                self._reclaim(live)

    # -- actuation ---------------------------------------------------------
    def _group_size(self):
        try:
            m = self.router._co.members()
        except (CoordinationError, ConnectionError):
            return None
        return m.get("n_hosts")

    def _resize_with_retry(self, n_hosts, action, budget_s=5.0):
        """The fleet's control rounds tick continuously, so a resize
        routinely races an open gather ("refused mid-round") — rounds
        live milliseconds, so a short retry loop rides them out. A
        bounded failure here matters most on SHRINK, where the victim
        already drained: bailing would orphan it out of rotation with
        its slot still counted."""
        deadline = time.monotonic() + float(budget_s)
        while True:
            try:
                self.router._co.resize(int(n_hosts))
                return True
            except (CoordinationError, ConnectionError) as e:
                if time.monotonic() >= deadline:
                    record_event("fleet_autoscale_deferred",
                                 action=action,
                                 error=type(e).__name__)
                    return False
                if self._stop.wait(0.05):
                    return False

    def _grow(self, n_live):
        group = self._group_size()
        if group is None:
            return
        if int(group) - self.router.n_routers >= self.max_replicas:
            # every replica SLOT is already allocated — n_live only
            # counts joined replicas, so gating on it alone would let
            # sustained pressure over a broken spawner grow the group
            # one fenced phantom slot per cooldown without bound
            if not self._ceiling_warned:
                self._ceiling_warned = True
                record_event("fleet_autoscale_deferred", action="grow",
                             error="replica_slot_ceiling",
                             group=int(group))
            return
        self._ceiling_warned = False
        new_id, new_group = int(group), int(group) + 1
        if not self._resize_with_retry(new_group, "grow"):
            # hysteresis already proved the pressure: next tick retries
            return
        self._last_action_t = time.monotonic()
        self._grow_streak = 0
        record_event("fleet_autoscale", action="grow",
                     target=n_live + 1, member=new_id,
                     group=new_group)
        if self.spawner is not None:
            self.spawner(new_id, new_group)

    def _shrink(self, live):
        group = self._group_size()
        if group is None:
            return
        victim = int(group) - 1
        # only the TOP id is removable (contiguous id space), and only
        # GROWN slots above the router range may leave — the base tier
        # is permanent membership
        if victim < self.router.n_replicas + self.router.n_routers:
            return
        if victim not in live:
            self._reclaim(live)
            return
        ent = self.router.routable().get(victim)
        if ent is None:
            return
        try:
            status, resp = http_json(
                "POST", "http://%s/admin/drain" % ent["addr"], {},
                timeout_s=5.0)
        except (OSError, ValueError):
            return                   # unreachable: retry next window
        if status != 200:
            return
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            if victim not in self.router.routable():
                break
            if self._stop.wait(0.05):
                return
        else:
            record_event("fleet_autoscale_deferred", action="shrink",
                         error="drain_timeout", member=victim)
            return
        if not self._resize_with_retry(int(group) - 1, "shrink"):
            return
        self._last_action_t = time.monotonic()
        self._samples.clear()
        record_event("fleet_autoscale", action="shrink",
                     target=len(live) - 1, member=victim,
                     group=int(group) - 1)
        if self.stopper is not None:
            self.stopper(victim)

    def _reclaim(self, live):
        """Reap a fenced, unroutable TOP slot — the leftover that
        otherwise wedges ALL future scale-in (only the top id is
        removable, and a fenced slot can never become live on its
        own): a drain whose follow-up resize exhausted its budget, or
        a grown replica that died before joining. Only a slot the
        coordinator confirms FENCED is reclaimed — anything holding a
        live-looking lease is left alone, and a joiner racing the
        resize loses to the stale-size named error, never a phantom
        membership."""
        try:
            m = self.router._co.members()
        except (CoordinationError, ConnectionError):
            return
        group = m.get("n_hosts")
        if group is None:
            return
        victim = int(group) - 1
        if victim < self.router.n_replicas + self.router.n_routers \
                or victim in live \
                or victim not in m.get("lost", {}):
            return
        if not self._resize_with_retry(int(group) - 1, "shrink"):
            return
        self._last_action_t = time.monotonic()
        self._samples.clear()
        record_event("fleet_autoscale", action="shrink",
                     target=len(live), member=victim,
                     group=int(group) - 1, reclaimed=True)
        if self.stopper is not None:
            self.stopper(victim)
