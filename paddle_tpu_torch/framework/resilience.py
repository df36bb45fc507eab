"""Resilience: fault injection, retry and backoff, auto-recovering
training, and the metrics that report them.

Counterpart of paddle_tpu/framework/resilience.py, its single-host part:

  * :class:`FaultInjector`: a deterministic, seeded chaos harness with
    named injection points (``step``, ``ckpt_write``, ``serve``), armed
    by :func:`inject`, :func:`install` or ``PADDLE_TPU_FAULTS``;
  * :func:`classify` and :class:`RetryPolicy`: exponential backoff with
    seeded jitter and a transient/fatal classifier;
  * :class:`ResilientTrainer`: drives Executor.run / run_steps (a plain
    Program or a CompiledProgram); on a transient failure it restores
    the latest valid checkpoint, rewinds and replays, under a bounded
    restart budget; a ``NumericFaultError`` (``numeric_policy="rewind"``)
    marks its batch poisoned and the replay skips it;
  * :func:`run_with_deadline`: a wall-clock bound on host work;
  * the structured event log (:func:`events`) and its aggregation
    (:func:`metrics`, :func:`metrics_text`, :func:`parse_metrics_text`)
    over the families this port feeds: events, faults, checkpoint bytes,
    restore latency, executor step phases, failpoints, numeric faults
    and the buddy tier's (restore outcomes, each host's generation, its
    mailbox's resident bytes, the delta ratio, the p2p fetch ms), the
    socket transport's (reconnects, failovers, heartbeat lag, terms,
    replication lag) and the serving fleet's router and tenant series
    (:func:`record_router_request` and its siblings: cumulative
    counters outside the event log); the feed plane's families render
    as the JAX package's would, but nothing in this port records them
    yet;
  * :class:`MetricsServer` / :func:`serve_metrics`: the stdlib HTTP pull
    endpoint of the exposition (``GET /metrics``, ``GET /healthz``);
  * :class:`SDCDetector`, the pod's silent-data-corruption tripwire,
    and ``ElasticTrainer``, resolved lazily from
    :mod:`.coordination` (which holds the pod stack: the coordinators,
    ``PodResilientTrainer``, ``ElasticTrainer``).

``ResilientTrainer(feed=...)`` (a ShardedFeed) raises NotPortedError.

Env knobs (read once; ``reload_env()`` re-reads):
  PADDLE_TPU_FAULTS       fault spec string, e.g. ``step:preempt@5``
  PADDLE_TPU_FAULT_SEED   seed for probabilistic (``~p``) specs
"""
import collections
import contextlib
import logging
import os
import random
import threading
import time

from ..ops.registry import NotPortedError
from . import watchdog
from .watchdog import CollectiveTimeoutError, bounded_call

__all__ = [
    "FaultSpec", "FaultInjector", "RetryPolicy", "ResilientTrainer",
    "SimulatedPreemptionError", "SimulatedHostDeathError",
    "ServerOverloadedError",
    "DeadlineExceededError", "RestartBudgetExceededError",
    "NumericFaultError", "SkipBudgetExceededError",
    "fire", "inject", "install", "current_injector", "reload_env",
    "events", "record_event", "clear_events", "classify",
    "run_with_deadline", "INJECTION_POINTS", "context",
    "metrics", "metrics_text", "parse_metrics_text",
    "record_bytes", "bytes_totals", "clear_bytes",
    "observe_executor_step", "executor_step_totals", "clear_exec",
    "record_analysis", "analysis_totals", "clear_analysis",
    "record_kernel_choice", "kernel_choice_totals", "clear_kernel_choice",
    "record_buddy_gen", "buddy_gens", "clear_buddy_gens",
    "record_buddy_resident", "buddy_resident",
    "record_buddy_delta_ratio", "buddy_delta_ratio",
    "record_buddy_fetch_ms", "buddy_fetch_ms", "SDCDetector",
    "record_router_request", "record_router_retry", "observe_router_batch",
    "record_router_slow", "record_router_expired",
    "set_router_queue_depth", "set_router_inflight",
    "set_router_tenant_queue_depth", "router_totals", "clear_router",
    "MetricsServer", "serve_metrics",
]

INJECTION_POINTS = ("step", "ckpt_write", "serve")


def _logger():
    return logging.getLogger("paddle_tpu_torch.resilience")


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

class SimulatedPreemptionError(RuntimeError):
    """Injected stand-in for a preempted/evicted host: the step dies the
    way a real preemption surfaces (an exception out of the dispatch),
    and recovery must restore + replay."""


class SimulatedHostDeathError(RuntimeError):
    """Injected stand-in for a host LEAVING the pod (eviction notice,
    node reclaim): unlike a transient preemption the process is going
    away, so the local trainer cannot retry. Only
    coordination.ElasticTrainer handles the raised error (fence self,
    survivors continue elastically); everywhere else it classifies
    FATAL — a plain (Pod)ResilientTrainer cannot outlive its own host.
    A real ABRUPT death needs no exception at all: the survivors'
    gather timeout fences the silent host and the pod rewinds without
    it."""


class ServerOverloadedError(RuntimeError):
    """Load shedding: the serving in-flight cap is full. Clients should
    back off and retry — the deliberate alternative to queue collapse."""


class DeadlineExceededError(CollectiveTimeoutError):
    """A per-request serving deadline expired. Subclasses
    CollectiveTimeoutError so existing timeout handling (and the
    transient classifier) treat it uniformly."""


class RestartBudgetExceededError(RuntimeError):
    """ResilientTrainer exhausted its restart budget — the fault is not
    transient at this rate; escalate to the orchestrator."""


class NumericFaultError(FloatingPointError):
    """A step produced a non-finite value and the numeric policy wants
    a recovery, not a plain raise.  Subclasses FloatingPointError so
    every existing handler (and the transient classifier) treats it
    like today's check_numerics raise; additionally carries WHERE the
    fault was localized so recovery can name the culprit and skip the
    poison batch on replay.

    ``step``    executor step counter at the faulting step
    ``culprit`` first offending var name (fetch/param/grad), or None
    ``batch_index`` global batch index of the poison batch (filled in
                by the trainer's feed loop; None when not feed-driven)
    """

    def __init__(self, msg, step=None, culprit=None, batch_index=None,
                 window_offset=0):
        super(NumericFaultError, self).__init__(msg)
        self.step = step
        self.culprit = culprit
        self.batch_index = batch_index
        # which batch INSIDE the faulting dispatch window blew up
        # (run_steps localizes it post-hoc); the trainer adds its own
        # window base to get the global batch_index
        self.window_offset = window_offset


class SkipBudgetExceededError(NumericFaultError):
    """numeric_policy="skip" discarded more consecutive steps than the
    configured budget allows — the fault is persistent, not a one-batch
    poison; escalate instead of silently dropping the whole stream."""


# ---------------------------------------------------------------------------
# structured event log
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def context(**tags):
    """Attach tags to every event THIS thread records inside the block.

    PodResilientTrainer wraps each simulated host's loop in
    ``context(host=i)`` so one process-global event log still tells the
    hosts apart — the same shape a real pod gets from per-process logs."""
    old = getattr(_tls, "tags", None)
    merged = dict(old or {})
    merged.update(tags)
    _tls.tags = merged
    try:
        yield
    finally:
        _tls.tags = old


class EventLog(object):
    """Bounded, thread-safe, append-only record of resilience activity.

    Each event is a plain dict with at least ``kind`` and ``time`` —
    cheap to export to any metrics pipe later."""

    def __init__(self, capacity=4096):
        self._events = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, kind, **fields):
        tags = getattr(_tls, "tags", None)
        event = dict(tags) if tags else {}
        event.update(fields)
        event["kind"] = kind
        event["time"] = time.time()
        with self._lock:
            self._events.append(event)
        return event

    def events(self, kind=None):
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def clear(self):
        with self._lock:
            self._events.clear()


_LOG = EventLog()


def events(kind=None):
    """All recorded resilience events (optionally filtered by kind)."""
    return _LOG.events(kind)


def record_event(kind, **fields):
    return _LOG.record(kind, **fields)


def clear_events():
    """Reset the observability surface: the bounded event log and the
    cumulative byte and executor-step counters (a cleared log exporting
    stale series would break the 'empty log -> empty metrics'
    contract)."""
    _LOG.clear()
    clear_bytes()
    clear_exec()
    clear_kernel_choice()
    clear_buddy_gens()


# ---------------------------------------------------------------------------
# metrics export (Prometheus-style aggregation of the event log)
# ---------------------------------------------------------------------------

METRIC_PREFIX = "paddle_tpu_resilience"
# restore latencies span "local disk, small model" (~ms) to "multi-host
# resharded restore" (~minutes)
RESTORE_LATENCY_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)

# Wire-byte accounting of the compressed movement paths (quantized
# collectives / elastic state ship / checkpoint payloads). Cumulative
# process-global counters OUTSIDE the bounded event log: per-step
# increments at dispatch rate would evict the whole log within minutes,
# and counters must never wrap anyway. Channel -> {"raw", "wire"}.
_BYTES = {}
_BYTES_LOCK = threading.Lock()
BYTES_CHANNELS = ("collective", "stateship", "ckpt", "buddy_snapshot")


def record_bytes(channel, raw, wire):
    """Accumulate one transfer's byte accounting: ``raw`` is what the
    uncompressed path would have moved, ``wire`` what actually crossed
    the wire/disk. Exported by :func:`metrics` as the counter pair
    ``<prefix>_<channel>_bytes_total{kind="raw"|"wire"}``."""
    with _BYTES_LOCK:
        c = _BYTES.setdefault(str(channel), {"raw": 0, "wire": 0})
        c["raw"] += int(raw)
        c["wire"] += int(wire)


def bytes_totals():
    """Snapshot of the cumulative byte counters:
    ``{channel: {"raw": n, "wire": n}}``."""
    with _BYTES_LOCK:
        return {ch: dict(c) for ch, c in _BYTES.items()}


def clear_bytes():
    with _BYTES_LOCK:
        _BYTES.clear()


# Buddy-snapshot gauges (framework/buddy.py), at window rate, so kept
# outside the event log and cleared with it: the generation each host
# last published or adopted, each mailbox's resident bytes (keys are
# strings: a host id, or "coord" for the coordinator's own stores), the
# last send's delta wire ratio and the last host-to-host fetch's ms.
_BUDDY_GEN = {}
_BUDDY_GEN_LOCK = threading.Lock()
_BUDDY_RESIDENT = {}
_BUDDY_P2P = {}
_BUDDY_P2P_LOCK = threading.Lock()


def record_buddy_gen(host, gen):
    """Exported as the gauge ``<prefix>_buddy_generation{host=}``."""
    with _BUDDY_GEN_LOCK:
        _BUDDY_GEN[int(host)] = int(gen)


def buddy_gens():
    """{host: generation} snapshot."""
    with _BUDDY_GEN_LOCK:
        return dict(_BUDDY_GEN)


def clear_buddy_gens():
    with _BUDDY_GEN_LOCK:
        _BUDDY_GEN.clear()
    with _BUDDY_P2P_LOCK:
        _BUDDY_RESIDENT.clear()
        _BUDDY_P2P.clear()


def record_buddy_resident(host, nbytes):
    """Exported as ``<prefix>_buddy_resident_bytes{host=}``."""
    with _BUDDY_P2P_LOCK:
        _BUDDY_RESIDENT[str(host)] = int(nbytes)


def buddy_resident():
    """{host: bytes} snapshot."""
    with _BUDDY_P2P_LOCK:
        return dict(_BUDDY_RESIDENT)


def record_buddy_delta_ratio(ratio):
    """One send's wire bytes over the last full send's: 1.0 for a full
    send. Exported as the gauge ``<prefix>_buddy_delta_ratio``."""
    with _BUDDY_P2P_LOCK:
        _BUDDY_P2P["delta_ratio"] = float(ratio)


def buddy_delta_ratio():
    with _BUDDY_P2P_LOCK:
        return _BUDDY_P2P.get("delta_ratio")


def record_buddy_fetch_ms(ms):
    """One host-to-host mailbox pull's ms. Exported as the gauge
    ``<prefix>_buddy_p2p_fetch_ms``."""
    with _BUDDY_P2P_LOCK:
        _BUDDY_P2P["fetch_ms"] = float(ms)


def buddy_fetch_ms():
    with _BUDDY_P2P_LOCK:
        return _BUDDY_P2P.get("fetch_ms")


# Executor step-phase latency: per-phase cumulative histograms outside
# the event log (steps run at dispatch rate). Kind is the phase
# ("execute", "writeback", "total"); the buckets are the JAX package's.
EXEC_STEP_BUCKETS = (0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0, 30.0,
                     120.0)
_EXEC = {}
_EXEC_LOCK = threading.Lock()


def observe_executor_step(kind, seconds):
    """Record one executor step phase's wall time in the
    ``<prefix>_executor_step_seconds{kind=}`` histogram."""
    seconds = float(seconds)
    with _EXEC_LOCK:
        h = _EXEC.setdefault(
            str(kind), {"counts": [0] * (len(EXEC_STEP_BUCKETS) + 1),
                        "sum": 0.0, "count": 0})
        for i, le in enumerate(EXEC_STEP_BUCKETS):
            if seconds <= le:
                h["counts"][i] += 1
                break
        else:
            h["counts"][-1] += 1
        h["sum"] += seconds
        h["count"] += 1


def executor_step_totals():
    """{kind: {"counts", "sum", "count"}} snapshot."""
    with _EXEC_LOCK:
        return {k: {"counts": list(h["counts"]), "sum": h["sum"],
                    "count": h["count"]} for k, h in _EXEC.items()}


def clear_exec():
    with _EXEC_LOCK:
        _EXEC.clear()


# Kernel-selection accounting (ops/kernel_dispatch.choose): one increment
# per call site's decision, at the rate of compiles, kept as cumulative
# counters keyed (op, impl, source): whether a job runs the tuned or
# predicted launch configs it thinks it does is a scrapeable series.
_KCHOICE = {}
_KCHOICE_LOCK = threading.Lock()


def record_kernel_choice(op, impl, source):
    """Count one kernel decision (ops/kernel_dispatch.KernelChoice):
    exported by :func:`metrics` as
    ``<prefix>_kernel_choice_total{op=,impl=,source=}``."""
    with _KCHOICE_LOCK:
        k = (str(op), str(impl), str(source))
        _KCHOICE[k] = _KCHOICE.get(k, 0) + 1


def kernel_choice_totals():
    """Snapshot ``{(op, impl, source): count}``."""
    with _KCHOICE_LOCK:
        return dict(_KCHOICE)


def clear_kernel_choice():
    with _KCHOICE_LOCK:
        _KCHOICE.clear()


# Program-verifier accounting (framework/analysis.py): one increment per
# diagnostic, at the rate of compile-cache misses, kept as cumulative
# counters keyed (pass, severity); each verification's summary rides the
# event log as a ``program_analysis`` event (analysis.report).
_ANALYSIS = {}
_ANALYSIS_LOCK = threading.Lock()


def record_analysis(pass_name, severity, n=1):
    """Count verifier diagnostics: exported by :func:`metrics` as
    ``<prefix>_analysis_diagnostics_total{pass=,severity=}``."""
    with _ANALYSIS_LOCK:
        k = (str(pass_name), str(severity))
        _ANALYSIS[k] = _ANALYSIS.get(k, 0) + int(n)


def analysis_totals():
    """Snapshot ``{(pass, severity): count}``."""
    with _ANALYSIS_LOCK:
        return dict(_ANALYSIS)


def clear_analysis():
    with _ANALYSIS_LOCK:
        _ANALYSIS.clear()


# Serving-fleet router accounting (serving_fleet.FleetRouter). Same
# design pressure as the byte counters: the router serves at request
# rate, and one event per request would evict the whole bounded log in
# minutes — so these are cumulative process-global counters/gauges
# OUTSIDE the event log, folded into metrics() only once any activity
# exists (router-less jobs export nothing new). Rare router events
# (a replica dispatch failing over, a rolling-deploy step) still ride
# the ordinary event log.
#
# Every series carries an optional ``router=`` label: N concurrent
# FleetRouters (the HA router tier) share this process-global state,
# and an unlabeled gauge would be overwritten by whichever router
# wrote last — per-router label keys keep the series apart. ``router=
# None`` keeps the historical unlabeled series (single-router callers
# and direct test use are unchanged).
_ROUTER_LOCK = threading.Lock()
ROUTER_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


ROUTER_SLOW_K = 8


def _fresh_router_state():
    return {"requests": {},      # (router, outcome) -> count
            "batch": {},         # router -> {"counts", "sum", "count"}
            "queue_depth": {},   # router -> gauge
            "inflight": {},      # (router, replica) -> gauge
            "retries": {},       # (router, replica) -> count
            "slow": {},          # router -> top-K
                                 #   [(latency_s, trace, tenant)]
            # multi-tenant QoS series (additive: the aggregate series
            # above are written unconditionally, so a tenant-less
            # deployment's exposition is bit-for-bit the old one)
            "tenant_requests": {},  # (router, tenant, outcome) -> n
            "expired": {},          # (router, tenant, where) -> n
            "tenant_queue": {}}     # (router, tenant) -> gauge


_ROUTER = _fresh_router_state()


def _router_key(router):
    return None if router is None else str(router)


def record_router_request(outcome, router=None, tenant=None):
    """Count one routed request's terminal outcome ("ok", "shed",
    "deadline", "error", "replay", ...). Exported as
    ``<prefix>_router_requests_total{outcome=[,router=]}``. When the
    caller knows the tenant a SECOND, ``tenant=``-labelled series is
    bumped alongside (never instead of) the aggregate — per-class SLO
    accounting without perturbing the historical series, and the probe
    cross-checks the two for quota-accounting drift."""
    with _ROUTER_LOCK:
        key = (_router_key(router), str(outcome))
        r = _ROUTER["requests"]
        r[key] = r.get(key, 0) + 1
        if tenant is not None:
            tkey = (_router_key(router), str(tenant), str(outcome))
            t = _ROUTER["tenant_requests"]
            t[tkey] = t.get(tkey, 0) + 1


def record_router_retry(replica, router=None):
    """Count one failed dispatch attempt that was retried on a
    sibling. A cumulative counter, NOT an event: under a shed storm
    retries run at request rate and would evict the bounded event log
    (the router still records an event for the RARE connection-level
    failures — a replica death — just not for load-driven 5xx)."""
    with _ROUTER_LOCK:
        key = (_router_key(router), int(replica))
        r = _ROUTER["retries"]
        r[key] = r.get(key, 0) + 1


def observe_router_batch(size, router=None):
    """Record one dispatched micro-batch's coalesced request count in
    the ``<prefix>_router_batch_size`` histogram (per-router series)."""
    size = float(size)
    with _ROUTER_LOCK:
        b = _ROUTER["batch"].setdefault(
            _router_key(router),
            {"counts": [0] * (len(ROUTER_BATCH_BUCKETS) + 1),
             "sum": 0.0, "count": 0})
        for i, le in enumerate(ROUTER_BATCH_BUCKETS):
            if size <= le:
                b["counts"][i] += 1
                break
        else:
            b["counts"][-1] += 1
        b["sum"] += size
        b["count"] += 1


def record_router_slow(latency_s, trace=None, router=None,
                       tenant=None):
    """Keep this request as a slow-request EXEMPLAR if it makes the
    router's top-K by latency. Exemplars pair the p99 a histogram can
    only bound with the trace id that lets an operator pull the exact
    offending timeline (``paddle_tpu_torch.tools.traceview``) — the classic
    metrics-to-trace bridge — and the tenant, so "whose request was
    slow" is one lookup. Exported by :func:`router_totals` as
    ``slow_requests``."""
    latency_s = float(latency_s)
    with _ROUTER_LOCK:
        top = _ROUTER["slow"].setdefault(_router_key(router), [])
        top.append((latency_s, None if trace is None else str(trace),
                    None if tenant is None else str(tenant)))
        top.sort(key=lambda e: -e[0])
        del top[ROUTER_SLOW_K:]


def record_router_expired(where, tenant=None, router=None):
    """Count one request whose propagated deadline budget had already
    expired, by WHERE the expiry was caught:

      * ``"queue"``    expired while waiting in (or arriving at) the
                       router queue — failed 504 WITHOUT dispatching;
      * ``"dispatch"`` expired between batch cut and dispatch — the
                       member is failed alone and the batch recomposed;
      * ``"replica"``  the replica-side guard refused dispatched work
                       that was already expired on arrival. The router
                       checks remaining budget immediately before every
                       send, so this series staying at ZERO is the
                       counter-assertable form of "no request is ever
                       dispatched after its budget expired".

    Exported as ``<prefix>_router_deadline_expired_total{where=,
    tenant=[,router=]}``."""
    with _ROUTER_LOCK:
        key = (_router_key(router),
               "default" if tenant is None else str(tenant),
               str(where))
        e = _ROUTER["expired"]
        e[key] = e.get(key, 0) + 1


def set_router_queue_depth(depth, router=None):
    """Update the ``<prefix>_router_queue_depth`` gauge (requests
    waiting to be coalesced into a batch) for ``router``'s series."""
    with _ROUTER_LOCK:
        _ROUTER["queue_depth"][_router_key(router)] = float(depth)


def set_router_inflight(replica, n, router=None):
    """Update the per-replica ``<prefix>_router_replica_inflight``
    gauge (batches the router currently has dispatched to it)."""
    with _ROUTER_LOCK:
        _ROUTER["inflight"][(_router_key(router), int(replica))] = \
            float(n)


def set_router_tenant_queue_depth(tenant, depth, router=None):
    """Update the per-tenant ``<prefix>_router_tenant_queue_depth``
    gauge (requests waiting in that tenant's WFQ queue). Written only
    by QoS-mode routers, so tenant-less deployments export nothing
    new."""
    with _ROUTER_LOCK:
        _ROUTER["tenant_queue"][(_router_key(router), str(tenant))] = \
            float(depth)


def router_totals(by_router=False):
    """One consistent snapshot of the router accounting. The default
    AGGREGATES across router labels (the historical single-router
    shape): ``{"requests": {outcome: n}, "batch_counts" (per-bucket,
    non-cumulative), "batch_count", "batch_sum", "queue_depth",
    "inflight": {replica: n}, "retries": {replica: n}}``.
    ``by_router=True`` returns the same shape PER ROUTER KEY (None =
    the unlabeled series) — what :func:`metrics` exports from, and
    what the Autoscaler reads its own shed rate out of. Taken under
    ONE lock acquisition so the histogram's bucket counts can never
    run ahead of its total (a non-monotonic histogram is invalid to
    Prometheus consumers). ``slow_requests`` carries the top-K
    slow-request exemplars as ``[{"latency_s", "trace", "tenant"}]``,
    worst first (see :func:`record_router_slow`). QoS additions ride
    as ``"tenants"`` ({tenant: {outcome: n}}), ``"expired"``
    ({where: {tenant: n}}) and ``"tenant_queue_depth"``
    ({tenant: depth}) — all empty for tenant-less deployments."""
    with _ROUTER_LOCK:
        requests = dict(_ROUTER["requests"])
        batch = {r: {"counts": list(b["counts"]), "sum": b["sum"],
                     "count": b["count"]}
                 for r, b in _ROUTER["batch"].items()}
        queue_depth = dict(_ROUTER["queue_depth"])
        inflight = dict(_ROUTER["inflight"])
        retries = dict(_ROUTER["retries"])
        slow = {r: list(v) for r, v in _ROUTER["slow"].items()}
        tenant_requests = dict(_ROUTER["tenant_requests"])
        expired = dict(_ROUTER["expired"])
        tenant_queue = dict(_ROUTER["tenant_queue"])
    routers = (set(r for r, _ in requests) | set(batch)
               | set(queue_depth) | set(r for r, _ in inflight)
               | set(r for r, _ in retries) | set(slow)
               | set(r for r, _, _ in tenant_requests)
               | set(r for r, _, _ in expired)
               | set(r for r, _ in tenant_queue))
    out = {}
    for rkey in (sorted(routers, key=lambda r: (r is not None, str(r)))
                 if by_router else [None]):
        def _mine(k):
            return by_router is False or k == rkey
        b_counts = [0] * (len(ROUTER_BATCH_BUCKETS) + 1)
        b_sum, b_count = 0.0, 0
        for r, b in batch.items():
            if _mine(r):
                b_counts = [a + c for a, c in zip(b_counts, b["counts"])]
                b_sum += b["sum"]
                b_count += b["count"]
        depths = [v for r, v in queue_depth.items() if _mine(r)]
        merged_slow = sorted(
            (e for r, top in slow.items() if _mine(r) for e in top),
            key=lambda e: -e[0])[:ROUTER_SLOW_K]
        tmap = {}
        for (r, t, o), n in tenant_requests.items():
            if _mine(r):
                d = tmap.setdefault(t, {})
                d[o] = d.get(o, 0) + n
        emap = {}
        for (r, t, w), n in expired.items():
            if _mine(r):
                d = emap.setdefault(w, {})
                d[t] = d.get(t, 0) + n
        tq = {}
        for (r, t), v in tenant_queue.items():
            if _mine(r):
                tq[t] = tq.get(t, 0.0) + v
        ent = {
            "requests": _sum_by(requests, _mine),
            "batch_counts": b_counts, "batch_count": b_count,
            "batch_sum": b_sum,
            "queue_depth": sum(depths) if depths else None,
            "inflight": _sum_by(inflight, _mine),
            "retries": _sum_by(retries, _mine),
            "tenants": tmap, "expired": emap,
            "tenant_queue_depth": tq,
            "slow_requests": [{"latency_s": lat, "trace": tr,
                               "tenant": tn}
                              for lat, tr, tn in merged_slow]}
        if not by_router:
            return ent
        out[rkey] = ent
    return out


def _sum_by(pairs, mine):
    out = {}
    for (r, k), n in pairs.items():
        if mine(r):
            out[k] = out.get(k, 0) + n
    return out


def clear_router():
    with _ROUTER_LOCK:
        global _ROUTER
        _ROUTER = _fresh_router_state()


def _counts_histogram(name, buckets, counts, total, hsum,
                      labels=None):
    """Prometheus histogram dict from PRE-BUCKETED per-bucket counts.
    The single home of the cumulative encoding (bucket counts must
    never run ahead of the +Inf total, or consumers reject the
    series) — _histogram and the executor step histograms ride it."""
    cum, running = [], 0
    for le, n in zip(buckets, counts):
        running += int(n)
        cum.append(["%g" % le, running])
    cum.append(["+Inf", int(total)])
    return {"name": name, "labels": dict(labels or {}),
            "buckets": cum, "sum": float(hsum), "count": int(total)}


def _histogram(name, values, buckets, labels=None):
    values = [float(v) for v in values]
    counts = []
    prev = None
    for le in buckets:
        counts.append(sum(1 for v in values
                          if v <= le and (prev is None or v > prev)))
        prev = le
    return _counts_histogram(name, buckets, counts, len(values),
                             sum(values), labels=labels)



def metrics(event_list=None, by_host=False):
    """Aggregate the bounded event log into Prometheus-style counters and
    histograms.

    The JAX package's function and series, line for line (so one event
    list renders byte-equal in both packages), less its
    kernel-selection counter (the kernel dispatch slice).

    Returns a JSON-ready dict ``{"counters": [...], "histograms": [...]}``
    where each counter is ``{"name", "labels", "value"}`` and each
    histogram carries cumulative ``buckets`` ([le, count] pairs ending at
    "+Inf"), ``sum`` and ``count``. Series:

      <prefix>_events_total{kind=...}        every event kind (faults,
                                             retries, restarts, sheds,
                                             restores, stragglers, ...)
      <prefix>_faults_total{point=,fault=}   injected/observed faults by
                                             injection point and kind
      <prefix>_feed_rebalance_total          data-plane lane re-maps on
                                             membership change (emitted
                                             only once any occurred)
      <prefix>_feed_epoch{host=}             gauge: slowest owned feed
                                             lane's epoch per host
      <prefix>_feed_stream_lag{host=}        gauge: committed samples a
                                             host's feed streams trail
                                             the most-advanced host
      <prefix>_transport_reconnects_total    socket-coordinator client
                                             reconnects (emitted only
                                             once any occurred)
      <prefix>_transport_failovers_total     client endpoint failovers
                                             that reached a serving
                                             (promoted) coordination
                                             member (emitted only once
                                             any occurred)
      <prefix>_transport_heartbeat_lag{host=}  gauge: seconds a host's
                                             liveness heartbeat cadence
                                             is running behind (0 when
                                             healthy)
      <prefix>_transport_term{host=}         gauge: the replication
                                             term last observed (per
                                             client host; the unlabeled
                                             series is the server's own
                                             promote/demote view) — a
                                             host pinned BELOW the
                                             others is talking to a
                                             stale ex-primary
      <prefix>_transport_replication_lag     gauge: ops the furthest-
                                             behind in-sync standby
                                             trails the primary
      <prefix>_collective_bytes_total{kind=} raw-vs-wire bytes of the
      <prefix>_stateship_bytes_total{kind=}  block-quantized gradient
      <prefix>_ckpt_bytes_total{kind=}       all-reduce / elastic state
                                             ship / checkpoint payloads
                                             (kind="raw" is what the
                                             uncompressed path would
                                             move; kind="wire" what
                                             actually moved — the pair
                                             makes compression ratios
                                             assertable, see
                                             record_bytes)
      <prefix>_router_requests_total{outcome=}  serving-fleet router
                                             requests by terminal
                                             outcome (ok/shed/deadline/
                                             error — cumulative process
                                             counters, see
                                             record_router_request)
      <prefix>_router_retries_total{replica=}  failed dispatch attempts
                                             retried on a sibling
                                             (cumulative — load-driven
                                             5xx retries run at request
                                             rate and must not ride the
                                             bounded event log)
      <prefix>_router_queue_depth            gauge: requests waiting in
                                             the router's coalescing
                                             queue
      <prefix>_router_replica_inflight{replica=}  gauge: batches the
                                             router has in flight at
                                             each replica
      <prefix>_router_batch_size             histogram: requests
                                             coalesced per dispatched
                                             micro-batch
      <prefix>_restore_latency_seconds       checkpoint-restore wall time
                                             (from restore events'
                                             latency_s)
      <prefix>_buddy_snapshot_bytes_total{kind=}  raw-vs-wire bytes of
                                             the buddy-checkpoint tier's
                                             window snapshots (rides the
                                             same record_bytes channel
                                             discipline as the pairs
                                             above)
      <prefix>_buddy_restore_total{outcome=} buddy-restore attempts by
                                             outcome (ok, or the typed
                                             disk-fallback reason:
                                             buddy_missing/buddy_stale/
                                             buddy_and_host_lost/
                                             snapshot_torn)
      <prefix>_buddy_generation{host=}       gauge: the buddy-snapshot
                                             generation each host last
                                             published (strict probes
                                             compare these across live
                                             hosts)

    The result dict also carries a ``gauges`` list (same shape as
    counters) for the feed-plane last-value series.

    ``metrics_text()`` renders the exposition format; a scraper
    sidecar/pushgateway can serve it as-is (or pull it live from
    :func:`serve_metrics`). Pass ``event_list`` to aggregate a snapshot
    instead of the live log. ``by_host=True`` additionally labels the
    event counters with the per-host tags :func:`context` attached
    (``{kind=...,host=...}``) so one pod-wide scrape still tells the
    hosts apart; events recorded outside a host context keep the plain
    ``{kind=...}`` series."""
    evs = _LOG.events() if event_list is None else list(event_list)
    if by_host:
        kind_counts = collections.Counter(
            (e["kind"], e.get("host")) for e in evs)
        counters = [
            {"name": METRIC_PREFIX + "_events_total",
             "labels": {"kind": kind} if host is None
             else {"kind": kind, "host": str(host)}, "value": n}
            for (kind, host), n in sorted(
                kind_counts.items(),
                key=lambda kv: (kv[0][0], str(kv[0][1])))]
    else:
        kind_counts = collections.Counter(e["kind"] for e in evs)
        counters = [
            {"name": METRIC_PREFIX + "_events_total",
             "labels": {"kind": kind}, "value": n}
            for kind, n in sorted(kind_counts.items())]
    fault_counts = collections.Counter(
        (e.get("point", "?"), e.get("fault", "?"))
        for e in evs if e["kind"] == "fault")
    counters += [
        {"name": METRIC_PREFIX + "_faults_total",
         "labels": {"point": p, "fault": f}, "value": n}
        for (p, f), n in sorted(fault_counts.items())]
    # feed-plane series (elastic data plane): emitted only when the
    # corresponding events exist, so feed-less jobs export nothing new
    n_rebalance = sum(1 for e in evs if e["kind"] == "feed_rebalance")
    if n_rebalance:
        counters.append({"name": METRIC_PREFIX + "_feed_rebalance_total",
                         "labels": {}, "value": n_rebalance})
    # transport series (socket coordinator): reconnect attempts are a
    # counter; the heartbeat cadence lag is a per-host last-value gauge
    n_reconnect = sum(1 for e in evs
                      if e["kind"] == "transport_reconnect")
    if n_reconnect:
        counters.append(
            {"name": METRIC_PREFIX + "_transport_reconnects_total",
             "labels": {}, "value": n_reconnect})
    # coordination-plane HA: failovers are the headline counter (a
    # SIGKILLed primary costs exactly one per client, not an abort)
    n_failover = sum(1 for e in evs
                     if e["kind"] == "transport_failover")
    if n_failover:
        counters.append(
            {"name": METRIC_PREFIX + "_transport_failovers_total",
             "labels": {}, "value": n_failover})
    # compressed-movement byte accounting (quantized collectives, elastic
    # state ship, checkpoint payloads): raw-vs-wire counter pairs from the
    # cumulative process counters — emitted only for channels that moved
    # bytes, so jobs without the compression paths export nothing new.
    # NB: these ride the live counters even for event_list snapshots
    # (they are not events — snapshotting them is bytes_totals()).
    for ch, tot in sorted(bytes_totals().items()):
        for kind in ("raw", "wire"):
            counters.append(
                {"name": "%s_%s_bytes_total" % (METRIC_PREFIX, ch),
                 "labels": {"kind": kind}, "value": tot[kind]})
    # kernel-selection decisions (ops/kernel_dispatch.choose): cumulative
    # counters like the byte pairs, emitted only once a compile decided
    for (op, impl, source), n in sorted(kernel_choice_totals().items()):
        counters.append(
            {"name": METRIC_PREFIX + "_kernel_choice_total",
             "labels": {"op": op, "impl": impl, "source": source},
             "value": n})
    # program-verifier diagnostics (framework/analysis.py): cumulative
    # per-(pass, severity) counters — emitted only once a verification
    # produced diagnostics, so clean jobs export nothing new
    for (pass_name, severity), n in sorted(analysis_totals().items()):
        counters.append(
            {"name": METRIC_PREFIX + "_analysis_diagnostics_total",
             "labels": {"pass": pass_name, "severity": severity},
             "value": n})
    # serving-fleet router series (cumulative process counters like the
    # byte pairs — NOT events; see record_router_request): emitted only
    # once the router did anything, so router-less jobs export nothing
    # new. Counter: requests by terminal outcome. Gauges: queue depth +
    # per-replica in-flight. Histogram: coalesced batch size. Every
    # series is per-ROUTER (router= label) so N concurrent routers in
    # one process never overwrite each other; the unlabeled series is
    # the single-router/legacy shape.
    by_router = router_totals(by_router=True)

    def _rlbl(rkey, **extra):
        lbl = dict(extra)
        if rkey is not None:
            lbl["router"] = rkey
        return lbl

    router_hists = []
    for rkey, rt in by_router.items():
        counters += [
            {"name": METRIC_PREFIX + "_router_requests_total",
             "labels": _rlbl(rkey, outcome=outcome), "value": n}
            for outcome, n in sorted(rt["requests"].items())]
        counters += [
            {"name": METRIC_PREFIX + "_router_retries_total",
             "labels": _rlbl(rkey, replica=str(r)), "value": n}
            for r, n in sorted(rt["retries"].items())]
        # QoS additions: per-tenant outcome counters alongside the
        # aggregate (never instead of it — the aggregate above is the
        # tenant-less deployment's exact historical series), plus the
        # deadline-budget-expiry counters by catch point
        counters += [
            {"name": METRIC_PREFIX + "_router_requests_total",
             "labels": _rlbl(rkey, outcome=outcome, tenant=t),
             "value": n}
            for t, by_out in sorted(rt["tenants"].items())
            for outcome, n in sorted(by_out.items())]
        counters += [
            {"name": METRIC_PREFIX + "_router_deadline_expired_total",
             "labels": _rlbl(rkey, where=where, tenant=t), "value": n}
            for where, by_t in sorted(rt["expired"].items())
            for t, n in sorted(by_t.items())]
        if rt["batch_count"]:
            router_hists.append(_counts_histogram(
                METRIC_PREFIX + "_router_batch_size",
                ROUTER_BATCH_BUCKETS, rt["batch_counts"],
                rt["batch_count"], rt["batch_sum"],
                labels=_rlbl(rkey)))
    last_epoch, last_lag, last_hb = {}, {}, {}
    last_term, last_repl_lag = {}, {}
    last_lterm, last_target = {}, {}
    for e in evs:
        if e["kind"] == "feed_epoch":
            last_epoch[e.get("host")] = e.get("epoch", 0)
        elif e["kind"] == "feed_lag":
            last_lag[e.get("host")] = e.get("lag", 0)
        elif e["kind"] == "transport_hb_lag":
            last_hb[e.get("host")] = e.get("lag_s", 0.0)
        elif e["kind"] in ("transport_term", "transport_promote"):
            # per-client-host term views, plus the server's own
            # (unlabeled) promote/demote view: a host whose gauge sits
            # below the others is still trusting a stale ex-primary
            last_term[e.get("host")] = e.get("term", 0)
        elif e["kind"] == "transport_repl_lag":
            last_repl_lag[e.get("host")] = e.get("lag", 0)
        elif e["kind"] == "fleet_leader_term":
            # per-router admission-leader term views (the router-tier
            # twin of transport_term): a router pinned below its peers
            # is still trusting a stale ex-leader
            last_lterm[e.get("router")] = e.get("term", 0)
        elif e["kind"] == "fleet_autoscale":
            # last autoscale decision's target replica count
            last_target[None] = e.get("target", 0)
    gauges = []
    for name, series, label in (
            (METRIC_PREFIX + "_feed_epoch", last_epoch, "host"),
            (METRIC_PREFIX + "_feed_stream_lag", last_lag, "host"),
            (METRIC_PREFIX + "_transport_heartbeat_lag", last_hb,
             "host"),
            (METRIC_PREFIX + "_transport_term", last_term, "host"),
            (METRIC_PREFIX + "_transport_replication_lag",
             last_repl_lag, "host"),
            (METRIC_PREFIX + "_fleet_leader_term", last_lterm,
             "router"),
            (METRIC_PREFIX + "_fleet_target_replicas", last_target,
             "router")):
        gauges += [{"name": name,
                    "labels": {} if h is None else {label: str(h)},
                    "value": v}
                   for h, v in sorted(series.items(),
                                      key=lambda kv: str(kv[0]))]
    for rkey, rt in by_router.items():
        if rt["queue_depth"] is not None:
            gauges.append(
                {"name": METRIC_PREFIX + "_router_queue_depth",
                 "labels": _rlbl(rkey), "value": rt["queue_depth"]})
        gauges += [{"name": METRIC_PREFIX + "_router_replica_inflight",
                    "labels": _rlbl(rkey, replica=str(r)), "value": v}
                   for r, v in sorted(rt["inflight"].items())]
        gauges += [{"name": METRIC_PREFIX + "_router_tenant_queue_depth",
                    "labels": _rlbl(rkey, tenant=t), "value": v}
                   for t, v in sorted(rt["tenant_queue_depth"].items())]
    # elastic pp re-cut (stage re-stacking over a shrunk mesh): the
    # re-cut counter, the last re-cut's retarget wall, and the CURRENT
    # slot count + live-host pair (both from the last pp retarget
    # event — re-grow moves them back) — emitted only for pods that
    # ever re-cut, so plain pods export nothing new. serving_probe
    # --strict cross-checks pp_slots against pp_live_hosts: more slots
    # than surviving hosts means a torn re-cut.
    recut_evs = [e for e in evs if e["kind"] == "elastic_pp_recut"]
    if recut_evs:
        counters.append({"name": METRIC_PREFIX + "_pp_recut_total",
                         "labels": {}, "value": len(recut_evs)})
        last_ms = next((1000.0 * float(e["latency_s"])
                        for e in reversed(recut_evs)
                        if "latency_s" in e), None)
        if last_ms is not None:
            gauges.append({"name": METRIC_PREFIX + "_pp_recut_ms",
                           "labels": {}, "value": round(last_ms, 3)})
    last_pp = next((e for e in reversed(evs)
                    if "pp_slots" in e
                    and e["kind"] in ("elastic_pp_recut",
                                      "elastic_grow")), None)
    if last_pp is not None:
        gauges.append({"name": METRIC_PREFIX + "_pp_slots",
                       "labels": {}, "value": int(last_pp["pp_slots"])})
        cap = str(last_pp.get("capacity", "")).partition("/")[0]
        if cap.isdigit():
            gauges.append({"name": METRIC_PREFIX + "_pp_live_hosts",
                           "labels": {}, "value": int(cap)})
    restore_lat = [e["latency_s"] for e in evs
                   if e["kind"] == "restore" and "latency_s" in e]
    histograms = [_histogram(METRIC_PREFIX + "_restore_latency_seconds",
                             restore_lat, RESTORE_LATENCY_BUCKETS)]
    histograms += router_hists
    # executor step-phase latency (the obs layer's always-on metrics
    # half): per-kind histograms from the cumulative process counters —
    # emitted only for phases that ran, so executor-less jobs export
    # nothing new
    for kind, h in sorted(executor_step_totals().items()):
        if h["count"]:
            histograms.append(_counts_histogram(
                METRIC_PREFIX + "_executor_step_seconds",
                EXEC_STEP_BUCKETS, h["counts"], h["count"], h["sum"],
                labels={"kind": kind}))
    # failpoint plane (framework/faultinject.py): fired-hit counters by
    # site plus an armed gauge — emitted only when something armed or
    # fired, so production processes export nothing new; when anything
    # IS exported, serving_probe --strict refuses the scrape on
    # armed=1 (live failpoints have no business in production)
    from . import faultinject
    counters += [
        {"name": METRIC_PREFIX + "_failpoint_hits_total",
         "labels": {"site": site}, "value": n}
        for site, n in sorted(faultinject.hits_total().items())]
    if faultinject.armed() or faultinject.hits_total():
        gauges.append(
            {"name": METRIC_PREFIX + "_faultinject_armed",
             "labels": {}, "value": 1 if faultinject.armed() else 0})
    # numeric-fault recovery (BuildStrategy numeric_policy): one
    # counter per (policy, culprit) from the numeric_fault events —
    # the chaos battery and serving_probe assert on the culprit label
    nf_counts = collections.Counter(
        (e.get("policy", "?"), e.get("culprit", "?"))
        for e in evs if e["kind"] == "numeric_fault")
    counters += [
        {"name": METRIC_PREFIX + "_numeric_fault_total",
         "labels": {"policy": p, "culprit": c}, "value": n}
        for (p, c), n in sorted(nf_counts.items())]
    # buddy-checkpoint tier (framework/buddy.py): restore outcomes by
    # label plus the per-host last-published-generation gauge — emitted
    # only for pods that ever ran the buddy tier, so plain jobs export
    # nothing new. serving_probe --strict compares the generation
    # gauges across live hosts (divergence > 1 window = some host's
    # snapshots are not landing).
    br_counts = collections.Counter(
        e.get("outcome", "?") for e in evs
        if e["kind"] == "buddy_restore")
    counters += [
        {"name": METRIC_PREFIX + "_buddy_restore_total",
         "labels": {"outcome": o}, "value": n}
        for o, n in sorted(br_counts.items())]
    gauges += [
        {"name": METRIC_PREFIX + "_buddy_generation",
         "labels": {"host": str(h)}, "value": g}
        for h, g in sorted(buddy_gens().items())]
    # p2p mailbox gauges: residency per mailbox host (the coordinator's
    # row, host="coord", is the memory-ceiling gate serving_probe
    # --strict enforces), the last send's delta wire ratio, and the
    # last host-to-host pull latency. Nothing recorded -> nothing
    # exported.
    gauges += [
        {"name": METRIC_PREFIX + "_buddy_resident_bytes",
         "labels": {"host": str(h)}, "value": b}
        for h, b in sorted(buddy_resident().items())]
    if buddy_delta_ratio() is not None:
        gauges.append({"name": METRIC_PREFIX + "_buddy_delta_ratio",
                       "labels": {}, "value": buddy_delta_ratio()})
    if buddy_fetch_ms() is not None:
        gauges.append({"name": METRIC_PREFIX + "_buddy_p2p_fetch_ms",
                       "labels": {}, "value": buddy_fetch_ms()})
    # span-ring overflow (obs tentpole): dropped spans mean a merged
    # timeline is LYING about what happened — exported whenever the
    # engine is on (0 = trustworthy) or anything was ever dropped, so
    # serving_probe --strict can gate on it; tracing-off jobs export
    # nothing new
    from . import obs
    if obs.enabled() or obs.dropped_total():
        counters.append(
            {"name": METRIC_PREFIX + "_trace_spans_dropped_total",
             "labels": {}, "value": obs.dropped_total()})
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def _escape_label_value(v):
    """Prometheus exposition escaping for label VALUES: backslash,
    double quote and newline (in that order — escaping the escape
    first keeps it reversible). An unescaped quote in, say, a
    replica-address label would tear the sample line into invalid
    exposition text that every scraper rejects."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label_value(v):
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt,
                                                            c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_labels(labels):
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _escape_label_value(v))
        for k, v in sorted(labels.items()))


def metrics_text(m=None):
    """Render :func:`metrics` in the Prometheus text exposition format."""
    m = m if m is not None else metrics()
    lines = []
    seen_type = set()
    for c in m["counters"]:
        if c["name"] not in seen_type:
            seen_type.add(c["name"])
            lines.append("# TYPE %s counter" % c["name"])
        lines.append("%s%s %g" % (c["name"], _fmt_labels(c["labels"]),
                                  c["value"]))
    for g in m.get("gauges", ()):
        if g["name"] not in seen_type:
            seen_type.add(g["name"])
            lines.append("# TYPE %s gauge" % g["name"])
        lines.append("%s%s %g" % (g["name"], _fmt_labels(g["labels"]),
                                  g["value"]))
    for h in m["histograms"]:
        lines.append("# TYPE %s histogram" % h["name"])
        for le, n in h["buckets"]:
            labels = dict(h["labels"], le=le)
            lines.append("%s_bucket%s %d" % (h["name"],
                                             _fmt_labels(labels), n))
        lines.append("%s_sum%s %g" % (h["name"], _fmt_labels(h["labels"]),
                                      h["sum"]))
        lines.append("%s_count%s %d" % (h["name"],
                                        _fmt_labels(h["labels"]),
                                        h["count"]))
    return "\n".join(lines) + "\n"


def parse_metrics_text(text):
    """Parse a text exposition back into ``[(name, labels, value)]`` —
    the round-trip half used by tests and by scrapers that want the
    samples without a Prometheus client library."""
    import re
    # label values are quoted strings with \\, \" and \n escapes (see
    # _escape_label_value) — the blob/value regexes must track quoting
    # or a value containing '}' / '"' tears the parse
    label_val = r'"(?:[^"\\]|\\.)*"'
    line_re = re.compile(
        r'^([A-Za-z_:][\w:]*)(\{(?:[^"{}]|%s)*\})?\s+(\S+)$'
        % label_val)
    pair_re = re.compile(r'(\w+)=(%s)' % label_val)
    samples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if not m:
            raise ValueError("unparsable metrics line: %r" % line)
        name, labelblob, value = m.groups()
        labels = {}
        if labelblob:
            for k, quoted in pair_re.findall(labelblob):
                labels[k] = _unescape_label_value(quoted[1:-1])
        samples.append((name, labels, float(value)))
    return samples




class MetricsServer(object):
    """A tiny stdlib HTTP listener serving the live metrics exposition.

    ``GET /metrics`` renders ``metrics_text(metrics(by_host=True))`` at
    request time — per-host labels ride the :func:`context` tags — and
    ``GET /healthz`` answers 200 (liveness). Runs on a daemon thread;
    :meth:`close` shuts it down. Start one via :func:`serve_metrics`.
    """

    def __init__(self, port=0, host="127.0.0.1"):
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 - stdlib naming
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = metrics_text(metrics(by_host=True)).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404, "try /metrics")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log lines
                pass

        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       _Handler)
        self.host, self.port = self._server.server_address[:2]
        self.url = "http://%s:%d/metrics" % (self.host, self.port)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="paddle_tpu-metrics-%d" % self.port)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_metrics(port=0, host="127.0.0.1"):
    """Start the metrics pull endpoint (Prometheus text exposition at
    ``/metrics``, per-host labels from :func:`context` tags).

    ``port=0`` binds an ephemeral port — read it back from the returned
    server's ``.port``/``.url``. The listener renders the live event
    log on every scrape, so there is nothing to push and nothing goes
    stale; ``paddle_tpu_torch.tools.serving_probe --metrics-url``
    knows how to scrape it. Call ``.close()`` (or use as a context
    manager) to stop."""
    server = MetricsServer(port=port, host=host)
    record_event("metrics_serve", url=server.url)
    return server


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

# point -> kinds it accepts (parse-time validation: a typo'd chaos spec
# must fail loudly at configure time, not silently never fire)
_POINT_KINDS = {
    "step": ("preempt", "collective_timeout", "nan", "die"),
    "ckpt_write": ("io_error",),
    "serve": ("slow", "error"),
}


class FaultSpec(object):
    """One parsed fault: ``point:kind[=arg][@N | ~p]``.

    ``@N``  fire exactly at the N-th call of the point (1-based, default 1)
    ``~p``  fire each call with probability p (seeded — deterministic)
    ``=arg`` float argument (e.g. ``serve:slow=2.0`` sleeps 2 seconds)
    """

    def __init__(self, point, kind, at=None, prob=None, arg=None):
        if point not in _POINT_KINDS:
            raise ValueError("unknown injection point %r (have %s)"
                             % (point, sorted(_POINT_KINDS)))
        if kind not in _POINT_KINDS[point]:
            raise ValueError("injection point %r has no fault kind %r "
                             "(have %s)" % (point, kind,
                                            _POINT_KINDS[point]))
        self.point, self.kind, self.arg = point, kind, arg
        self.at = at if prob is not None or at is not None else 1
        self.prob = prob

    @classmethod
    def parse(cls, text):
        text = text.strip()
        if ":" not in text:
            raise ValueError("fault spec %r needs the form "
                             "point:kind[=arg][@N|~p]" % text)
        point, rest = text.split(":", 1)
        at = prob = arg = None
        if "@" in rest:
            rest, n = rest.rsplit("@", 1)
            at = int(n)
        elif "~" in rest:
            rest, p = rest.rsplit("~", 1)
            prob = float(p)
        if "=" in rest:
            rest, a = rest.split("=", 1)
            arg = float(a)
        return cls(point.strip(), rest.strip(), at=at, prob=prob, arg=arg)

    def __repr__(self):
        tail = "@%d" % self.at if self.prob is None else "~%g" % self.prob
        arg = "" if self.arg is None else "=%g" % self.arg
        return "FaultSpec(%s:%s%s%s)" % (self.point, self.kind, arg, tail)


class FaultInjector(object):
    """Deterministic chaos harness.

    Configure with a spec string (``;`` or ``,`` separated FaultSpecs) or
    a list of FaultSpec objects, plus a seed for probabilistic specs.
    Production code calls :func:`fire` at its injection points; with no
    injector installed that is a near-free no-op."""

    def __init__(self, specs="", seed=0):
        if isinstance(specs, str):
            parts = [s for chunk in specs.split(";")
                     for s in chunk.split(",") if s.strip()]
            self.specs = [FaultSpec.parse(s) for s in parts]
        else:
            self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)
        self._counts = {}
        self._lock = threading.Lock()

    def counts(self):
        """{point: number of fire() calls seen} — test introspection."""
        with self._lock:
            return dict(self._counts)

    def fire(self, point, what=""):
        """Evaluate the specs for ``point`` at this call.

        Raises the fault's error for raising kinds; returns an action
        dict (e.g. ``{"slow_s": 2.0}``) for behavioral kinds."""
        with self._lock:
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            hits = []
            for spec in self.specs:
                if spec.point != point:
                    continue
                if spec.prob is not None:
                    if self._rng.random() >= spec.prob:
                        continue
                elif spec.at != n:
                    continue
                hits.append(spec)
        actions = {}
        for spec in hits:
            record_event("fault", point=point, fault=spec.kind, call=n,
                         what=what)
            if spec.kind == "preempt":
                raise SimulatedPreemptionError(
                    "injected preemption at %s call %d%s"
                    % (point, n, (" (%s)" % what) if what else ""))
            if spec.kind == "die":
                raise SimulatedHostDeathError(
                    "injected host death at %s call %d%s"
                    % (point, n, (" (%s)" % what) if what else ""))
            if spec.kind == "collective_timeout":
                raise CollectiveTimeoutError(
                    "injected collective timeout at %s call %d" % (point, n))
            if spec.kind == "nan":
                raise FloatingPointError(
                    "injected NaN blowup at %s call %d" % (point, n))
            if spec.kind == "io_error":
                raise OSError(
                    "injected checkpoint I/O error at %s call %d"
                    % (point, n))
            if spec.kind == "error":
                raise RuntimeError(
                    "injected serving failure at %s call %d" % (point, n))
            if spec.kind == "slow":
                actions["slow_s"] = spec.arg if spec.arg is not None else 1.0
        return actions


_state = {"injector": None, "env_loaded": False}


def install(injector):
    """Install an injector globally (None uninstalls). Returns it."""
    _state["injector"] = injector
    _state["env_loaded"] = True   # explicit install wins over env
    return injector


def current_injector():
    if _state["injector"] is None and not _state["env_loaded"]:
        _state["env_loaded"] = True
        spec = os.environ.get("PADDLE_TPU_FAULTS", "")
        if spec:
            # the env var is shared with framework/faultinject.py:
            # dotted-site specs ("transport.send:raise@3") belong to
            # the failpoint plane; only bare legacy points are ours
            parts = [s for chunk in spec.split(";")
                     for s in chunk.split(",") if s.strip()]
            legacy = [s for s in parts
                      if "." not in s.strip().split(":", 1)[0]]
            if legacy:
                seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED",
                                          "0") or 0)
                _state["injector"] = FaultInjector(",".join(legacy),
                                                   seed=seed)
    return _state["injector"]


def reload_env():
    """Drop the cached env injector and re-read PADDLE_TPU_FAULTS."""
    _state["injector"] = None
    _state["env_loaded"] = False
    return current_injector()


@contextlib.contextmanager
def inject(specs, seed=0):
    """Context manager: install a FaultInjector for the enclosed block."""
    inj = specs if isinstance(specs, FaultInjector) \
        else FaultInjector(specs, seed=seed)
    old_inj, old_env = _state["injector"], _state["env_loaded"]
    _state["injector"], _state["env_loaded"] = inj, True
    try:
        yield inj
    finally:
        _state["injector"], _state["env_loaded"] = old_inj, old_env


def fire(point, what=""):
    """Production injection hook — a no-op unless an injector is
    installed (or PADDLE_TPU_FAULTS is set)."""
    inj = current_injector()
    if inj is None:
        return {}
    return inj.fire(point, what=what)


# ---------------------------------------------------------------------------
# silent-data-corruption detection (the pod's tripwire)
# ---------------------------------------------------------------------------

class SDCDetector(object):
    """Per-host norm outlier detection. A host with a flaky ALU computes
    wrong but finite values that no finite mask sees; what shows is its
    norm drifting from its peers' on identical replicated math. Fed one
    scalar per host per window, a host whose robust deviation from the
    pod median, ``|x_h - median(x)| / (MAD(x) + eps)``, exceeds
    ``threshold`` for ``consecutive`` windows is flagged a suspect once
    (an ``sdc_suspect`` event) and handed to ElasticTrainer's drain.
    Median and MAD, so that the corrupt host's own values cannot mask
    themselves; the consecutive gate ignores a one-window spike."""

    def __init__(self, threshold=6.0, consecutive=3, window=32,
                 eps=1e-12):
        if consecutive < 1:
            raise ValueError("consecutive must be >= 1")
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self.window = int(window)
        self.eps = float(eps)
        self._streak = {}      # host -> consecutive outlier windows
        self._history = collections.deque(maxlen=self.window)
        self._suspects = set()
        self._lock = threading.Lock()

    def observe(self, norms, step=None):
        """One window's ``{host: norm}``; returns the newly flagged
        hosts (usually none)."""
        vals = {h: float(v) for h, v in norms.items()}
        if len(vals) < 3:
            return []   # a median of 2 cannot tell who is wrong
        xs = sorted(vals.values())
        mid = len(xs) // 2
        med = xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])
        devs = sorted(abs(v - med) for v in xs)
        mad = devs[mid] if len(devs) % 2 \
            else 0.5 * (devs[mid - 1] + devs[mid])
        new = []
        with self._lock:
            self._history.append(dict(vals))
            for h, v in vals.items():
                score = abs(v - med) / (mad + self.eps)
                # a non-finite norm is an outlier by definition
                outlier = score > self.threshold or v != v
                self._streak[h] = self._streak.get(h, 0) + 1 \
                    if outlier else 0
                if self._streak[h] >= self.consecutive \
                        and h not in self._suspects:
                    self._suspects.add(h)
                    new.append(h)
                    record_event("sdc_suspect", host_suspect=str(h),
                                 score=round(score, 3),
                                 streak=self._streak[h],
                                 **({} if step is None
                                    else {"step": int(step)}))
        return new

    def suspects(self):
        with self._lock:
            return set(self._suspects)

    def clear(self, host=None):
        """Forget a drained host (or everything)."""
        with self._lock:
            if host is None:
                self._suspects.clear()
                self._streak.clear()
                self._history.clear()
            else:
                self._suspects.discard(host)
                self._streak.pop(host, None)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

# Transient: the operation may succeed on replay from a clean state —
# hung/injected collectives, preemptions, torn I/O, NaN blowups (restore
# rewinds past the poisoned state; a deterministic NaN re-fires and the
# restart budget converts it to a hard failure).
_TRANSIENT_TYPES = (CollectiveTimeoutError, SimulatedPreemptionError,
                    ServerOverloadedError, OSError, TimeoutError,
                    ConnectionError, FloatingPointError)
# Fatal: program-shape bugs — shape/sharding/dtype mismatches replay
# identically, so retrying only burns the budget.
_FATAL_TYPES = (ValueError, TypeError, KeyError, IndexError,
                NotImplementedError, AssertionError)


def classify(err):
    """'transient' (worth a retry/restore) or 'fatal' (re-raise now)."""
    if isinstance(err, _FATAL_TYPES):
        return "fatal"
    if isinstance(err, _TRANSIENT_TYPES):
        return "transient"
    return "fatal"


class RetryPolicy(object):
    """Exponential backoff with (seeded, deterministic) jitter.

    delay(attempt) = min(base * multiplier**attempt, max) * U[1-jitter, 1]
    """

    def __init__(self, max_attempts=4, base_delay_s=0.05, max_delay_s=5.0,
                 multiplier=2.0, jitter=0.5, seed=0, sleep=time.sleep,
                 classify=classify):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.sleep = sleep
        self._classify = classify
        self._rng = random.Random(seed)

    def is_transient(self, err):
        return self._classify(err) == "transient"

    def delay_s(self, attempt):
        """Backoff before retry number ``attempt`` (0-based)."""
        d = min(self.base_delay_s * self.multiplier ** attempt,
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` with transient-retry; fatal errors raise through.
        ``what=`` names the operation in events."""
        what = kwargs.pop("what", getattr(fn, "__name__", "operation"))
        last = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                last = e
                if not self.is_transient(e) \
                        or attempt + 1 >= self.max_attempts:
                    raise
                d = self.delay_s(attempt)
                record_event("retry", what=what, attempt=attempt + 1,
                             error=type(e).__name__, backoff_s=d)
                self.sleep(d)
        raise last   # pragma: no cover - loop always returns or raises


# ---------------------------------------------------------------------------
# deadline helper (serving)
# ---------------------------------------------------------------------------

def run_with_deadline(fn, deadline_s, what="request"):
    """Run ``fn()`` with a wall-clock bound.

    Shares watchdog.bounded_call with wait_with_timeout — the same
    detect-the-hang mechanism, lifted from device waits to arbitrary
    host work (injected slowness, cold-bucket compiles). The work
    itself cannot be cancelled; the CALLER gets
    control back with a DeadlineExceededError and the orphaned thread
    finishes (and warms any compile cache) in the background."""
    if deadline_s is None:
        return fn()
    done, value, err = bounded_call(fn, deadline_s,
                                    name="paddle_tpu-deadline")
    if not done:
        record_event("deadline", what=what, deadline_s=float(deadline_s))
        raise DeadlineExceededError(
            "%s did not complete within its %.2fs deadline"
            % (what, float(deadline_s)))
    if err is not None:
        raise err
    return value


# ---------------------------------------------------------------------------
# resilient training
# ---------------------------------------------------------------------------

def _stack_feeds(feed_dicts):
    """[{name: per-step array}] -> {name: stacked (steps, ...) array} for
    Executor.run_steps."""
    import numpy as np
    keys = set(feed_dicts[0])
    for f in feed_dicts[1:]:
        if set(f) != keys:
            raise ValueError("all feeds in a run_steps window need the "
                             "same keys; got %s vs %s"
                             % (sorted(keys), sorted(f)))
    return {k: np.stack([np.asarray(f[k]) for f in feed_dicts])
            for k in keys}



class ResilientTrainer(object):
    """Auto-recovering training loop.

    Wraps Executor.run / run_steps (a plain Program or a CompiledProgram,
    whose collective-timeout watchdog raises into the same handler):
    steps run in dispatch windows, the whole scope is checkpointed every
    ``checkpoint_every`` steps, and a transient failure (see
    :func:`classify`) triggers backoff -> restore of the latest valid
    checkpoint (io.load_checkpoint quarantines a torn step dir) ->
    rewind -> replay. A checkpoint carries the parameters, the optimizer
    state and the scope's run counter (the seed of every random draw), so
    the replayed trajectory equals an uninterrupted run bit for bit.

    The restart budget bounds the recoveries of one run() call; a fault
    that keeps firing becomes RestartBudgetExceededError. ``feed=`` (a
    ShardedFeed) belongs to the multi-GPU slice and raises
    NotPortedError.
    """

    def __init__(self, executor, program, ckpt_dir, fetch_list=None,
                 checkpoint_every=10, max_restarts=3, retry_policy=None,
                 steps_per_dispatch=1, keep_last=3, scope=None,
                 async_checkpoints=False, feed=None, ckpt_compress=None):
        from .compiler import CompiledProgram
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if feed is not None:
            raise NotPortedError(
                "ResilientTrainer(feed=...) pulls windows from a "
                "reader.ShardedFeed across hosts; it arrives with the "
                "torch.distributed (multi-GPU) slice of paddle_tpu_torch "
                "— pass the batches to run(feeds) instead")
        self._executor = executor
        self._target = program   # what executor.run receives
        self._program = program._program \
            if isinstance(program, CompiledProgram) else program
        self._ckpt_dir = ckpt_dir
        self._fetch_list = fetch_list
        self._checkpoint_every = int(checkpoint_every)
        self._max_restarts = int(max_restarts)
        self._policy = retry_policy or RetryPolicy()
        self._steps_per_dispatch = int(steps_per_dispatch)
        self._keep_last = int(keep_last)
        # explicit scope (None = the process-global scope)
        self._scope = scope
        # async_checkpoints=True moves the file commit off the step path
        # (io.save_checkpoint blocking=False)
        self._async_ckpt = bool(async_checkpoints)
        # ckpt_compress: io.save_checkpoint(compress=) for every periodic
        # snapshot (None, "zlib" or "q8"); restores are transparent
        self._ckpt_compress = ckpt_compress
        # numeric_policy="rewind" recovery: global batch indices whose
        # data poisoned a step; the replay after the restore skips them,
        # so the recovered trajectory is the uninterrupted run without
        # them, bit for bit
        self._poison_batches = set()

    # -- events convenience ------------------------------------------------
    @staticmethod
    def events(kind=None):
        return events(kind)

    def _save(self, step):
        from .. import io as io_mod
        io_mod.save_checkpoint(self._executor, self._ckpt_dir,
                               self._program, step=step,
                               keep_last=self._keep_last,
                               blocking=not self._async_ckpt,
                               scope=self._scope,
                               compress=self._ckpt_compress)
        record_event("ckpt", step=step)

    def _restore(self, step=None, shardings=None):
        """Restore ``step`` or the latest valid checkpoint. Joins an
        in-flight asynchronous commit first: a commit still writing
        while the restore picks its step could tear the very dir it
        reads. A failed asynchronous commit is recorded, not raised: its
        torn step dir is what the load's quarantine handles.
        ``shardings`` goes to load_checkpoint (on one card the pod
        passes None: a size-1 mesh has nothing to re-shard)."""
        from .. import io as io_mod
        t0 = time.perf_counter()
        try:
            io_mod.wait_for_pending_saves()
        except Exception as e:
            record_event("ckpt_async_error", error=type(e).__name__)
        got = int(io_mod.load_checkpoint(self._executor, self._ckpt_dir,
                                         self._program, step=step,
                                         scope=self._scope,
                                         shardings=shardings))
        record_event("restore", step=got,
                     latency_s=time.perf_counter() - t0)
        return got

    def _dispatch(self, feeds, step, w, fetch_list):
        return self._dispatch_window(feeds[step:step + w], step,
                                     fetch_list)

    def _dispatch_window(self, batches, base_step, fetch_list):
        """Dispatch one window, dropping any batch whose global index
        was marked poisoned by a numeric-fault rewind. Skipped slots
        report ``None`` fetches; the step counter still advances over
        them so the checkpoint cadence and caller indexing hold."""
        if self._poison_batches:
            keep, skipped = [], []
            for i, b in enumerate(batches):
                if base_step + i in self._poison_batches:
                    skipped.append(base_step + i)
                else:
                    keep.append(b)
            if skipped:
                for idx in skipped:
                    record_event("poison_skip", batch=idx)
                outs = iter(self._dispatch_batches(keep, fetch_list)
                            if keep else [])
                return [None if base_step + i in self._poison_batches
                        else next(outs) for i in range(len(batches))]
        return self._dispatch_batches(batches, fetch_list)

    def _dispatch_batches(self, batches, fetch_list):
        """Run one window of batch feed dicts; returns the per-batch
        fetch lists."""
        import numpy as np
        if not batches:
            return []
        if len(batches) == 1:
            return [self._executor.run(self._target, feed=batches[0],
                                       fetch_list=fetch_list,
                                       scope=self._scope)]
        stacked = _stack_feeds(list(batches))
        outs = self._executor.run_steps(self._target, feed=stacked,
                                        fetch_list=fetch_list,
                                        scope=self._scope)
        return [[np.asarray(o)[i] for o in outs]
                for i in range(len(batches))]

    def _require_fresh_dir(self):
        """Refuse a pre-populated ckpt_dir: this run's step_0 baseline
        sorts OLDER than a previous run's step_48, so keep_last would
        prune it the moment it is written and the first restore would
        silently rewind into the previous run's stale trajectory."""
        if os.path.isdir(self._ckpt_dir):
            stale = sorted(d for d in os.listdir(self._ckpt_dir)
                           if d.startswith("step_")
                           and d.split("_", 1)[1].isdigit())
            if stale:
                raise ValueError(
                    "ckpt_dir %r already holds checkpoints (%s) — "
                    "ResilientTrainer.run starts a fresh trajectory at "
                    "step 0; give each run a clean directory"
                    % (self._ckpt_dir, ", ".join(stale)))

    def _resolved_fetch_list(self, fetch_list):
        fetch_list = fetch_list if fetch_list is not None \
            else self._fetch_list
        if not fetch_list:
            raise ValueError(
                "ResilientTrainer.run needs a fetch_list — an empty one "
                "would fall into Executor.run's eager path")
        return fetch_list

    def run(self, feeds=None, fetch_list=None, steps=None):
        """Run one step per feed dict in ``feeds``, recovering from
        transient faults. Returns the per-step fetch lists (replayed
        steps report their replayed — identical — values; a batch that a
        numeric rewind skipped reports None)."""
        if feeds is None:
            raise ValueError(
                "run(feeds=None) pulls from an attached ShardedFeed — "
                "pass feed= at construction (or pass feeds explicitly)")
        feeds = list(feeds)
        n = len(feeds)
        fetch_list = self._resolved_fetch_list(fetch_list)
        if n == 0:
            return []
        all_fetches = [None] * n
        self._require_fresh_dir()
        # baseline snapshot: a fault before the first periodic save must
        # still have something valid to restore
        self._save(0)
        step, restarts = 0, 0
        while step < n:
            until_ckpt = self._checkpoint_every \
                - (step % self._checkpoint_every)
            w = min(self._steps_per_dispatch, n - step, until_ckpt)
            try:
                outs = self._dispatch(feeds, step, w, fetch_list)
                for i in range(w):
                    all_fetches[step + i] = outs[i]
                step += w
                at_boundary = step % self._checkpoint_every == 0 \
                    or step == n
                if at_boundary:
                    self._save(step)
                if watchdog.straggler_action_due() and not at_boundary:
                    # straggler MITIGATION: the detector saw a step past
                    # its critical threshold — snapshot NOW so the hang
                    # this straggler is about to become costs at most
                    # one step of replay
                    self._save(step)
                    record_event("straggler_ckpt", step=step)
            except Exception as e:
                step, restarts = self._recover(e, step, restarts)
        return all_fetches

    def _recover(self, e, step, restarts):
        """The fault tail of run(): classify, spend restart budget, back
        off, restore. Returns the rewound (step, restarts); re-raises
        fatal errors and budget exhaustion."""
        if not self._policy.is_transient(e):
            record_event("fatal", step=step, error=type(e).__name__)
            raise e
        if isinstance(e, NumericFaultError) \
                and not isinstance(e, SkipBudgetExceededError):
            # numeric_policy="rewind": remember WHICH batch poisoned the
            # step so the post-restore replay runs without it — the
            # recovered trajectory equals the uninterrupted run minus
            # the poison batch (a deterministic NaN would otherwise
            # re-fire every replay until the budget converts it to a
            # hard failure)
            if e.batch_index is None:
                e.batch_index = step + int(e.window_offset or 0)
            if e.batch_index not in self._poison_batches:
                self._poison_batches.add(e.batch_index)
                record_event("poison_batch", batch=e.batch_index,
                             step=step, culprit=e.culprit)
        restarts += 1
        if restarts > self._max_restarts:
            record_event("giveup", step=step, restarts=restarts,
                         error=type(e).__name__)
            raise RestartBudgetExceededError(
                "restart budget (%d) exhausted at step %d; last "
                "error: %r" % (self._max_restarts, step, e))
        delay = self._policy.delay_s(restarts - 1)
        record_event("restart", step=step, restarts=restarts,
                     error=type(e).__name__, backoff_s=delay)
        _logger().warning(
            "step %d failed (%s: %s) — restart %d/%d after %.2fs",
            step, type(e).__name__, e, restarts,
            self._max_restarts, delay)
        self._policy.sleep(delay)
        return self._restore(), restarts


def __getattr__(name):
    # ElasticTrainer lives in coordination.py, which imports this module
    # at its top; resolve it lazily (PEP 562)
    if name == "ElasticTrainer":
        from .coordination import ElasticTrainer
        return ElasticTrainer
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
