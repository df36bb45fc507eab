"""obs: the spans engine.

Counterpart of paddle_tpu/framework/obs.py, the same engine: cheap
in-process spans that carry a distributed trace context, so that a
request's time can be followed from the caller into the Executor's
phases (and, once the serving fleet is ported, across processes).

Design:

  * A **span** is one timed operation: ``(trace, id, parent, name,
    t0, t1, labels, tid)``. Trace and span ids are random hex; the
    parent links spans into one request tree, also across processes.
  * **Trace context** rides a thread-local stack in-process and the
    ``x-trace-id: <trace>:<span>`` header between processes
    (:func:`header` / :func:`parse_header`).
  * Finished spans land in a **bounded per-process ring**
    (``PADDLE_TPU_TRACE_RING``, default 8192); overflow evicts the
    oldest and counts ``dropped_total()``, which
    ``resilience.metrics()`` exports as ``trace_spans_dropped_total``,
    so a truncated timeline is visible.
  * **Near-zero cost when disabled** (the default): :func:`span`
    checks one module flag and returns a shared no-op context manager:
    no allocation, no clock read. Enable with ``PADDLE_TPU_TRACE=1`` or
    :func:`enable`.
  * **Timestamps** are wall-clock anchored monotonic seconds: the
    process pins ``(time.time(), time.monotonic())`` once at import and
    every span time is ``anchor_wall + (mono - anchor_mono)``.
    :func:`probe_clock_offset` measures this process's offset against a
    reference clock through a caller-given request function, and the
    offset is applied at export time.
  * **Export** is the Chrome trace event format (:func:`chrome_trace`):
    one Perfetto-loadable JSON merging any number of per-process
    :func:`dump_dict` blobs.

Spans the port emits: ``exec.step`` (labels ``entry`` "run" or
"run_steps", ``cache`` "hit" or "miss"), under it ``exec.compile`` (the
verifier and the plan on a miss, and on the card the CUDA-graph
capture), ``exec.execute`` and ``exec.writeback``; ``kernel_choice``
(a point span under ``exec.execute`` for each kernel call site's
decision at a compile's first run: labels ``op``, ``shape``, ``dtype``,
``impl``, ``source``, ``predicted_s``, ``measured_s``;
ops/kernel_dispatch.py); ``serve.request`` (``ServingPredictor.run``)
with ``serve.call`` (one bucket's call) under it.
"""
import contextlib
import collections
import json
import os
import random
import threading
import time

__all__ = [
    "enabled", "enable", "disable", "span", "record", "current",
    "new_trace_id", "header", "parse_header", "spans", "clear",
    "dropped_total", "set_service", "service", "dump_dict", "dump",
    "clock_offset", "set_clock_offset", "probe_clock_offset",
    "chrome_trace", "now", "RING_CAPACITY",
]

RING_CAPACITY = int(os.environ.get("PADDLE_TPU_TRACE_RING", "8192")
                    or 8192)

# one wall anchor per process: span times are monotonic WITHIN the
# process but live on the wall-clock axis, so same-host processes
# already align and a probed offset handles the rest
_ANCHOR_WALL = time.time()
_ANCHOR_MONO = time.monotonic()

_state = {
    "enabled": os.environ.get("PADDLE_TPU_TRACE", "") not in ("", "0"),
    "service": os.environ.get("PADDLE_TPU_TRACE_SERVICE") or None,
    "service_env": bool(os.environ.get("PADDLE_TPU_TRACE_SERVICE")),
    "clock_offset": 0.0,
    "dropped": 0,
}
_ring = collections.deque(maxlen=RING_CAPACITY)
_lock = threading.Lock()
_tls = threading.local()
# ids from the process-seeded global RNG would correlate across forked
# workers; a dedicated SystemRandom never collides
_rng = random.SystemRandom()


def now():
    """The engine's timebase: wall-anchored monotonic seconds. Use for
    retroactive :func:`record` timestamps so they live on the same
    axis as context-manager spans."""
    return _ANCHOR_WALL + (time.monotonic() - _ANCHOR_MONO)


def enabled():
    return _state["enabled"]


def enable(service=None):
    """Turn the spans engine on (idempotent). ``service`` names this
    process in merged timelines (falls back to ``pid<pid>``)."""
    if service is not None:
        set_service(service)
    _state["enabled"] = True


def disable():
    _state["enabled"] = False


def set_service(name, force=True):
    """Name this process for merged timelines. ``force=False`` keeps
    an operator-provided PADDLE_TPU_TRACE_SERVICE (or an earlier
    explicit set), so a component can name itself without overriding
    the deployment's name."""
    if not force and (_state["service_env"]
                      or _state["service"] is not None):
        return
    _state["service"] = str(name)


def service():
    return _state["service"] or ("pid%d" % os.getpid())


def new_trace_id():
    return "%016x" % _rng.getrandbits(64)


def _new_span_id():
    return "%08x" % _rng.getrandbits(32)


def current():
    """(trace_id, span_id) of this thread's innermost open span, or
    ``None`` — what child spans and outgoing headers parent under."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack[-1]


def header(ctx=None):
    """The ``x-trace-id`` header value for the current (or given)
    context: ``"<trace>:<span>"``; None when there is nothing open."""
    ctx = ctx if ctx is not None else current()
    if not ctx:
        return None
    return "%s:%s" % ctx


def parse_header(value):
    """Parse an ``x-trace-id`` header into ``(trace_id,
    parent_span_id)``; ``(None, None)`` for absent/malformed values —
    a bad header degrades to an un-traced request, never a 500."""
    if not value or not isinstance(value, str):
        return None, None
    parts = value.strip().split(":")
    if len(parts) != 2 or not parts[0]:
        return None, None
    return parts[0], (parts[1] or None)


def _push(trace, span_id):
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append((trace, span_id))


def _pop():
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def _commit(entry):
    with _lock:
        if len(_ring) == _ring.maxlen:
            _state["dropped"] += 1
        _ring.append(entry)


class _Span(object):
    """An OPEN span (context manager). ``set(**labels)`` annotates it
    mid-flight (outcome labels land just before close)."""

    __slots__ = ("trace", "id", "parent", "name", "t0", "labels")

    def __init__(self, name, trace, parent, labels):
        self.name = name
        self.trace = trace
        self.id = _new_span_id()
        self.parent = parent
        self.labels = labels
        self.t0 = now()

    def set(self, **labels):
        self.labels.update(labels)
        return self

    def __enter__(self):
        _push(self.trace, self.id)
        return self

    def __exit__(self, exc_type, exc, tb):
        _pop()
        if exc_type is not None and "error" not in self.labels:
            self.labels["error"] = exc_type.__name__
        _commit({"trace": self.trace, "id": self.id,
                 "parent": self.parent, "name": self.name,
                 "t0": self.t0, "t1": now(), "labels": self.labels,
                 "tid": threading.current_thread().name})
        return False


class _Noop(object):
    """The disabled path: one shared instance, no allocation."""

    __slots__ = ()
    trace = id = parent = None

    def set(self, **labels):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name, trace_id=None, parent=None, **labels):
    """Open a span as a context manager.

    With no explicit ``trace_id`` the span joins the thread's current
    trace (starting a fresh one at the root); ``parent`` defaults to
    the innermost open span. Explicit ``trace_id``/``parent`` attach
    to REMOTE context (:func:`parse_header`). A no-op (shared
    singleton, no clock read) while the engine is disabled."""
    if not _state["enabled"]:
        return _NOOP
    if trace_id is None:
        cur = current()
        if cur is not None:
            trace_id = cur[0]
            if parent is None:
                parent = cur[1]
        else:
            trace_id = new_trace_id()
    return _Span(name, trace_id, parent, labels)


def record(name, t0, t1, trace_id=None, parent=None, **labels):
    """Record an ALREADY-FINISHED span retroactively (timestamps from
    :func:`now`), e.g. a queue wait known only after the batch cut,
    without holding an open span per queued request. Joins the thread's current trace when no explicit
    ``trace_id`` is given (same defaulting as :func:`span`). Returns
    the span id (None while disabled)."""
    if not _state["enabled"]:
        return None
    if trace_id is None:
        cur = current()
        if cur is not None:
            trace_id = cur[0]
            if parent is None:
                parent = cur[1]
    sid = _new_span_id()
    _commit({"trace": trace_id or new_trace_id(), "id": sid,
             "parent": parent, "name": name, "t0": float(t0),
             "t1": float(t1), "labels": labels,
             "tid": threading.current_thread().name})
    return sid


def spans(trace_id=None, name=None):
    """Snapshot of the ring (optionally filtered)."""
    with _lock:
        out = list(_ring)
    if trace_id is not None:
        out = [s for s in out if s["trace"] == trace_id]
    if name is not None:
        out = [s for s in out if s["name"] == name]
    return out


def dropped_total():
    with _lock:
        return _state["dropped"]


def clear():
    with _lock:
        _ring.clear()
        _state["dropped"] = 0


# ---------------------------------------------------------------------------
# cross-process clock alignment
# ---------------------------------------------------------------------------

def clock_offset():
    return _state["clock_offset"]


def set_clock_offset(seconds):
    _state["clock_offset"] = float(seconds)


def probe_clock_offset(call, samples=5):
    """Estimate this process's clock offset against a reference clock
    and install it (applied to every exported timestamp).

    ``call(cmd)`` is a request function returning the reference's
    response dict for ``cmd = "time"``: ``{"wall": <its time.time()>}``
    (the JAX package's CoordServer ``time`` op answers so). The
    NTP-style midpoint estimate, keeping the minimum-RTT sample (least
    queueing noise): ``offset = server_wall - (t0+t1)/2``."""
    best = None
    for _ in range(max(1, int(samples))):
        t0 = now()
        resp = call("time")
        t1 = now()
        off = float(resp["wall"]) - (t0 + t1) / 2.0
        rtt = t1 - t0
        if best is None or rtt < best[0]:
            best = (rtt, off)
    set_clock_offset(best[1])
    return best[1]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def dump_dict():
    """This process's span dump, the blob :func:`chrome_trace` merges.
    Timestamps stay raw; the recorded ``clock_offset_s`` is applied by
    the merge, so re-probing never double-shifts."""
    return {"format": "paddle_tpu_trace", "version": 1,
            "service": service(), "pid": os.getpid(),
            "clock_offset_s": clock_offset(),
            "dropped": dropped_total(), "spans": spans()}


def dump(path):
    """Write :func:`dump_dict` to ``path`` (one JSON object)."""
    with open(path, "w") as f:
        json.dump(dump_dict(), f)
    return path


def chrome_trace(dumps=None):
    """Merge per-process span dumps into ONE Chrome-trace-event JSON
    (``{"traceEvents": [...]}``, Perfetto / chrome://tracing
    loadable). ``dumps`` is a list of :func:`dump_dict`-shaped blobs
    (default: this process's own). Every span becomes a complete
    ("X") event carrying its trace/span/parent ids in ``args`` so the
    cross-process parentage survives into the viewer; process and
    thread metadata events name the lanes."""
    if dumps is None:
        dumps = [dump_dict()]
    events = []
    for d in dumps:
        pid = int(d.get("pid") or 0)
        off = float(d.get("clock_offset_s") or 0.0)
        svc = d.get("service") or ("pid%d" % pid)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": svc}})
        tids = {}
        for s in d.get("spans", ()):
            tname = s.get("tid") or "main"
            tid = tids.get(tname)
            if tid is None:
                tid = tids[tname] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": tname}})
            args = dict(s.get("labels") or {})
            args.update({"trace_id": s["trace"], "span_id": s["id"],
                         "parent_id": s.get("parent"),
                         "service": svc})
            events.append({
                "ph": "X", "cat": "paddle_tpu", "name": s["name"],
                "pid": pid, "tid": tid,
                "ts": round((s["t0"] + off) * 1e6, 3),
                "dur": round(max(0.0, s["t1"] - s["t0"]) * 1e6, 3),
                "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
