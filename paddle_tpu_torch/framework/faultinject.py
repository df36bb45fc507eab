"""Deterministic process-wide failpoint plane.

Counterpart of paddle_tpu/framework/faultinject.py, with its closed site
catalog (:data:`SITES`) and spec grammar unchanged, so a spec that arms a
site of a later slice still parses. Named failpoint sites are hit
deterministically by ``(site, hit-count, host)`` schedules; the port
hits ``executor.step`` (Executor.run and run_steps, payload = the
feeds), ``io.member_write`` and ``io.manifest_write`` (a checkpoint's
commit), ``buddy.send``, ``buddy.delta_apply`` and ``buddy.restore``
(the buddy tier), ``transport.send`` and ``coordination.hb`` (the socket
plane's client), ``serving.infer`` (a fleet replica's request) and
``serving.dispatch`` (the fleet router's dispatch to a replica).

Usage at a site (the call is the site)::

    from . import faultinject
    feed = faultinject.hit("executor.step", feed)

``hit`` is free when no schedule is armed: one module-global bool test.
When armed it counts the visit per ``(site, host)`` and applies every
matching schedule.

Schedules, programmatic or via ``PADDLE_TPU_FAULTS`` (shared with the
legacy injector of :mod:`resilience`: specs whose point contains a ``.``
belong to this plane)::

    site:action[=arg][@N | @N+ | ~p][^host]

      action   raise[=ExcName[/message]] | delay[=seconds] | drop
               | corrupt=array_name | flip=array_name
      @N       fire only on the N-th visit of (site, host) (1-based)
      @N+      fire on every visit from the N-th on
      ~p       fire each visit with probability p (seeded by
               PADDLE_TPU_FAULT_SEED)
      ^host    fire only when the site's host context equals ``host``

    default (no @/~): fire on every visit.

Actions: ``raise`` the site's catalogued error (or ``=ExcName``);
``delay`` sleeps ``arg`` seconds (default 0.05); ``drop`` returns
:data:`DROP`; ``corrupt`` NaN-poisons one element of the named array of a
dict payload (an integer array saturates); ``flip`` flips one low bit of
one element (wrong but finite). ``corrupt`` and ``flip`` act on numpy
arrays or torch tensors and return a copy of the payload with a copy of
the array: the caller's array is never written.

Counters: :func:`hits_total` returns ``{site: fired_count}``, exported by
``resilience.metrics()`` as ``failpoint_hits_total{site=}`` with a
``faultinject_armed`` gauge.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading

__all__ = [
    "SITES", "DROP", "FailSpec", "FaultInjectedError",
    "hit", "armed", "arm", "disarm", "failpoints",
    "hits_total", "reset_counters", "reload_env", "schedules",
]


class FaultInjectedError(RuntimeError):
    """Default typed error for ``raise`` actions at sites without a
    more specific catalogued error class."""


# ---------------------------------------------------------------------------
# site catalog — the single source of truth (the same catalog as the
# JAX package: a spec naming a site of a later slice still parses)
# ---------------------------------------------------------------------------

# site -> default exception class for the ``raise`` action.  The class
# is chosen so the SITE'S OWN error handling sees the same type a real
# fault would produce: a torn socket is ConnectionError (transport
# retry/failover path), a torn write is OSError (checkpoint scrub
# path), a poisoned step is FloatingPointError (numeric-policy path).
SITES = {
    # coordination transport: one client->server roundtrip is about to
    # put bytes on the wire
    "transport.send": ConnectionError,
    # one liveness heartbeat is about to be sent (drop = miss the beat
    # and let the lease age toward fencing)
    "coordination.hb": ConnectionError,
    # checkpoint shard payload (.npz member) atomic write
    "io.member_write": OSError,
    # checkpoint manifest/latest atomic write — the commit record
    "io.manifest_write": OSError,
    # one executor step about to run; payload = feeds dict, so
    # ``corrupt``/``flip`` can poison a named input array
    "executor.step": FloatingPointError,
    # elastic pp re-cut about to re-target the survivors' mesh (a
    # raise here exercises the half-completed-re-cut window: the pod
    # must fall back to the consensus rewind, never crash or shrink
    # silently)
    "coordination.recut": RuntimeError,
    # router about to dispatch a coalesced micro-batch to a replica
    "serving.dispatch": OSError,
    # replica about to run one /infer body
    "serving.infer": RuntimeError,
    # buddy-checkpoint tier: one window-boundary snapshot is about to
    # be put_blob'd to the buddy host (a raise here must leave the
    # PREVIOUS generation on the coord server, still restorable)
    "buddy.send": ConnectionError,
    # buddy restore about to decode an adopted snapshot (a raise here
    # is a torn snapshot: the pod must fall back to the disk rewind
    # with reason="snapshot_torn", never adopt half-decoded state)
    "buddy.restore": RuntimeError,
    # p2p buddy mailbox: the window snapshot (full or delta) is about
    # to be streamed into the ring buddy's mailbox endpoint (a raise
    # here is a torn stream: the buddy never acks, the coordinator
    # metadata row is NOT advanced, and restore must plan buddy_stale
    # -> disk, never elect the half-written payload)
    "buddy.p2p_send": ConnectionError,
    # p2p restore about to pull the snapshot host-to-host from the
    # buddy's mailbox (a raise here must resolve to the typed
    # snapshot_torn disk fallback, never a hang or a partial adopt)
    "buddy.p2p_fetch": ConnectionError,
    # buddy mailbox about to apply ONE delta link while reconstructing
    # a chained snapshot (a raise here is a broken chain: reconstruct
    # fails typed, the adopter falls back to disk, and the next send
    # is forced full)
    "buddy.delta_apply": RuntimeError,
}

# exception classes a ``raise=ExcName`` arg may name
_ERROR_CLASSES = {
    c.__name__: c
    for c in (ConnectionError, ConnectionResetError, OSError,
              TimeoutError, FloatingPointError, RuntimeError,
              ValueError, FaultInjectedError)
}

# ``drop`` sentinel: distinct from None (the unarmed fast path returns
# the payload verbatim, and most sites pass payload=None)
DROP = object()


class FailSpec(object):
    """One parsed failpoint schedule (see module docstring syntax)."""

    _ACTIONS = ("raise", "delay", "drop", "corrupt", "flip")

    def __init__(self, site, action, arg=None, at=None, at_plus=False,
                 prob=None, host=None):
        if site not in SITES:
            raise ValueError(
                "unknown failpoint site %r (catalog: %s)"
                % (site, ", ".join(sorted(SITES))))
        if action not in self._ACTIONS:
            raise ValueError(
                "unknown failpoint action %r (have %s)"
                % (action, ", ".join(self._ACTIONS)))
        if action in ("corrupt", "flip") and not arg:
            raise ValueError(
                "%s needs the target array name: %s:%s=<array>"
                % (action, site, action))
        self.site, self.action, self.arg = site, action, arg
        self.at, self.at_plus, self.prob = at, at_plus, prob
        self.host = None if host is None else str(host)

    @classmethod
    def parse(cls, text):
        text = text.strip()
        if ":" not in text:
            raise ValueError(
                "failpoint spec %r needs the form "
                "site:action[=arg][@N|@N+|~p][^host]" % text)
        site, rest = text.split(":", 1)
        host = None
        if "^" in rest:
            rest, host = rest.rsplit("^", 1)
        at = prob = arg = None
        at_plus = False
        if "@" in rest:
            rest, n = rest.rsplit("@", 1)
            if n.endswith("+"):
                at_plus, n = True, n[:-1]
            at = int(n)
        elif "~" in rest:
            rest, p = rest.rsplit("~", 1)
            prob = float(p)
        if "=" in rest:
            rest, arg = rest.split("=", 1)
        return cls(site.strip(), rest.strip(), arg=arg, at=at,
                   at_plus=at_plus, prob=prob, host=host)

    def matches(self, visit, host, rng):
        if self.host is not None and (host is None
                                      or str(host) != self.host):
            return False
        if self.prob is not None:
            return rng.random() < self.prob
        if self.at is None:
            return True
        return visit >= self.at if self.at_plus else visit == self.at

    def __repr__(self):
        tail = ""
        if self.arg is not None:
            tail += "=%s" % self.arg
        if self.prob is not None:
            tail += "~%g" % self.prob
        elif self.at is not None:
            tail += "@%d%s" % (self.at, "+" if self.at_plus else "")
        if self.host is not None:
            tail += "^%s" % self.host
        return "FailSpec(%s:%s%s)" % (self.site, self.action, tail)


# ---------------------------------------------------------------------------
# registry state
# ---------------------------------------------------------------------------

# THE fast path: hit() tests this one module global and returns.  Arm /
# disarm are the only writers.  Everything else lives behind _lock.
_armed = False

_lock = threading.Lock()
_specs = []            # armed FailSpecs
_visits = {}           # (site, host_str_or_None) -> visit count
_fired = {}            # site -> number of times any action fired
_rng = random.Random(0)


def _host_tag():
    """Fallback host context: the ``host`` tag from
    resilience.context() (PodResilientTrainer sets it per host
    thread)."""
    from . import resilience
    tags = getattr(resilience._tls, "tags", None)
    return None if not tags else tags.get("host")


def armed():
    """True when any failpoint schedule is live (env or programmatic)."""
    return _armed


def schedules():
    """The armed FailSpecs (a copy — test introspection)."""
    with _lock:
        return list(_specs)


def hits_total():
    """{site: number of times a schedule FIRED an action there}."""
    with _lock:
        return dict(_fired)


def reset_counters():
    with _lock:
        _visits.clear()
        _fired.clear()


def arm(specs, seed=None):
    """Arm failpoint schedules (replacing any armed set).

    ``specs``: a spec string (``;``/``,`` separated), an iterable of
    spec strings/FailSpecs, or empty to disarm.  Returns the parsed
    list.  Prefer the :func:`failpoints` context manager in tests."""
    global _armed
    parsed = _parse_specs(specs)
    with _lock:
        _specs[:] = parsed
        if seed is not None:
            _rng.seed(seed)
        _armed = bool(_specs)
    return parsed


def disarm():
    """Remove every schedule; hit() returns to the no-op fast path."""
    global _armed
    with _lock:
        _specs[:] = []
        _armed = False


def _parse_specs(specs):
    if not specs:
        return []
    if isinstance(specs, str):
        parts = [s for chunk in specs.split(";")
                 for s in chunk.split(",") if s.strip()]
        return [FailSpec.parse(s) for s in parts]
    out = []
    for s in specs:
        out.append(s if isinstance(s, FailSpec) else FailSpec.parse(s))
    return out


@contextlib.contextmanager
def failpoints(specs, seed=0):
    """Context manager: arm ``specs`` for the enclosed block, restore
    the previous armed set (and counters) after."""
    global _armed
    parsed = _parse_specs(specs)
    with _lock:
        old_specs = list(_specs)
        old_armed = _armed
        old_visits, old_fired = dict(_visits), dict(_fired)
        _specs[:] = parsed
        _visits.clear()
        _fired.clear()
        _rng.seed(seed)
        _armed = bool(_specs)
    try:
        yield
    finally:
        with _lock:
            _specs[:] = old_specs
            _visits.clear()
            _visits.update(old_visits)
            _fired.clear()
            _fired.update(old_fired)
            _armed = old_armed


# ---------------------------------------------------------------------------
# env arming (shared PADDLE_TPU_FAULTS with the legacy plane)
# ---------------------------------------------------------------------------

def _env_specs():
    """Dotted-site specs from PADDLE_TPU_FAULTS (legacy bare points are
    the resilience.FaultInjector's share of the var)."""
    raw = os.environ.get("PADDLE_TPU_FAULTS", "")
    if not raw:
        return []
    parts = [s for chunk in raw.split(";")
             for s in chunk.split(",") if s.strip()]
    mine = [s for s in parts if "." in s.strip().split(":", 1)[0]]
    return [FailSpec.parse(s) for s in mine]


def reload_env():
    """Re-read PADDLE_TPU_FAULTS (+ PADDLE_TPU_FAULT_SEED) and arm the
    dotted-site specs found there.  Called at import; call again after
    mutating the env in-process."""
    seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED", "0") or 0)
    return arm(_env_specs(), seed=seed)


# ---------------------------------------------------------------------------
# the hit path
# ---------------------------------------------------------------------------

def hit(site, payload=None, host=None):
    """Failpoint site marker.

    Unarmed (production): returns ``payload`` after one bool test.
    Armed: counts the visit for ``(site, host)`` and applies every
    matching schedule — may raise, sleep, return :data:`DROP`, or
    return a corrupted copy of ``payload``."""
    if not _armed:
        return payload
    return _hit_armed(site, payload, host)


def _hit_armed(site, payload, host):
    if site not in SITES:
        raise ValueError("failpoint hit at uncatalogued site %r "
                         "(catalog: %s)" % (site, sorted(SITES)))
    if host is None:
        host = _host_tag()
    hkey = None if host is None else str(host)
    with _lock:
        n = _visits.get((site, hkey), 0) + 1
        _visits[(site, hkey)] = n
        matched = [s for s in _specs
                   if s.site == site and s.matches(n, hkey, _rng)]
        if matched:
            _fired[site] = _fired.get(site, 0) + len(matched)
    if not matched:
        return payload
    from . import resilience
    dropped = False
    for spec in matched:
        resilience.record_event("failpoint", site=site, action=spec.action,
                                visit=n, **({} if hkey is None
                                            else {"host": hkey}))
        if spec.action == "raise":
            exc_name, _, msg = (spec.arg or "").partition("/")
            exc = SITES[site] if not exc_name \
                else _ERROR_CLASSES.get(exc_name)
            if exc is None:
                raise ValueError("failpoint raise=%r names no known "
                                 "error class (have %s)"
                                 % (exc_name, sorted(_ERROR_CLASSES)))
            raise exc(msg or "failpoint %s fired (visit %d%s)"
                      % (site, n, "" if hkey is None
                         else ", host %s" % hkey))
        if spec.action == "delay":
            import time
            time.sleep(float(spec.arg) if spec.arg else 0.05)
        elif spec.action == "drop":
            dropped = True
        elif spec.action in ("corrupt", "flip"):
            payload = _corrupt(payload, spec.arg, flip=spec.action == "flip")
    return DROP if dropped else payload


def _corrupt_tensor(t, flip):
    """A poisoned copy of torch tensor ``t`` (see _corrupt)."""
    import torch
    out = t.detach().clone()
    flat = out.view(-1)
    if flip:
        if out.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                out.element_size()]
            flat[:1].view(bits).bitwise_xor_(1)
        elif not out.is_complex() and out.dtype != torch.bool:
            flat[:1].bitwise_xor_(1)
    elif out.is_floating_point():
        flat[0] = float("nan")
    elif out.is_complex():
        flat[0] = complex(float("nan"), float("nan"))
    elif out.dtype == torch.bool:
        flat[0] = True
    else:       # integer tensors can't hold NaN; saturate instead
        flat[0] = torch.iinfo(out.dtype).max
    return out


def _corrupt(payload, name, flip=False):
    """Return a copy of dict ``payload`` with one element of array
    ``name`` NaN-poisoned (or one low bit flipped), the other arrays
    shared. A payload that is not a dict, or has no such array, passes
    through untouched: a mis-aimed schedule must not crash the site."""
    import numpy as np
    if not isinstance(payload, dict) or name not in payload:
        return payload
    val = payload[name]
    if getattr(val, "numel", None) is not None and \
            type(val).__module__.startswith("torch"):
        if val.numel() == 0:
            return payload
        out = dict(payload)
        out[name] = _corrupt_tensor(val, flip)
        return out
    arr = np.array(val, copy=True)
    if arr.size == 0:
        return payload
    flat = arr.reshape(-1)
    if flip:
        if arr.dtype.kind in "fc":
            # flip one mantissa bit of element 0: silently wrong but
            # still finite, the SDC shape no finite mask can see
            as_int = flat[:1].view({2: np.uint16, 4: np.uint32,
                                    8: np.uint64}[arr.dtype.itemsize])
            as_int[...] = as_int ^ 1
        elif arr.dtype.kind in "iu":
            flat[0] = flat[0] ^ 1
    else:
        if arr.dtype.kind == "f":
            flat[0] = np.nan
        elif arr.dtype.kind == "c":
            flat[0] = complex(np.nan, np.nan)
        else:   # integer arrays can't hold NaN; saturate instead
            flat[0] = np.iinfo(arr.dtype).max
    out = dict(payload)
    out[name] = arr
    return out


# arm from the environment at import: a process launched with
# PADDLE_TPU_FAULTS set is armed before any site is hit, with no env
# read per hit afterwards.
reload_env()
