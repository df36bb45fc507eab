"""Startup/readiness probe for a serving artifact — orchestrator glue
(counterpart of the JAX package's tools/serving_probe.py).

Loads the exported artifact under DIR in THIS process (on CUDAPlace(0);
``--cpu`` serves an artifact exported on the CPU), optionally
warms every exported bucket, optionally fires one synthetic
zero-request at the smallest bucket, and prints the resulting
``ServingPredictor.health()`` as JSON. It validates the artifact and
the deserialize->compile->execute path end to end — a broken or
unloadable artifact exits 2 before a replica is ever routed traffic.
Because it is a fresh predictor, the counters reflect the PROBE's own
requests, not a live replica's history: to rotate on accumulated
degradation, run the probe requests with ``--strict --deadline-s`` so
a miss/degrade DURING the probe fails it, or export the live
replica's own ``health()`` via your serving endpoint.

Usage:
  python -m paddle_tpu_torch.tools.serving_probe DIR [--warmup]
      [--no-request] [--deadline-s S] [--strict] [--metrics-url URL]
      [--cpu]

``--metrics-url`` additionally scrapes a metrics endpoint in the
Prometheus text exposition that ``resilience.metrics_text`` writes (any
URL ``urllib`` opens, ``file://`` included: the port has no
``serve_metrics`` server yet) and folds the event totals into the
report under ``"metrics"`` — per-host labels included — so one
probe answers both "is the replica loadable" and "what has the
resilience layer been seeing". An unreachable/unparsable endpoint sets
``metrics_error`` and fails a ``--strict`` probe.

Exit codes:
  0  ready — every exported bucket warm, not saturated (with
     ``--strict``: additionally status == "ok", i.e. the probe request
     itself saw no deadline miss / degraded serve / error, and the
     --metrics-url scrape, when requested, succeeded)
  1  loaded but NOT ready (cold buckets / saturated; strict: degraded)
  2  artifact broken or unreadable — replace the replica
"""
import argparse
import json
import sys


def probe(dirname, warmup=False, request=True, deadline_s=None,
          place=None):
    """Load + exercise the artifact on ``place`` (CUDAPlace(0) unless
    CPUPlace() is passed); returns the health() snapshot."""
    import numpy as np
    from paddle_tpu_torch.serving import load_serving_artifact
    pred = load_serving_artifact(dirname, deadline_s=deadline_s,
                                 place=place)
    if warmup:
        pred.warmup()
    if request:
        # one synthetic request at the smallest bucket: proves the
        # deserialize->compile->execute path end to end (and warms that
        # bucket as a side effect)
        bucket = sorted(pred._fns)[0]
        spec = pred._meta["buckets"][str(bucket)]["feeds"]
        feeds = {f["name"]: np.zeros(f["shape"],
                                     dtype=np.dtype(f["dtype"]))
                 for f in spec}
        from paddle_tpu_torch.framework import resilience
        try:
            pred.run(feeds)
        except resilience.DeadlineExceededError:
            # already counted in the predictor's stats: a slow-but-
            # loadable artifact is the cold/degraded exit-1 path, not
            # the broken exit-2 one
            pass
    return pred.health()


def scrape_metrics(url, timeout_s=5.0):
    """Scrape a metrics endpoint (``resilience.metrics_text``'s
    exposition); returns a summary dict {"url", "samples",
    "events_total": {kind[/host]: n}} plus, where the scrape holds them,
    an "obs" section with the tracing layer's series (the
    ``executor_step_seconds{kind=}`` step-phase histogram samples and
    ``trace_spans_dropped_total``: nonzero means the span ring
    overflowed and any merged timeline is missing spans), a "bytes"
    section with the raw-vs-wire pairs (``<channel>_bytes_total{kind=}``,
    e.g. the checkpoint's), and a "faults" section with the fault-plane
    series (failpoint_hits_total{site=}, the faultinject_armed gauge and
    numeric_fault_total{policy=,culprit=}); ``--strict`` fails the probe
    when the armed gauge is nonzero, because live failpoint schedules
    in a production replica mean requests will be failed on purpose.
    A "buddy" section folds the buddy-checkpoint tier's series (the
    snapshot raw/wire pair, restore outcomes, the per-host generation
    and mailbox residency gauges, the delta ratio and the fetch ms);
    ``--strict`` fails the probe when the hosts' generations spread
    over more than one window or the coordinator holds payload-sized
    bytes (:func:`buddy_generation_flags`, :func:`buddy_resident_flags`).
    Raises on an unreachable or unparsable endpoint (the caller folds
    that into the health report). The JAX tool also folds the series
    of the pod transport, the serving fleet and elastic pipelines,
    which the port does not emit yet."""
    import urllib.request
    from paddle_tpu_torch.framework.resilience import (METRIC_PREFIX,
                                                       parse_metrics_text)
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        text = resp.read().decode("utf-8")
    samples = parse_metrics_text(text)
    events, bytes_sec, obs_sec, faults, buddy = {}, {}, {}, {}, {}
    for name, labels, value in samples:
        key = name[len(METRIC_PREFIX) + 1:]
        if name.startswith(METRIC_PREFIX + "_buddy_"):
            # claimed before the generic *_bytes_total fold, so that the
            # snapshot byte pair stays with its tier
            for label in ("kind", "outcome"):
                if label in labels:
                    key += "/" + labels[label]
            if "host" in labels:
                key += "/host" + labels["host"]
            buddy[key] = value
        elif name.startswith(METRIC_PREFIX + "_failpoint_") \
                or name.startswith(METRIC_PREFIX + "_faultinject_") \
                or name.startswith(METRIC_PREFIX + "_numeric_fault_"):
            if "site" in labels:
                key += "/site:" + labels["site"]
            if "policy" in labels:
                key += "/" + labels["policy"]
            if "culprit" in labels:
                key += "/" + labels["culprit"]
            faults[key] = value
        elif name == METRIC_PREFIX + "_events_total":
            key = labels.get("kind", "?")
            if "host" in labels:
                key += "/host" + labels["host"]
            events[key] = value
        elif name.startswith(METRIC_PREFIX + "_executor_step_seconds") \
                or name.startswith(METRIC_PREFIX + "_trace_spans"):
            if "kind" in labels:
                key += "/" + labels["kind"]
            if "le" in labels:
                key += "/le" + labels["le"]
            obs_sec[key] = value
        elif name.startswith(METRIC_PREFIX) \
                and name.endswith("_bytes_total"):
            bytes_sec[key + "/" + labels.get("kind", "?")] = value
    out = {"url": url, "samples": len(samples), "events_total": events}
    for section, folded in (("obs", obs_sec), ("bytes", bytes_sec),
                            ("faults", faults), ("buddy", buddy)):
        if folded:
            out[section] = folded
    return out


def obs_overflow_flags(summary):
    """Span-ring overflow symptoms in a scrape summary (empty =
    healthy): a nonzero ``trace_spans_dropped_total`` means the
    tracing ring evicted spans, so any merged timeline pulled from
    this process is LYING by omission — ``--strict`` fails on it
    (raise PADDLE_TPU_TRACE_RING or pull /admin/trace more often)."""
    dropped = summary.get("obs", {}).get("trace_spans_dropped_total", 0)
    if dropped:
        return ["span ring overflowed: trace_spans_dropped_total=%g — "
                "merged timelines are missing spans" % dropped]
    return []


def buddy_generation_flags(summary):
    """Buddy-mailbox lag in a scrape summary (empty = healthy): hosts may
    straddle one window boundary, but ``buddy_generation`` gauges that
    spread over more than one window mean some host's snapshots are not
    landing, and its next loss rewinds to disk (``buddy_stale``).
    ``--strict`` fails the probe on it."""
    gens = {k: v for k, v in summary.get("buddy", {}).items()
            if k.startswith("buddy_generation/")}
    if gens and max(gens.values()) - min(gens.values()) > 1:
        return ["buddy generation gauges diverge by more than one "
                "window (a stale mailbox rewinds to disk on the next "
                "host loss): %s" % sorted(gens.items())]
    return []


#: --strict ceiling for the coordinator's buddy_resident_bytes gauge: the
#: p2p tier keeps payloads in peer mailboxes and only a metadata table on
#: the coordinator, well under 64 KiB for a large pod
BUDDY_COORD_RESIDENT_BOUND = 64 * 1024


def buddy_resident_flags(summary, bound=BUDDY_COORD_RESIDENT_BOUND):
    """Coordinator memory-ceiling regression in a scrape summary (empty =
    healthy): ``buddy_resident_bytes{host="coord"}`` above ``bound``
    means snapshot payloads are parked on the coordination plane.
    ``--strict`` fails the probe on it."""
    resident = summary.get("buddy", {}).get(
        "buddy_resident_bytes/hostcoord")
    if resident is not None and resident > bound:
        return ["coordinator buddy residency is payload-sized: "
                "buddy_resident_bytes{host=coord}=%g exceeds the "
                "%d-byte metadata bound — snapshot payloads are "
                "parked on the coordination plane" % (resident, bound)]
    return []


def fault_plane_flags(summary):
    """Fault-plane poison in a scrape summary (empty = healthy): a
    nonzero ``faultinject_armed`` gauge means live failpoint schedules
    are armed in the scraped process — chaos-drill instrumentation
    that has NO business in a production replica (the next matching
    request will be failed on purpose). Fired-hit counters alone are
    only reported, not fatal: a drill that was since disarmed leaves
    its counters behind. ``--strict`` fails the probe on armed."""
    armed = summary.get("faults", {}).get("faultinject_armed", 0)
    if armed:
        return ["failpoints armed in the scraped process "
                "(faultinject_armed=%g): disarm the fault plane before "
                "serving production traffic" % armed]
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirname", help="artifact dir (holds serving/)")
    ap.add_argument("--warmup", action="store_true",
                    help="compile every exported bucket before reporting")
    ap.add_argument("--no-request", dest="request", action="store_false",
                    help="skip the synthetic probe request")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="deadline for the probe request (seconds)")
    ap.add_argument("--strict", action="store_true",
                    help="also require status == 'ok': a deadline miss, "
                         "degraded serve or error during the probe "
                         "itself fails it — and, with --metrics-url, "
                         "span-ring overflow (trace_spans_dropped_total "
                         "> 0) in the obs series, armed failpoints "
                         "(faultinject_armed > 0) in the faults series, "
                         "buddy generations more than one window apart "
                         "or payload-sized coordinator residency in the "
                         "buddy series")
    ap.add_argument("--metrics-url", default=None,
                    help="scrape a metrics endpoint (resilience."
                         "metrics_text's exposition; file:// works) and "
                         "fold the event totals into the report")
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (an artifact exported there); "
                         "the default is CUDAPlace(0)")
    args = ap.parse_args(argv)
    try:
        from paddle_tpu_torch.framework.place import CPUPlace
        health = probe(args.dirname, warmup=args.warmup,
                       request=args.request, deadline_s=args.deadline_s,
                       place=CPUPlace() if args.cpu else None)
    except Exception as e:
        print(json.dumps({"live": False, "ready": False,
                          "status": "broken",
                          "error": "%s: %s" % (type(e).__name__, e)}))
        return 2
    metrics_ok = True
    if args.metrics_url:
        try:
            health["metrics"] = scrape_metrics(args.metrics_url)
            for field, flags in (
                    ("obs_overflow", obs_overflow_flags),
                    ("faults_armed", fault_plane_flags),
                    ("buddy_lag", buddy_generation_flags),
                    ("buddy_resident", buddy_resident_flags)):
                # dropped spans mean the timeline is lying; armed
                # failpoints mean requests WILL be failed on purpose:
                # loud always, fatal under --strict
                found = flags(health["metrics"])
                if found:
                    health[field] = found
                    metrics_ok = False
        except Exception as e:
            # a loadable replica with a dead metrics endpoint is still
            # serviceable — degrade to exit 1 only under --strict
            health["metrics_error"] = str(e)
            metrics_ok = False
    print(json.dumps(health))
    ok = health["ready"] and (not args.strict or
                              (health["status"] == "ok" and metrics_ok))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
