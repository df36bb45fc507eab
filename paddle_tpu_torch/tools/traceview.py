"""Merge per-process span dumps into one Perfetto timeline (counterpart
of the JAX package's tools/traceview.py).

Each process's spans (framework/obs.py) are written by ``obs.dump(path)``
or pulled live from a serving-fleet member's ``GET /admin/trace``
(router or replica, ``--from``); this tool merges any number of them
into one Chrome-trace-event JSON (``obs.chrome_trace``) that
chrome://tracing and https://ui.perfetto.dev load: each process on its
own named track, every event carrying its trace, span and parent ids in
``args``, so one client request reads as one tree across the router and
the replica that served it.

Usage:
  python -m paddle_tpu_torch.tools.traceview -o trace.json dump1.json ...
  python -m paddle_tpu_torch.tools.traceview -o trace.json \
      --from URL[,URL...] [files]
  python -m paddle_tpu_torch.tools.traceview --stdout dump1.json

``--from`` takes fleet-member base URLs (``http://h:p`` or ``h:p``).

Exit code 1 when any input failed to load (the merge of the rest is
still written); 2 when no spans were collected at all.
"""
import argparse
import json
import sys


def pull_live(url, timeout_s=5.0):
    """Fetch one live member's span dump from GET /admin/trace."""
    import urllib.request
    base = url if "://" in url else "http://" + url
    with urllib.request.urlopen(base.rstrip("/") + "/admin/trace",
                                timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def load_dump(path):
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict) or "spans" not in d:
        raise ValueError("%s is not an obs span dump "
                         "(expected a dict with a 'spans' list)" % path)
    return d


def merge(dumps):
    """Merged Chrome trace dict from a list of dump blobs."""
    from paddle_tpu_torch.framework import obs
    return obs.chrome_trace(list(dumps))


def summarize(dumps):
    """One line a process, then the traces with the most spans."""
    lines = []
    traces = {}
    for d in dumps:
        spans = d.get("spans", [])
        lines.append("  %-16s pid=%-7s spans=%-5d dropped=%s"
                     % (d.get("service"), d.get("pid"), len(spans),
                        d.get("dropped", 0)))
        for s in spans:
            traces[s["trace"]] = traces.get(s["trace"], 0) + 1
    multi = sorted(traces.items(), key=lambda kv: -kv[1])[:5]
    if multi:
        lines.append("  top traces: " + ", ".join(
            "%s (%d spans)" % kv for kv in multi))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dumps", nargs="*",
                    help="span dump files (obs.dump / /admin/trace "
                         "JSON)")
    ap.add_argument("--from", dest="live", default=None,
                    help="comma-joined fleet member base URLs to pull "
                         "/admin/trace from live")
    ap.add_argument("-o", "--out", default=None,
                    help="output Chrome trace JSON path")
    ap.add_argument("--stdout", action="store_true",
                    help="write the merged trace to stdout instead")
    args = ap.parse_args(argv)
    if not args.out and not args.stdout:
        ap.error("need -o OUT or --stdout")
    blobs, failed = [], 0
    for path in args.dumps:
        try:
            blobs.append(load_dump(path))
        except (OSError, ValueError) as e:
            print("skipping %s: %s" % (path, e), file=sys.stderr)
            failed += 1
    for url in (args.live.split(",") if args.live else []):
        url = url.strip()
        if not url:
            continue
        try:
            blobs.append(pull_live(url))
        except Exception as e:  # noqa: BLE001 - reported, not fatal
            print("live pull %s failed: %s" % (url, e),
                  file=sys.stderr)
            failed += 1
    total = sum(len(b.get("spans", [])) for b in blobs)
    if total == 0:
        print("no spans collected (is PADDLE_TPU_TRACE=1 set?)",
              file=sys.stderr)
        return 2
    trace = merge(blobs)
    print("merged %d spans from %d process dump(s):\n%s"
          % (total, len(blobs), summarize(blobs)), file=sys.stderr)
    out = json.dumps(trace)
    if args.stdout:
        print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print("wrote %s (load it at https://ui.perfetto.dev or "
              "chrome://tracing)" % args.out, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
