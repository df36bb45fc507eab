"""Standalone pod rendezvous service — orchestrator glue (counterpart
of the JAX package's tools/coordsvc.py, with its flags).

Runs a :class:`paddle_tpu_torch.framework.transport.CoordServer`: the
stdlib-TCP service holding the pod's coordination KV state (gather
rounds with sticky completion, tombstones, join announcements,
heartbeats). Deploy ONE per pod — as a sidecar on host 0, a k8s
Service, or anywhere every host can reach over TCP — and point each
host's ``SocketCoordinator(address, n_hosts, host_id)`` at it. No
shared filesystem is needed anywhere.

Liveness: with ``--hb-deadline-s`` armed (the default), any host whose
heartbeat goes stale past the deadline is tombstoned by the server's
monitor — survivors observe the tombstone on their next heartbeat or
gather poll and fire their loss hooks (mesh re-init), and the fenced
host must rejoin through the admission protocol, never resume.

High availability — the service holds no MODEL state, but it does hold
the coordination state (in-flight rounds, tombstones). Three grades of
protection, composable:

  * a dropped CONNECTION (network blip, proxy restart) is fully
    transparent: clients reconnect/retry through their RetryPolicy
    (~5-10s budget by default) and re-send idempotently;
  * ``--snapshot-path`` persists periodic state snapshots and reloads
    them on start, so a SUPERVISED RESTART of a solo service resumes
    in-flight rounds instead of aborting them (liveness leases are
    refreshed on load — restart grace);
  * ``--peers`` wires this member into a TERM-replicated group: one
    primary plus warm standbys. The primary streams every mutating op
    to the standbys; on primary loss (judged by the same
    ``--hb-deadline-s`` staleness bound) the lowest-index live standby
    promotes with a bumped term, clients fail over inside their retry
    budget (pass every member's address to SocketCoordinator:
    "h:p0,h:p1"), and a stale ex-primary is fenced by term — rejected
    by clients AND demoted by its peers' replication stream.

Run each member under a supervisor either way.

It holds no tensors and takes no place.

Usage:
  python -m paddle_tpu_torch.tools.coordsvc --n-hosts N|auto [--port P]
      [--host ADDR] [--hb-deadline-s S] [--snapshot-path F]
      [--snapshot-every-s S] [--peers a:p0,a:p1,... --repl-index I
      [--standby]]
  python -m paddle_tpu_torch.tools.coordsvc --status ADDR[,ADDR...]

``--peers`` is the ordered endpoint list of the WHOLE group (own entry
included); ``--repl-index`` is this member's position in it — the
index order is the promotion priority. Boot exactly one member without
``--standby`` (the initial primary); a RESTARTED ex-primary relaunched
with its original flags probes its peers first and demotes itself to
standby when it finds a higher-term incumbent, so the same command
line is safe across the whole lifecycle.

``--status`` prints one JSON line per probed member (role, term,
stream position, replication lag) and exits 0 when a primary answered,
2 otherwise — the operator/orchestrator health probe.

``--n-hosts auto`` starts the service without a fixed pod size: the
size is learned from the FIRST hello that carries one (every
SocketCoordinator/CoordClient hello does) and is fixed for the
service's lifetime — later hellos must agree. This is how elastic
group sizes (e.g. the serving fleet) avoid templating N into two
places; until that first hello, every other op answers a loud
"pod size not learned yet" error.

Prints one JSON line ``{"address": "host:port", "n_hosts": N, ...}``
once listening (orchestrators parse it to template the worker env;
``n_hosts`` is null in auto mode), then serves until SIGTERM/SIGINT.
"""
import argparse
import json
import signal
import socket
import sys
import threading


def probe_status(addresses):
    """--status: probe each member; returns (exit_code, reports)."""
    from paddle_tpu_torch.framework.transport import _probe_status
    reports = []
    saw_primary = False
    for addr in addresses:
        st = _probe_status(addr, timeout_s=2.0)
        if st is None:
            reports.append({"address": addr, "reachable": False})
            continue
        st["reachable"] = True
        st.setdefault("address", addr)
        saw_primary = saw_primary or st.get("role") == "primary"
        reports.append(st)
    return (0 if saw_primary else 2), reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-hosts",
                    help="pod size (host ids 0..N-1), or 'auto' to "
                         "learn it from the first hello")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on stdout)")
    ap.add_argument("--host", default="0.0.0.0",
                    help="bind address (default: all interfaces)")
    ap.add_argument("--advertise-host", default=None,
                    help="hostname/IP printed in the address workers "
                         "dial (default: the bind address, or this "
                         "machine's hostname when binding 0.0.0.0 — "
                         "a wildcard bind address is not dialable)")
    ap.add_argument("--hb-deadline-s", type=float, default=10.0,
                    help="heartbeat staleness deadline; a host silent "
                         "past it is tombstoned, and a standby judges "
                         "the primary dead by the same bound (<= 0 "
                         "disables the monitor AND auto-promotion)")
    ap.add_argument("--snapshot-path", default=None,
                    help="persist periodic state snapshots here and "
                         "reload on start — a supervised restart "
                         "resumes in-flight rounds instead of "
                         "aborting them")
    ap.add_argument("--snapshot-every-s", type=float, default=5.0,
                    help="snapshot cadence (with --snapshot-path)")
    ap.add_argument("--peers", default=None,
                    help="ordered comma-joined endpoint list of the "
                         "WHOLE replication group (own entry "
                         "included); index order = promotion priority")
    ap.add_argument("--repl-index", type=int, default=0,
                    help="this member's position in --peers")
    ap.add_argument("--standby", action="store_true",
                    help="boot in standby role (wait for the "
                         "primary's replication stream)")
    ap.add_argument("--repl-sync-timeout-s", type=float, default=2.0,
                    help="bound on waiting for standby acks before "
                         "answering a round-mutating op (a dead "
                         "standby is dropped from the wait set)")
    ap.add_argument("--status", default=None, metavar="ADDR[,ADDR...]",
                    help="probe the given member(s) and print one "
                         "JSON status line each; exit 0 iff a "
                         "primary answered")
    args = ap.parse_args(argv)
    if args.status:
        code, reports = probe_status(
            [a.strip() for a in args.status.split(",") if a.strip()])
        for r in reports:
            print(json.dumps(r), flush=True)
        return code
    if args.n_hosts is None:
        ap.error("--n-hosts is required (or use --status)")
    if args.n_hosts == "auto":
        n_hosts = None
    else:
        try:
            n_hosts = int(args.n_hosts)
        except ValueError:
            ap.error("--n-hosts must be an integer or 'auto', got %r"
                     % args.n_hosts)
    from paddle_tpu_torch.framework.transport import CoordServer
    hb = args.hb_deadline_s if args.hb_deadline_s > 0 else None
    server = CoordServer(n_hosts, port=args.port, host=args.host,
                         hb_deadline_s=hb,
                         snapshot_path=args.snapshot_path,
                         snapshot_every_s=args.snapshot_every_s)
    if args.peers:
        peers = [p.strip() for p in args.peers.split(",") if p.strip()]
        if not 0 <= args.repl_index < len(peers):
            ap.error("--repl-index %d out of range for %d peers"
                     % (args.repl_index, len(peers)))
        server.configure_replication(
            args.repl_index, peers, standby=args.standby,
            sync_timeout_s=args.repl_sync_timeout_s)
    server.start()
    # the printed address is what orchestrators template into every
    # worker's SocketCoordinator — it must be DIALABLE from remote
    # hosts, and a wildcard bind address is not
    bind_host, port = server.address.rsplit(":", 1)
    adv = args.advertise_host
    if adv is None:
        adv = socket.gethostname() \
            if bind_host in ("0.0.0.0", "::", "") else bind_host
    print(json.dumps({"address": "%s:%s" % (adv, port),
                      "bind": server.address,
                      "n_hosts": n_hosts,
                      "hb_deadline_s": hb,
                      "role": server.state.role,
                      "term": server.state.term,
                      "repl_index": args.repl_index if args.peers
                      else None,
                      "snapshot_path": args.snapshot_path}),
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
