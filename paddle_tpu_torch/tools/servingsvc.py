"""Serving-fleet daemons — orchestrator glue for
paddle_tpu_torch.serving_fleet (counterpart of the JAX package's
tools/servingsvc.py, with its subcommands and flags).

Three subcommands, one process each:

  replica   one ServingPredictor replica: loads the exported artifact
            on the CUDA device (``--place cpu`` serves an artifact
            exported on the CPU; with no CUDA device and no
            ``--place cpu`` it fails, never falling back), serves
            POST /infer over HTTP, and registers as a
            heartbeat-leased member of the fleet's coordination group
            (paddle_tpu_torch.tools.coordsvc — run it with
            --hb-deadline-s armed;
            --n-hosts auto learns the group size from the first
            member). A RESTARTED replica finds itself fenced and
            re-admits through announce/admit/join automatically — just
            re-run the same command line. A replica SPAWNED by the
            autoscaler (a grown slot above the router range) passes
            --group-size with the post-resize size.
            --artifact-compress q8 requires the artifact's weights in
            the int8 block codec (export with weight_compress='q8')
            and refuses a full-precision export at load — the ship-
            bytes savings are asserted, never assumed.
            --metrics-port P also serves this process's live metrics
            exposition (resilience.serve_metrics) on P.

  router    the fleet's front door — now a replicated TIER: run R of
            these (--router-id 0..R-1 --n-routers R), each serving
            /infer independently (clients take the whole endpoint
            list — `servingsvc.py client`, or FleetClient in code).
            Admission is enacted only by the term-stamped admission
            LEADER (lowest live router id); continuous micro-batching,
            least-loaded dispatch over fleet-wide shared in-flight
            counts, shed on a full queue, retry a dead replica's
            in-flight work on a sibling. POST /admin/deploy
            {"dir": ...} rolls a weight refresh across the fleet one
            replica at a time with zero dropped traffic.
            --autoscale arms the leader-gated replica autoscaler:
            queue-depth/shed-rate surges grow the fleet through the
            coordinator's dynamic `resize` op, and --spawn-template
            (placeholders {replica_id} {group_size} {coord}) is the
            command launched for each grown replica; a sustained idle
            window drains + removes grown replicas again. Spawned
            processes are SUPERVISED by this router process (announced
            as {"kind": "autoscale_spawn", "pid": ...} lines, reaped
            on shutdown) — production orchestrators should instead
            watch the fleet_autoscale events and actuate themselves.
            --tenant-classes arms multi-tenant QoS: per-tenant queues
            drained by weighted-fair queueing, token-bucket/in-flight
            quotas, and priority-classed brownout shedding under
            overload (serving_fleet.TenantClass); requests
            carry x-tenant / x-deadline-ms / x-retry-budget headers.
            The router holds no tensors and takes no place.

  client    stdin/stdout failover client for a multi-router
            deployment: --routers URL[,URL...] (both tiers take
            endpoint LISTS — --coord for the coordination group,
            --routers for the router tier). Reads one JSON request per
            line ({"feeds": {name: rows}[, "deadline_s": S]}), rotates
            on connection error/5xx and replays idempotently by
            request token, writes one JSON line per result.

Each daemon prints ONE JSON line with its address once serving
(orchestrators parse it), then runs until SIGTERM/SIGINT.

Distributed tracing: launch any daemon with ``PADDLE_TPU_TRACE=1``
and it records obs spans (router queue/dispatch, replica serve,
coordination waits) with trace context propagated via the
``x-trace-id`` header; pull each process's spans from
``GET /admin/trace`` and merge them with
``python -m paddle_tpu_torch.tools.traceview --from URL ...`` into one
Perfetto timeline.

``--coord`` accepts a comma-joined endpoint LIST when the coordination
plane is a replicated coordsvc group (``--peers`` mode): members fail
over to the promoted standby transparently, so a coordinator SIGKILL
mid-deploy costs the fleet nothing.

Usage (``SVC`` is ``python -m paddle_tpu_torch.tools.servingsvc``):
  SVC replica --coord HOST:PORT[,HOST:PORT...]
         --n-replicas N --replica-id I --artifact DIR [--port P]
         [--n-routers R] [--group-size G] [--no-warmup]
         [--max-in-flight M] [--deadline-s S] [--place cuda|cpu]
         [--metrics-port P]
  SVC router --coord HOST:PORT[,HOST:PORT...]
         --n-replicas N [--router-id I --n-routers R] [--port P]
         [--max-batch B] [--batch-deadline-s S] [--max-queue Q]
         [--request-deadline-s S] [--autoscale
          --spawn-template 'SVC replica
          --coord {coord} --n-replicas N --n-routers R
          --replica-id {replica_id} --group-size {group_size}
          --artifact DIR' [--autoscale-max M] ...]
  SVC client --routers URL[,URL...]
         [--deadline-s S]
"""
import argparse
import json
import signal
import sys
import threading


def _serve_until_signal(member, line, cleanup=None):
    print(json.dumps(line), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if cleanup is not None:
        cleanup()
    member.close()
    return 0


def _template_spawner(template, coord):
    """Build the autoscaler's spawner from a command template with
    {replica_id}/{group_size}/{coord} placeholders. Spawned processes
    are tracked by replica id so ``spawn.stop`` (the autoscaler's
    stopper) can reap a drained, resized-away replica — without it a
    shrink leaves the process's HTTP listener and heartbeat thread
    running until router shutdown — and announced as one JSON line
    each so orchestrators/tests can adopt them."""
    import shlex
    import subprocess
    procs = []
    by_id = {}

    def spawn(replica_id, group_size):
        cmd = [a.format(replica_id=replica_id, group_size=group_size,
                        coord=coord) for a in shlex.split(template)]
        p = subprocess.Popen(cmd)
        procs.append(p)
        by_id[int(replica_id)] = p
        print(json.dumps({"kind": "autoscale_spawn", "pid": p.pid,
                          "replica_id": replica_id,
                          "group_size": group_size}), flush=True)
        return p

    def stop(replica_id):
        p = by_id.pop(int(replica_id), None)
        if p is None or p.poll() is not None:
            return
        p.terminate()
        try:
            p.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        print(json.dumps({"kind": "autoscale_stop", "pid": p.pid,
                          "replica_id": replica_id}), flush=True)

    spawn.procs = procs
    spawn.stop = stop
    return spawn


def _client_main(args):
    from paddle_tpu_torch.serving_fleet import FleetClient
    client = FleetClient(args.routers,
                         request_deadline_s=args.deadline_s,
                         tenant=args.tenant,
                         retry_budget=args.retry_budget)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            out = client.infer(req["feeds"],
                               deadline_s=req.get("deadline_s"))
            out = dict(out, ok=True)
        except Exception as e:   # noqa: BLE001 - reported on the wire
            out = {"ok": False, "error": str(e),
                   "kind": type(e).__name__}
        print(json.dumps(out), flush=True)
    return 0


def _load_tenant_classes(spec):
    """--tenant-classes value -> config dict (inline JSON, or a JSON
    file via '@path'). Validation happens in parse_tenant_classes at
    router construction."""
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return json.load(f)
    return json.loads(spec)


def _replica_main(args):
    from paddle_tpu_torch.framework import resilience
    from paddle_tpu_torch.framework.place import CPUPlace, CUDAPlace
    from paddle_tpu_torch.serving_fleet import ReplicaMember
    place = CPUPlace() if args.place == "cpu" else CUDAPlace(0)
    member = ReplicaMember(
        args.artifact, args.coord, args.n_replicas,
        args.replica_id, port=args.port, host=args.host,
        warmup=args.warmup, max_in_flight=args.max_in_flight,
        deadline_s=args.deadline_s,
        ctl_interval_s=args.ctl_interval_s,
        hb_interval_s=args.hb_interval_s,
        join_timeout_s=args.join_timeout_s,
        n_routers=args.n_routers,
        group_size=args.group_size,
        artifact_compress=args.artifact_compress,
        place=place).start()
    line = {"kind": "replica", "replica_id": args.replica_id,
            "addr": member.address, "generation": member.generation}
    server = None
    if args.metrics_port is not None:
        server = resilience.serve_metrics(port=args.metrics_port,
                                          host=args.host)
        line["metrics_url"] = server.url
    return _serve_until_signal(
        member, line,
        cleanup=server.close if server is not None else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("replica", help="one serving replica")
    rp.add_argument("--coord", required=True,
                    help="coordsvc address (host:port), or a comma-"
                         "joined endpoint list for a replicated "
                         "coordsvc group (failover is transparent)")
    rp.add_argument("--n-replicas", type=int, required=True)
    rp.add_argument("--replica-id", type=int, required=True)
    rp.add_argument("--artifact", required=True,
                    help="artifact dir (holds serving/)")
    rp.add_argument("--port", type=int, default=0)
    rp.add_argument("--host", default="127.0.0.1")
    rp.add_argument("--n-routers", type=int, default=1,
                    help="router-tier size (group = replicas + "
                         "routers [+ grown slots])")
    rp.add_argument("--group-size", type=int, default=None,
                    help="the group's CURRENT total size — required "
                         "for a replica spawned into a GROWN slot "
                         "(id above the router range)")
    rp.add_argument("--no-warmup", dest="warmup", action="store_false")
    rp.add_argument("--max-in-flight", type=int, default=None)
    rp.add_argument("--deadline-s", type=float, default=None)
    rp.add_argument("--ctl-interval-s", type=float, default=0.1)
    rp.add_argument("--hb-interval-s", type=float, default=0.25)
    rp.add_argument("--join-timeout-s", type=float, default=30.0)
    rp.add_argument("--artifact-compress", default=None,
                    choices=("q8",),
                    help="require the artifact's weights in this "
                         "compressed form (q8 = the int8 block codec;"
                         " export with weight_compress='q8') — a "
                         "full-precision artifact is refused at load")
    rp.add_argument("--place", default="cuda", choices=("cuda", "cpu"),
                    help="device that serves the artifact (default the "
                         "CUDA device 0; it must match the device the "
                         "artifact was exported on)")
    rp.add_argument("--metrics-port", type=int, default=None,
                    help="also serve this process's /metrics exposition "
                         "on this port (0 = ephemeral, printed)")

    ro = sub.add_parser("router", help="one fleet router (run "
                        "--n-routers of these for the HA tier)")
    ro.add_argument("--coord", required=True)
    ro.add_argument("--n-replicas", type=int, required=True)
    ro.add_argument("--router-id", type=int, default=0)
    ro.add_argument("--n-routers", type=int, default=1)
    ro.add_argument("--group-size", type=int, default=None)
    ro.add_argument("--port", type=int, default=0)
    ro.add_argument("--host", default="127.0.0.1")
    ro.add_argument("--max-batch", type=int, default=8)
    ro.add_argument("--batch-deadline-s", type=float, default=0.005)
    ro.add_argument("--max-queue", type=int, default=128)
    ro.add_argument("--request-deadline-s", type=float, default=10.0)
    ro.add_argument("--ctl-interval-s", type=float, default=0.1)
    ro.add_argument("--hb-interval-s", type=float, default=0.25)
    ro.add_argument("--join-timeout-s", type=float, default=30.0)
    ro.add_argument("--autoscale", action="store_true",
                    help="arm the leader-gated replica autoscaler")
    ro.add_argument("--spawn-template", default=None,
                    help="command template for grown replicas; "
                         "placeholders {replica_id} {group_size} "
                         "{coord}")
    ro.add_argument("--autoscale-min", type=int, default=None)
    ro.add_argument("--autoscale-max", type=int, default=None)
    ro.add_argument("--autoscale-interval-s", type=float, default=0.25)
    ro.add_argument("--autoscale-window", type=int, default=8)
    ro.add_argument("--autoscale-queue-depth", type=float, default=4.0)
    ro.add_argument("--autoscale-shed-rate", type=float, default=0.05)
    ro.add_argument("--autoscale-hysteresis", type=int, default=3)
    ro.add_argument("--autoscale-cooldown-s", type=float, default=5.0)
    ro.add_argument("--autoscale-high-queue-depth", type=float,
                    default=None,
                    help="grow when the HIGHEST-priority class queues"
                         " this deep (default: half the global "
                         "threshold) — needs --tenant-classes")
    ro.add_argument("--tenant-classes", default=None,
                    help="tenant QoS classes as JSON ('@file' reads a"
                         " file): {name: {weight, priority, rate, "
                         "burst, max_inflight, tenants}}; absent = "
                         "the classic single-FIFO router")
    ro.add_argument("--brownout-queue-depth", type=float, default=None,
                    help="queue depth that counts as a hot brownout "
                         "sample (default 0.75 * max-queue)")
    ro.add_argument("--brownout-shed-rate", type=float, default=0.5,
                    help="shed-rate delta that counts as a hot "
                         "brownout sample")
    ro.add_argument("--qos-interval-s", type=float, default=0.1,
                    help="brownout controller sampling interval")
    ro.add_argument("--qos-hysteresis", type=int, default=3,
                    help="consecutive hot/cool samples before the "
                         "brownout floor moves one class level")

    cl = sub.add_parser("client", help="stdin/stdout failover client")
    cl.add_argument("--routers", required=True,
                    help="comma-joined router endpoint list (URLs or "
                         "host:port)")
    cl.add_argument("--deadline-s", type=float, default=10.0)
    cl.add_argument("--tenant", default=None,
                    help="QoS identity sent as x-tenant on every "
                         "request (absent = the 'default' tenant)")
    cl.add_argument("--retry-budget", type=int, default=None,
                    help="max replica attempts a request may burn "
                         "across hops (x-retry-budget; absent = "
                         "retry until the deadline)")

    args = ap.parse_args(argv)
    if args.cmd == "client":
        return _client_main(args)
    if args.cmd == "replica":
        return _replica_main(args)
    from paddle_tpu_torch.serving_fleet import Autoscaler, FleetRouter
    router = FleetRouter(
        args.coord, args.n_replicas, port=args.port, host=args.host,
        max_batch=args.max_batch,
        batch_deadline_s=args.batch_deadline_s,
        max_queue=args.max_queue,
        request_deadline_s=args.request_deadline_s,
        ctl_interval_s=args.ctl_interval_s,
        hb_interval_s=args.hb_interval_s,
        join_timeout_s=args.join_timeout_s,
        router_id=args.router_id, n_routers=args.n_routers,
        group_size=args.group_size,
        tenant_classes=_load_tenant_classes(args.tenant_classes),
        brownout_queue_depth=args.brownout_queue_depth,
        brownout_shed_rate=args.brownout_shed_rate,
        qos_interval_s=args.qos_interval_s,
        qos_hysteresis=args.qos_hysteresis).start()
    auto, spawner = None, None
    if args.autoscale:
        if args.spawn_template:
            spawner = _template_spawner(args.spawn_template, args.coord)
        auto = Autoscaler(
            router, spawner=spawner,
            stopper=spawner.stop if spawner is not None else None,
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            interval_s=args.autoscale_interval_s,
            window=args.autoscale_window,
            grow_queue_depth=args.autoscale_queue_depth,
            grow_shed_rate=args.autoscale_shed_rate,
            hysteresis=args.autoscale_hysteresis,
            cooldown_s=args.autoscale_cooldown_s,
            grow_high_queue_depth=args.autoscale_high_queue_depth
            ).start()

    def cleanup():
        if auto is not None:
            auto.close()
        for p in (spawner.procs if spawner is not None else ()):
            if p.poll() is None:
                p.terminate()

    return _serve_until_signal(
        router, {"kind": "router", "router_id": args.router_id,
                 "addr": router.address, "url": router.url},
        cleanup=cleanup)


if __name__ == "__main__":
    sys.exit(main())
