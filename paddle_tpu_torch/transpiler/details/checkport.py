"""Port-liveness wait (counterpart of paddle_tpu/transpiler/details/
checkport.py; ref transpiler/details/checkport.py): block until
every "ip:port" endpoint accepts a TCP connection — the reference used
it to gate trainers on pserver startup; here it can gate a job on a
coordinator (tools/coordsvc.py) before its hosts join."""
import socket
import time

__all__ = ["wait_server_ready"]


def wait_server_ready(endpoints, timeout_s=300.0, poll_s=1.0):
    deadline = time.time() + timeout_s
    pending = list(endpoints)
    while pending:
        if time.time() > deadline:
            raise TimeoutError(
                "servers not ready within %.0fs: %s"
                % (timeout_s, ", ".join(pending)))
        nxt = []
        for ep in pending:
            host, _, port = ep.rpartition(":")
            try:
                with socket.create_connection((host, int(port)),
                                              timeout=poll_s):
                    pass
            except OSError:
                nxt.append(ep)
        pending = nxt
        if pending:
            time.sleep(poll_s)
