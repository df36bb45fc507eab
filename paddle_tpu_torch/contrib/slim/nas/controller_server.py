"""NAS controller server (counterpart of paddle_tpu/contrib/slim/nas/
controller_server.py; reference slim/nas/controller_server.py): a tiny
TCP service wrapping an EvolutionaryController so distributed search
agents can request next-tokens / report rewards over the network."""
import json
import socket
import threading

__all__ = ["ControllerServer"]


class ControllerServer(object):
    """Serve a controller (e.g. searcher.controller.SAController).

    Protocol: one JSON line per request —
      {"cmd": "next_tokens"} -> {"tokens": [...]}
      {"cmd": "update", "tokens": [...], "reward": r} -> {"ok": true}
    """

    def __init__(self, controller, address=("", 0), max_client_num=100,
                 search_steps=None, key=None):
        self._controller = controller
        self._address = address
        self._max_client_num = max_client_num
        self._search_steps = search_steps
        self._sock = None
        self._thread = None
        self._closed = threading.Event()

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._address)
        self._sock.listen(self._max_client_num)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self.ip(), self.port()

    def ip(self):
        host = self._sock.getsockname()[0]
        if host in ("", "0.0.0.0", "::"):
            # wildcard binds are unreachable from other hosts — hand
            # agents this machine's routable address instead
            host = socket.gethostbyname(socket.gethostname())
        return host

    def port(self):
        return self._sock.getsockname()[1]

    def close(self):
        self._closed.set()
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass

    def _serve(self):
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                # one dead/half-open client must not stall or kill the
                # serve loop for every other agent
                try:
                    conn.settimeout(30)
                    req = json.loads(conn.makefile("r").readline())
                    resp = self._handle(req)
                    conn.sendall((json.dumps(resp) + "\n").encode())
                except Exception:      # malformed request / client gone
                    try:
                        conn.sendall(b'{"error": "bad request"}\n')
                    except OSError:
                        pass

    def _handle(self, req):
        cmd = req.get("cmd")
        if cmd == "next_tokens":
            return {"tokens": list(self._controller.next_tokens())}
        if cmd == "update":
            self._controller.update(req["tokens"], float(req["reward"]))
            return {"ok": True}
        return {"error": "unknown cmd %r" % (cmd,)}
