"""NAS search agent (counterpart of paddle_tpu/contrib/slim/nas/
search_agent.py; reference slim/nas/search_agent.py): the client side of
ControllerServer — ask for tokens, report rewards."""
import json
import socket

__all__ = ["SearchAgent"]


class SearchAgent(object):
    def __init__(self, server_ip, server_port, key=None):
        self._server_ip = server_ip or "127.0.0.1"
        self._server_port = int(server_port)

    def _request(self, payload):
        with socket.create_connection(
                (self._server_ip, self._server_port), timeout=60) as s:
            s.sendall((json.dumps(payload) + "\n").encode())
            resp = json.loads(s.makefile("r").readline())
        if "error" in resp:
            raise RuntimeError("controller server: %s" % resp["error"])
        return resp

    def next_tokens(self):
        return self._request({"cmd": "next_tokens"})["tokens"]

    def update(self, tokens, reward):
        return self._request({"cmd": "update", "tokens": list(tokens),
                              "reward": float(reward)})