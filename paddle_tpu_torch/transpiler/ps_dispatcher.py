"""Parameter-server shard dispatchers (counterpart of paddle_tpu/
transpiler/ps_dispatcher.py; ref python/paddle/fluid/transpiler/
ps_dispatcher.py).

The reference decides with them which pserver endpoint owns each
parameter shard. The same policy question exists for a mesh (which row
owns which row-shard of a distributed embedding), and fluid scripts
construct these classes directly.
"""

__all__ = ["PSDispatcher", "HashName", "RoundRobin"]


class PSDispatcher(object):
    """Base: dispatch a list of vars onto endpoints (ref :18)."""

    def __init__(self, pserver_endpoints):
        self._eps = pserver_endpoints
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError("Interface has not been implemented.")


class HashName(PSDispatcher):
    """Hash each var's name onto an endpoint (ref :49) — deterministic
    across restarts, the property checkpoints rely on."""

    def __init__(self, pserver_endpoints):
        super(HashName, self).__init__(pserver_endpoints)

    def _hash_block(self, block_str, total):
        return hash(block_str) % total

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server_id = self._hash_block(var.name(), len(self._eps))
            eplist.append(self._eps[server_id])
        return eplist


class RoundRobin(PSDispatcher):
    """Cycle through endpoints in order (ref :88)."""

    def __init__(self, pserver_endpoints):
        super(RoundRobin, self).__init__(pserver_endpoints)

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            server_for_param = self._eps[self._step]
            eplist.append(server_for_param)
            self._step += 1
            if self._step >= len(self._eps):
                self._step = 0
        return eplist
