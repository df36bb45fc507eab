"""Downpour node descriptors (counterpart of paddle_tpu/distributed/
node.py; ref fluid/distributed/node.py): server and worker table configs
for the pserver binary, which the port does not have. The classes raise
with the alternative named, so a ported config fails at the right
line."""

__all__ = ["DownpourServer", "DownpourWorker"]

_GUIDANCE = (
    "Downpour server and worker table configs target the reference's "
    "pserver binary; in paddle_tpu_torch use layers.embedding(..., "
    "is_distributed=True) tables")


class DownpourServer(object):
    def __init__(self):
        raise NotImplementedError(_GUIDANCE)


class DownpourWorker(object):
    def __init__(self, window=1):
        raise NotImplementedError(_GUIDANCE)
