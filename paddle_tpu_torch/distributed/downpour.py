"""Downpour-SGD surface (counterpart of paddle_tpu/distributed/
downpour.py; ref fluid/distributed/downpour.py).

The reference's DownpourSGD configured Baidu's asynchronous
parameter-server tables. The port has no pserver tier: large sparse
tables are embeddings (``is_distributed=True`` marks them for
row-sharding over a mesh, which arrives with the torch.distributed
slice) updated synchronously. The class is kept so a ported config
fails at the right line with the alternative named.
"""

__all__ = ["DownpourSGD"]

_GUIDANCE = (
    "DownpourSGD configures the reference's asynchronous pserver "
    "tables, which paddle_tpu_torch does not have; use layers.embedding"
    "(..., is_distributed=True) and a lazy-mode Adam or SGD from "
    "paddle_tpu_torch.optimizer: synchronous data parallelism replaces "
    "async push and pull")


class DownpourSGD(object):
    def __init__(self, learning_rate=0.001, window=1):
        raise NotImplementedError(_GUIDANCE)
