"""PaddlePS process-instance helper (counterpart of paddle_tpu/
distributed/ps_instance.py; ref fluid/distributed/ps_instance.py): rank
bookkeeping for pserver and trainer roles. The port's jobs have one
role (every process runs the same program), so the instance gives the
torch.distributed rank and world size (0 and 1 without a process
group)."""
from .helper import _group_rank_size

__all__ = ["PaddlePSInstance"]


class PaddlePSInstance(object):
    def __init__(self, server_worker_mode=1, proc_per_node=1):
        self._rank, self._nodes = _group_rank_size()

    def get_worker_index(self):
        return self._rank

    def get_node_cnt(self):
        return self._nodes

    def is_worker(self):
        return True           # every process is a worker

    def is_server(self):
        return False          # no pserver tier

    def is_first_worker(self):
        return self._rank == 0

    def barrier_all(self):
        if self._nodes > 1:
            import torch.distributed as dist
            dist.barrier()
