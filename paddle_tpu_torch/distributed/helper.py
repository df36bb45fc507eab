"""MPI helper surface (counterpart of paddle_tpu/distributed/helper.py;
ref fluid/distributed/helper.py). The reference wrapped mpi4py for
pserver jobs; the port's processes meet through torch.distributed, so
the helper answers from its process group when one is initialised, and
as the only process (rank 0 of 1) otherwise."""
import socket

__all__ = ["MPIHelper"]


def _group_rank_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class MPIHelper(object):
    def get_rank(self):
        return _group_rank_size()[0]

    def get_size(self):
        return _group_rank_size()[1]

    def get_ip(self):
        return socket.gethostbyname(socket.gethostname())

    def get_hostname(self):
        return socket.gethostname()
