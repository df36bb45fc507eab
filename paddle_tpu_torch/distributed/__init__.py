"""Distributed runtime (counterpart of paddle_tpu/distributed/): on one
card, the device mesh's host bookkeeping that the pod coordinators call
on every host loss and rejoin (:mod:`.mesh`). Meshes over more than one
device, the fleet API, pipelines and sequence parallelism arrive with
the torch.distributed slice."""
from .mesh import (DistributedStrategy, get_mesh, init_mesh,  # noqa: F401
                   mesh_axes)
