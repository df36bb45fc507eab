"""fluid.incubate.fleet (counterpart of paddle_tpu/incubate/fleet/): the
parameter-server stubs (``parameter_server.pslib``). The collective
fleet API (``fleet.init``, ``distributed_optimizer``, the role makers)
arrives with the torch.distributed slice."""
from . import parameter_server  # noqa: F401
