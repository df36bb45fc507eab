"""fluid.incubate.fleet.parameter_server (counterpart of paddle_tpu/
incubate/fleet/parameter_server/): the port has no pserver process;
``pslib`` raises with guidance. Its ``distribute_transpiler`` path comes
with the collective fleet (the torch.distributed slice)."""
from . import pslib  # noqa: F401
