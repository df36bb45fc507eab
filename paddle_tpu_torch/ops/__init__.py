"""Op kernels of the port; importing this package registers them."""
from . import registry  # noqa: F401
from . import (attention_ops, control_flow_ops, math_ops,  # noqa: F401
               metric_ops, nn_ops, optimizer_ops, random_ops, tensor_ops)
