"""Op kernels of the port; importing this package registers them."""
from . import registry  # noqa: F401
from . import (attention_ops, math_ops, metric_ops, nn_ops,  # noqa: F401
               optimizer_ops, random_ops, tensor_ops)
