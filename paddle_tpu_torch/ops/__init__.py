"""Op kernels of the port; importing this package registers them."""
from . import registry  # noqa: F401
from . import (attention_ops, math_ops, nn_ops, random_ops,  # noqa: F401
               tensor_ops)
