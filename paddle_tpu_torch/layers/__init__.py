"""paddle_tpu_torch.layers — the fluid.layers surface the port has so far."""
from .tensor import create_parameter, cast, fill_constant  # noqa: F401
from .ops import *           # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .io import data  # noqa: F401
from .attention import *     # noqa: F401,F403
from .loss import *          # noqa: F401,F403
from .metric_op import *     # noqa: F401,F403
