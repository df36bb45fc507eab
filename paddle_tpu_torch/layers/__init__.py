"""paddle_tpu_torch.layers — the fluid.layers surface the port has so far."""
from .tensor import (create_parameter, cast, concat,  # noqa: F401
                     sums, assign, fill_constant, ones_like,
                     fill_constant_batch_size_like, argmax)
from .ops import *           # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .io import data  # noqa: F401
from .attention import *     # noqa: F401,F403
from .loss import *          # noqa: F401,F403
from .metric_op import *     # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .rnn import *           # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .vision import *        # noqa: F401,F403
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup)
