"""Contrib layers (counterpart of paddle_tpu/contrib/layers/):
``contrib.layers.nn``'s eight functions, ``basic_gru``, ``basic_lstm``
and ``ctr_metric_bundle``."""
from .nn import *  # noqa: F401,F403
from .rnn_impl import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403

from . import nn
from . import rnn_impl
from . import metric_op

__all__ = list(nn.__all__) + list(rnn_impl.__all__) + list(metric_op.__all__)
