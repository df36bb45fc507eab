"""contrib (counterpart of paddle_tpu/contrib/): the multi-layer RNN
compositions of ``contrib.layers`` so far."""
from . import layers  # noqa: F401
