"""contrib (counterpart of paddle_tpu/contrib/): the multi-layer RNN
compositions of ``contrib.layers`` and the seq2seq decoders of
``contrib.decoder``."""
from . import decoder  # noqa: F401
from . import layers  # noqa: F401
