"""Contrib layers (counterpart of paddle_tpu/contrib/layers/):
``basic_gru`` and ``basic_lstm`` so far."""
from .rnn_impl import *  # noqa: F401,F403

from . import rnn_impl

__all__ = list(rnn_impl.__all__)
