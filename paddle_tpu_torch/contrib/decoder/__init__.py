"""Contrib seq2seq decoders (counterpart of paddle_tpu/contrib/decoder/;
ref python/paddle/fluid/contrib/decoder/__init__.py)."""
from .beam_search_decoder import *  # noqa: F401,F403
from . import beam_search_decoder

__all__ = beam_search_decoder.__all__
