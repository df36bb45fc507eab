"""Module-path alias for slim.quantization (counterpart of
paddle_tpu/contrib/slim/quantization.py); the passes live in qat.py."""
from .qat import *  # noqa: F401,F403
from . import qat as _q

__all__ = list(getattr(_q, "__all__", []))
