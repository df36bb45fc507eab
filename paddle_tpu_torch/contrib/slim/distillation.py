"""Module-path alias for slim.distillation (counterpart of
paddle_tpu/contrib/slim/distillation.py); the losses live in
distill.py."""
from .distill import *  # noqa: F401,F403
from . import distill as _d

__all__ = list(getattr(_d, "__all__", []))
