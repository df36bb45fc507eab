"""Module-path alias for fluid.unique_name (ref
python/paddle/fluid/unique_name.py); implementation lives in
framework/unique_name.py."""
from .framework.unique_name import *  # noqa: F401,F403
from .framework import unique_name as _un

__all__ = list(getattr(_un, "__all__", []))
