"""Module-path alias for fluid.executor (ref
python/paddle/fluid/executor.py)."""
from .framework.executor import Executor  # noqa: F401
from .framework.scope import global_scope, scope_guard, Scope  # noqa: F401

__all__ = ["Executor", "global_scope", "scope_guard"]
