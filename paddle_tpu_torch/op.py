"""Module-path alias for fluid.op (ref python/paddle/fluid/op.py):
operator construction is Program IR here."""
from .framework.program import Operator  # noqa: F401

__all__ = ["Operator"]
