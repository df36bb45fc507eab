"""Module-path alias for fluid.inferencer (ref
python/paddle/fluid/inferencer.py)."""
from .contrib.inferencer import Inferencer  # noqa: F401

__all__ = ["Inferencer"]
