"""Module-path alias for fluid.input (counterpart of paddle_tpu/input.py;
ref python/paddle/fluid/input.py: one_hot + embedding at the package
level)."""
from .layers.nn import embedding, one_hot  # noqa: F401

__all__ = ["one_hot", "embedding"]
