"""Module-path alias for fluid.dygraph_grad_clip (counterpart of
paddle_tpu/dygraph_grad_clip.py; ref
python/paddle/fluid/dygraph_grad_clip.py)."""
from .dygraph.grad_clip import *  # noqa: F401,F403
from .dygraph import grad_clip as _gc

__all__ = list(getattr(_gc, "__all__", []))
