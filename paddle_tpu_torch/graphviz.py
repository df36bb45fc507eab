"""Module-path alias for fluid.graphviz (ref
python/paddle/fluid/graphviz.py): DOT rendering lives in debugger.py."""
from .debugger import draw_block_graphviz, draw_program  # noqa: F401

__all__ = ["draw_block_graphviz", "draw_program"]
