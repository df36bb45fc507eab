"""fluid.net_drawer (counterpart of paddle_tpu/net_drawer.py; ref
python/paddle/fluid/net_drawer.py): renders the main program's graph
through the debugger's DOT writer."""
from .debugger import draw_block_graphviz  # noqa: F401
from .debugger import draw_program as _draw_program

__all__ = ["draw_graph"]


def draw_graph(startup_program, main_program, **kwargs):
    """Reference signature (net_drawer.py:103): draws the main program;
    the graph_path or filename kwarg names the output DOT file."""
    path = kwargs.get("graph_path") or kwargs.get("filename")
    return _draw_program(main_program, path=path)
