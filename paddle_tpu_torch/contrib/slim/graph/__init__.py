"""slim.graph (counterpart of paddle_tpu/contrib/slim/graph/): program
introspection for the slim passes."""
from .graph_wrapper import GraphWrapper, VarWrapper, OpWrapper  # noqa: F401
from .executor import SlimGraphExecutor  # noqa: F401

__all__ = ["GraphWrapper", "VarWrapper", "OpWrapper", "SlimGraphExecutor"]
