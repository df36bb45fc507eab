"""Module-path alias for fluid.layer_helper_base (counterpart of
paddle_tpu/layer_helper_base.py): one LayerHelper serves the port."""
from .layer_helper import LayerHelper as LayerHelperBase  # noqa: F401

__all__ = ["LayerHelperBase"]
