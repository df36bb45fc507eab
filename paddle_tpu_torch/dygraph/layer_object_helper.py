"""fluid.dygraph.layer_object_helper (counterpart of
paddle_tpu/dygraph/layer_object_helper.py): one LayerHelper serves both
modes."""
from ..layer_helper import LayerHelper as LayerObjectHelper  # noqa: F401

__all__ = ["LayerObjectHelper"]
