"""fluid.dygraph.dygraph_utils (counterpart of
paddle_tpu/dygraph/dygraph_utils.py; internal helpers)."""
__all__ = ["_append_activation_in_dygraph", "_append_bias_in_dygraph"]


def _append_activation_in_dygraph(input, act=None, use_cudnn=None):
    if act is None:
        return input
    from .. import layers
    return getattr(layers, act)(input)


def _append_bias_in_dygraph(input, bias=None, axis=1):
    if bias is None:
        return input
    from ..layers import elementwise_add
    return elementwise_add(input, bias, axis=axis)
