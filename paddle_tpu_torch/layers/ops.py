"""Activation layers (counterpart of paddle_tpu/layers/ops.py) for the
activation ops the port registers, and ``pow``."""
import sys

from ..layer_helper import LayerHelper

_UNARY_OPS = ["exp", "tanh", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos",
              "sin", "round", "reciprocal", "square", "gelu", "sign", "log"]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]})
        return out
    layer.__name__ = op_type
    return layer


_mod = sys.modules[__name__]
for _op in _UNARY_OPS:
    setattr(_mod, _op, _make_unary(_op))


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("pow", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"factor": factor})
    return out


__all__ = list(_UNARY_OPS) + ["pow"]
