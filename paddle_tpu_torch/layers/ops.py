"""Activation layers (counterpart of paddle_tpu/layers/ops.py): one
layer per unary op of the activation table, the attr-taking ones with
the JAX package's attr names and defaults, ``pow``, and the random
layers ``uniform_random``, ``gaussian_random`` and ``sampling_id``."""
import sys

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softplus",
    "softsign", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin",
    "acos", "asin", "atan", "round", "reciprocal", "square", "relu",
    "gelu", "erf", "sign", "log", "log1p", "expm1", "silu", "mish",
]


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


def _attr_unary(op_type, attr_names_defaults):
    """A layer whose positional or keyword arguments after ``x`` fill the
    op's attrs, in ``attr_names_defaults`` order."""
    def layer(x, *args, **kwargs):
        attrs = {}
        for (aname, default), val in zip(
                attr_names_defaults,
                list(args) + [None] * len(attr_names_defaults)):
            v = kwargs.get(aname, val)
            attrs[aname] = default if v is None else v
        helper = LayerHelper(op_type, name=kwargs.get("name"))
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


_ATTR_OPS = {
    "relu6": [("threshold", 6.0)],
    "leaky_relu": [("alpha", 0.02)],
    "elu": [("alpha", 1.0)],
    "swish": [("beta", 1.0)],
    "hard_sigmoid": [("slope", 0.2), ("offset", 0.5)],
    "hard_swish": [("threshold", 6.0), ("scale", 6.0), ("offset", 3.0)],
    "hard_shrink": [("threshold", 0.5)],
    "softshrink": [("lambda", 0.5)],
    "thresholded_relu": [("threshold", 1.0)],
    "brelu": [("t_min", 0.0), ("t_max", 24.0)],
    "soft_relu": [("threshold", 40.0)],
    "stanh": [("scale_a", 0.67), ("scale_b", 1.7159)],
    "selu": [("scale", 1.0507009873554805), ("alpha", 1.6732632423543772)],
}

for _op, _attrs in _ATTR_OPS.items():
    setattr(_mod, _op, _attr_unary(_op, _attrs))


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("pow", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"factor": factor})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("uniform_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("gaussian_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sampling_id", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"seed": seed})
    out.stop_gradient = True
    return out



__all__ = list(_UNARY_OPS) + list(_ATTR_OPS) + ["pow", "uniform_random",
                                                 "gaussian_random",
                                                 "sampling_id"]
