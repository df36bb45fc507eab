"""Tensor layers: create_parameter, cast, concat, sums, assign,
fill_constant, fill_constant_batch_size_like, argmax, zeros_like, ones_like
(counterparts in paddle_tpu/layers/tensor.py)."""
import numpy as np

from ..framework.dtypes import normalize_dtype
from ..framework.program import Variable
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    dtype = normalize_dtype(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype, x.shape)
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(i.shape is not None for i in input):
        ax = axis % len(input[0].shape)
        dims = [i.shape[ax] for i in input]
        shape = list(input[0].shape)
        shape[ax] = -1 if any(d == -1 for d in dims) else sum(dims)
    out = helper.create_variable_for_type_inference(input[0].dtype, shape)
    helper.append_op("concat", inputs={"X": [i.name for i in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype,
                                                        input[0].shape)
    helper.append_op("sum", inputs={"X": [i.name for i in input]},
                     outputs={"Out": [out.name]})
    return out


def assign(input, output=None):
    """Copy a Variable (``assign``) or a numpy value (``assign_value``)
    into ``output``."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype,
                                                               input.shape)
        helper.append_op("assign", inputs={"X": [input.name]},
                         outputs={"Out": [output.name]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(arr.dtype), arr.shape)
        helper.append_op("assign_value", outputs={"Out": [output.name]},
                         attrs={"shape": list(arr.shape),
                                "dtype": output.dtype,
                                "values": arr.reshape(-1).tolist()})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op("fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """``shape`` filled with ``value``, its ``output_dim_idx`` dim taken
    from ``input``'s ``input_dim_idx`` dim when the op runs."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(
        "fill_constant_batch_size_like",
        inputs={"Input": [input.name]}, outputs={"Out": [out.name]},
        attrs={"shape": [int(s) for s in shape], "dtype": dtype,
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return out


def argmax(x, axis=0):
    """int64 index of the largest along ``axis`` (the first on a tie)."""
    helper = LayerHelper("argmax")
    shape = None
    if x.shape is not None:
        shape = tuple(s for i, s in enumerate(x.shape)
                      if i != axis % len(x.shape))
    out = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op("arg_max", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    out.stop_gradient = True
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("fill_zeros_like", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("fill_any_like", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"value": 1.0})
    return out
