"""Tensor layers (counterparts in paddle_tpu/layers/tensor.py, the whole
file since the op library's slice). As there, ``range`` shadows the
builtin in this module."""
import numpy as np

from ..framework import unique_name
from ..framework.dtypes import normalize_dtype
from ..framework.program import Variable
from ..initializer import ConstantInitializer
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


def reverse(x, axis):
    """``x`` flipped along ``axis`` (an int or a list)."""
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    axis = [axis] if isinstance(axis, int) else list(axis)
    helper.append_op("flip", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """A tensor array (``layers.create_array``'s build-time list) stacked
    or concatenated into one tensor, and each entry's size along ``axis``
    as an int32 vector."""
    from .nn import stack
    entries = [v for v in input if v is not None]
    if not entries:
        raise ValueError("tensor_array_to_tensor: empty array")
    if use_stack:
        out = stack(entries, axis=axis)
        sizes = [1] * len(entries)
    else:
        out = concat(entries, axis=axis)
        sizes = [int(v.shape[axis]) for v in entries]
    return out, assign(np.asarray(sizes, np.int32))


# ---- the op library's layers (paddle_tpu/layers/tensor.py) ----

def _argminmax_shape(x, axis):
    if x.shape is None:
        return None
    nd = len(x.shape)
    return tuple(s for i, s in enumerate(x.shape) if i != axis % nd)


def argmin(x, axis=0):
    helper = LayerHelper("argmin")
    out = helper.create_variable_for_type_inference(
        "int64", _argminmax_shape(x, axis))
    helper.append_op("arg_min", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    out.stop_gradient = True
    return out


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    ids = helper.create_variable_for_type_inference("int64", input.shape)
    helper.append_op("argsort", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis, "descending": descending})
    ids.stop_gradient = True
    return out, ids


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name or unique_name.generate("global_var"))
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op("diag", inputs={"Diagonal": [diagonal.name]},
                     outputs={"Out": [out.name]})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    num_columns = num_columns or num_rows
    out = helper.create_variable_for_type_inference(
        dtype, (num_rows, num_columns))
    helper.append_op("eye", outputs={"Out": [out.name]},
                     attrs={"num_rows": num_rows, "num_columns": num_columns,
                            "dtype": dtype})
    return out


def has_inf(x):
    helper = LayerHelper("isinf")
    out = helper.create_variable_for_type_inference("bool", (1,))
    helper.append_op("isinf", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def has_nan(x):
    helper = LayerHelper("isnan")
    out = helper.create_variable_for_type_inference("bool", (1,))
    helper.append_op("isnan", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool", (1,))
    helper.append_op("isfinite", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    if not isinstance(start, Variable):
        start = fill_constant([1], dtype, start)
    if not isinstance(stop, Variable):
        stop = fill_constant([1], dtype, stop)
    if not isinstance(num, Variable):
        num = fill_constant([1], "int32", num)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("linspace", inputs={"Start": [start.name],
                                         "Stop": [stop.name],
                                         "Num": [num.name]},
                     outputs={"Out": [out.name]})
    return out


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    if not isinstance(start, Variable):
        start = fill_constant([1], dtype, start)
    if not isinstance(end, Variable):
        end = fill_constant([1], dtype, end)
    if not isinstance(step, Variable):
        step = fill_constant([1], dtype, step)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("range", inputs={"Start": [start.name],
                                      "End": [end.name],
                                      "Step": [step.name]},
                     outputs={"Out": [out.name]})
    return out


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)
