"""Neural network layers BERT and GPT serving and pretraining use.

Counterpart of paddle_tpu/layers/nn.py: same signatures, and the op
types, attrs and var names each layer emits equal the JAX package's.
"""
import math

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer
from . import tensor as tensor_layers


def _single(helper, op_type, x, attrs=None, shape=None, out_slot="Out",
            dtype=None):
    out = helper.create_variable_for_type_inference(dtype or x.dtype, shape)
    helper.append_op(op_type, inputs={"X": [x.name]},
                     outputs={out_slot: [out.name]}, attrs=attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        in_shape = input_var.shape
        param_shape = [int(math.prod(in_shape[num_flatten_dims:])), size]
        w = helper.create_parameter(p_attr, shape=param_shape, dtype=dtype)
        out_shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(dtype, out_shape)
        helper.append_op(
            "mul", inputs={"X": [input_var.name], "Y": [w.name]},
            outputs={"Out": [tmp.name]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) != 1:
        raise NotImplementedError(
            "fc over several inputs needs the 'sum' op, which "
            "paddle_tpu_torch does not have yet")
    pre_act = helper.append_bias_op(mul_results[0],
                                    dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", param_attr=param_attr, dtype=dtype)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    if is_distributed and getattr(w, "sharding", None) is None:
        w.sharding = ("mp", None)
    in_shape = input.shape or (-1,)
    out_shape = tuple(in_shape[:-1] if in_shape[-1] == 1 else in_shape) + \
        (size[1],)
    tmp = helper.create_variable_for_type_inference(dtype, out_shape)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        "lookup_table",
        inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [tmp.name]},
        attrs={"is_sparse": is_sparse, "padding_idx": padding_idx,
               "is_distributed": is_distributed})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_size = int(math.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, shape=[norm_size], dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(helper.bias_attr, shape=[norm_size],
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(
        "float32", input.shape[:begin_norm_axis])
    var = helper.create_variable_for_type_inference(
        "float32", input.shape[:begin_norm_axis])
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": [out.name], "Mean": [mean.name],
                 "Variance": [var.name]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference("uint8", x.shape)
    helper.append_op(
        "dropout", inputs={"X": [x.name]},
        outputs={"Out": [out.name], "Mask": [mask.name]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        shape = x.shape if (x.shape is not None and y.shape is not None and
                            len(x.shape) >= len(y.shape)) else y.shape
        out = helper.create_variable_for_type_inference(x.dtype, shape)
        helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None,
           out_dtype=None):
    """``out_dtype``: the output's dtype, the products summed in f32
    (bf16 operands into f32 logits)."""
    helper = LayerHelper("matmul", name=name)
    shape = None
    if x.shape is not None and y.shape is not None:
        xs, ys = list(x.shape), list(y.shape)
        if len(xs) >= 2 and len(ys) >= 2:
            m = xs[-1] if transpose_x else xs[-2]
            n = ys[-2] if transpose_y else ys[-1]
            shape = tuple(xs[:-2]) + (m, n) if len(xs) >= len(ys) \
                else tuple(ys[:-2]) + (m, n)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype,
                                                    shape)
    attrs = {"transpose_X": transpose_x, "transpose_Y": transpose_y,
             "alpha": alpha}
    if out_dtype:
        attrs["out_dtype"] = out_dtype
    helper.append_op("matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _single(helper, "scale", x,
                  {"scale": float(scale), "bias": float(bias),
                   "bias_after_scale": bias_after_scale}, x.shape)
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, tuple(shape))
    helper.append_op("reshape2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for a in sorted(axes):
            shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("unsqueeze2", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape is not None else None
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("transpose2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": list(perm)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for a, s, e in zip(axes, starts, ends):
            dim = shape[a]
            if dim == -1:
                continue
            s2 = max(s + dim, 0) if s < 0 else min(s, dim)
            e2 = max(e + dim, 0) if e < 0 else min(e, dim)
            shape[a] = max(e2 - s2, 0)
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def cast(x, dtype):
    return tensor_layers.cast(x, dtype)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    return _single(helper, "mean", x, shape=(1,))


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    shape = None
    if input.shape is not None and index.shape is not None:
        shape = (index.shape[0],) + tuple(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("gather", inputs={"X": [input.name],
                                       "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
        n_out = num
    else:
        num, sections = 0, list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op("split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        shape = (1,) if not keep_dim else None
    else:
        dims = [dim] if isinstance(dim, int) else list(dim)
        attrs = {"dim": dims, "keep_dim": keep_dim, "reduce_all": False}
        shape = None
        if input.shape is not None:
            nd = len(input.shape)
            axes = {d % nd for d in dims}
            shape = tuple(s for s in (
                (1 if keep_dim else None) if i in axes else s
                for i, s in enumerate(input.shape)) if s is not None)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("reduce_sum", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = None
    if input.shape is not None:
        shape = tuple(input.shape[:-1]) + (k,)
    values = helper.create_variable_for_type_inference(input.dtype, shape)
    indices = helper.create_variable_for_type_inference("int64", shape)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name],
                              "Indices": [indices.name]},
                     attrs={"k": k})
    indices.stop_gradient = True
    return values, indices


__all__ = ["fc", "embedding", "layer_norm", "dropout", "elementwise_add",
           "elementwise_mul", "elementwise_div", "matmul", "mul", "scale",
           "reshape", "unsqueeze", "transpose", "slice", "cast", "mean",
           "gather", "split", "reduce_sum", "topk"]
