"""Neural network layers (the whole of paddle_tpu/layers/nn.py since the
op library's slice).

Counterpart of paddle_tpu/layers/nn.py: same signatures, and the op
types, attrs and var names each layer emits equal the JAX package's.
"""
import math

from ..framework import unique_name
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer
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
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            dtype, mul_results[0].shape)
        helper.append_op("sum", inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def _conv_out_size(i, k, p, s, d=1):
    if i in (None, -1):
        return -1
    ke = d * (k - 1) + 1
    return (i + 2 * p - ke) // s + 1


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair_list(filter_size)
    stride, padding = _pair_list(stride), _pair_list(padding)
    dilation = _pair_list(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std))
    oh = _conv_out_size(input.shape[2], filter_size[0], padding[0], stride[0],
                        dilation[0])
    ow = _conv_out_size(input.shape[3], filter_size[1], padding[1], stride[1],
                        dilation[1])
    pre_bias = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], num_filters, oh, ow))
    helper.append_op(
        "conv2d", inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride, padding = _pair_list(stride), _pair_list(padding)
    dilation = _pair_list(dilation)
    filter_shape = [num_channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    out_shape = None
    osz = None
    if output_size is not None:
        osz = _pair_list(output_size)
        out_shape = (input.shape[0], num_filters, osz[0], osz[1])
    elif input.shape is not None and filter_size is not None and \
            None not in input.shape[2:]:
        spatial = [
            (input.shape[2 + i] - 1) * stride[i] - 2 * padding[i] +
            dilation[i] * (filter_size[i] - 1) + 1
            if input.shape[2 + i] != -1 else -1
            for i in range(2)]
        out_shape = (input.shape[0], num_filters) + tuple(spatial)
    pre_bias = helper.create_variable_for_type_inference(dtype, out_shape)
    helper.append_op(
        "conv2d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "output_size": osz})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", name=name)
    pool_size, pool_stride = _pair_list(pool_size), _pair_list(pool_stride)
    pool_padding = _pair_list(pool_padding)
    if global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        shape = (input.shape[0], input.shape[1],
                 _conv_out_size(input.shape[2], pool_size[0],
                                pool_padding[0], pool_stride[0]),
                 _conv_out_size(input.shape[3], pool_size[1],
                                pool_padding[1], pool_stride[1]))
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        "pool2d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    pool_size = _pair_list(pool_size)
    shape = (input.shape[0], input.shape[1], pool_size[0], pool_size[1])
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        "pool2d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "adaptive": True})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale and Bias are f32 parameters, the moving mean and variance f32
    persistable globals (constant 0 and 1 in the startup program) that
    the op reads and writes back, whatever the input's dtype."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = "float32"
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_or_get_global_variable(
        name=moving_mean_name or unique_name.generate(helper.name + ".mean"),
        dtype=dtype, shape=(c,), persistable=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_or_get_global_variable(
        name=moving_variance_name or unique_name.generate(
            helper.name + ".var"),
        dtype=dtype, shape=(c,), persistable=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(dtype, (c,))
    saved_var = helper.create_variable_for_type_inference(dtype, (c,))
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [variance.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [variance.name],
                 "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
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
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")
elementwise_mod = _elementwise_layer("elementwise_mod")
elementwise_floordiv = _elementwise_layer("elementwise_floordiv")


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


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    return _single(helper, "clip", x, {"min": float(min), "max": float(max)},
                   x.shape)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    return _single(helper, "clip_by_norm", x, {"max_norm": float(max_norm)},
                   x.shape)


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


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    return _single(helper, "softmax", input, {"axis": axis}, input.shape)


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


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
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
        helper.append_op(op_type, inputs={"X": [input.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    shape = None
    if input.shape is not None:
        shape = tuple(s for i, s in enumerate(input.shape)
                      if not (i in [a % len(input.shape) for a in axes]
                              and s == 1))
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("squeeze2", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    shape = None
    if x[0].shape is not None:
        shape = list(x[0].shape)
        shape.insert(axis if axis >= 0 else axis + len(shape) + 1, len(x))
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(x[0].dtype, shape)
    helper.append_op("stack", inputs={"X": [v.name for v in x]},
                     outputs={"Y": [out.name]}, attrs={"axis": axis})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    shape = None
    if maxlen is not None and maxlen > 0 and x.shape is not None:
        shape = tuple(x.shape) + (maxlen,)
    out = helper.create_variable_for_type_inference(dtype, shape)
    helper.append_op("sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen if maxlen is not None else -1,
                            "out_dtype": dtype})
    out.stop_gradient = True
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


def expand(x, expand_times, name=None):
    """X tiled ``expand_times`` along each axis (``jnp.tile``)."""
    helper = LayerHelper("expand", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(-1 if s == -1 else s * t
                      for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("expand", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"expand_times": list(expand_times)})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    return _single(helper, "log_softmax", input, {"axis": axis}, input.shape)


def one_hot(input, depth, allow_out_of_range=False):
    """float32 rows of ``depth``; an id outside [0, depth) gives zeros."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"depth": depth, "dtype": "float32"})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    out = helper.create_variable_for_type_inference(dtype, label.shape)
    helper.append_op("label_smooth", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": float(epsilon)})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    return _single(helper, "cumsum", x,
                   {"axis": axis, "exclusive": exclusive, "reverse": reverse},
                   x.shape)


def where(condition, x=None, y=None):
    """Ternary select: x where ``condition``, else y."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("where", inputs={"Condition": [condition.name],
                                      "X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1):
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    op = "interp_bilinear" if resample.upper() == "BILINEAR" \
        else "interp_nearest"
    out = helper.create_variable_for_type_inference(
        input.dtype, (input.shape[0], input.shape[1]) + tuple(out_shape))
    helper.append_op(op, inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_h": int(out_shape[0]),
                            "out_w": int(out_shape[1]),
                            "align_corners": bool(align_corners),
                            "align_mode": int(align_mode)})
    return out


resize_bilinear = image_resize


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners=align_corners)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter, made at ``begin - step`` in the
    startup program, and an ``increment`` op (role ``lr_sched``) that adds
    ``step`` to it each run; returns a copy of its new value. As in the
    JAX package, every call appends another increment of the same
    counter, so two schedules built on it in one program advance it twice
    a run."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER_LR@"
    counter = helper.create_or_get_global_variable(
        name=name, dtype="int64", shape=(1,), persistable=True)
    if not getattr(counter, "_step_init_done", False):
        helper.set_variable_initializer(
            counter, ConstantInitializer(float(begin - step)))
        counter._step_init_done = True
    out = helper.create_variable_for_type_inference("int64", (1,))
    helper.append_op("increment", inputs={"X": [counter.name]},
                     outputs={"Out": [counter.name]},
                     attrs={"step": float(step), "op_role": "lr_sched"})
    helper.append_op("assign", inputs={"X": [counter.name]},
                     outputs={"Out": [out.name]})
    counter.stop_gradient = True
    out.stop_gradient = True
    return out


# ---- the op library's layers (paddle_tpu/layers/nn.py) ----

def embedding_bag(input, size, mode="sum", padding_idx=None,
                  param_attr=None, dtype="float32"):
    """Bagged embedding lookup: ids (N, bag) -> (N, D) reduced over the
    bag axis (lookup_table, then the reduction)."""
    emb = embedding(input, size, padding_idx=padding_idx,
                    param_attr=param_attr, dtype=dtype)   # (N, bag, D)
    if mode == "sum":
        return reduce_sum(emb, dim=1)
    if mode == "mean":
        return reduce_mean(emb, dim=1)
    if mode == "max":
        return reduce_max(emb, dim=1)
    raise ValueError("embedding_bag mode must be sum/mean/max")


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    shape = None
    if x.shape is not None and all(s != -1 for s in x.shape[axis:]):
        lead = x.shape[:axis]
        shape = ((-1 if any(s == -1 for s in lead)
                  else int(math.prod(lead or (1,)))),
                 int(math.prod(x.shape[axis:])))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("flatten2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input.name],
                                          "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    inputs = {"X": [input.name]}
    if param_attr is not False:
        s = helper.create_parameter(
            helper.param_attr, shape=[c], dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[c],
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference("float32")
    var = helper.create_variable_for_type_inference("float32")
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": [out.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    c = input.shape[1]
    inputs = {"X": [input.name]}
    if param_attr is not False:
        s = helper.create_parameter(
            helper.param_attr, shape=[c], dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s.name]
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, shape=[c],
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    sm = helper.create_variable_for_type_inference("float32")
    sv = helper.create_variable_for_type_inference("float32")
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": [out.name], "SavedMean": [sm.name],
                              "SavedVariance": [sv.name]},
                     attrs={"epsilon": epsilon})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("l2_normalize", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Norm": [norm.name]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    n, c, h, w = x.shape
    r = reshape(x, [-1 if n == -1 else n, c // groups, groups, h, w])
    return reduce_max(r, dim=2)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shape = None
    if x.shape is not None and len(paddings) >= 2 * len(x.shape):
        shape = tuple(
            d if d == -1 else d + paddings[2 * i] + paddings[2 * i + 1]
            for i, d in enumerate(x.shape))
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pad2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value)})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    else:
        shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(
        helper.param_attr, shape=shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    pos = _single(LayerHelper("relu"), "relu", x, shape=x.shape)
    neg_in = elementwise_min(x, tensor_layers.zeros([1], x.dtype))
    if mode == "channel":
        neg = elementwise_mul(neg_in, alpha, axis=1)
    else:
        neg = elementwise_mul(neg_in, alpha)
    return elementwise_add(pos, neg)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None, name=None):
    """A host Python function as an op (reference layers/nn.py:12369
    py_func): ``func`` runs on numpy copies of ``x`` and fills ``out``,
    which must be Variables with static shapes; ``backward_func(*inputs,
    *outputs, *out_grads)`` returns each input's gradient (None: zeros).
    A program holding it runs op by op on the card (the op reads its
    inputs on the host). The functions live in a process-local table,
    so the program runs in the process that built it."""
    from ..ops.misc_ops import register_py_func
    if skip_vars_in_backward_input:
        raise NotImplementedError(
            "py_func skip_vars_in_backward_input is not supported — the "
            "backward callback always receives (*inputs, *outputs, "
            "*out_grads); drop the skip list and index accordingly")
    helper = LayerHelper("py_func", name=name)
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        if o.shape is None or any(s in (None, -1) for s in o.shape):
            raise ValueError(
                "py_func outputs need fully static shapes; got %r "
                "for %s" % (o.shape, o.name))
    fid = register_py_func(func, backward_func)
    helper.append_op(
        "py_func",
        inputs={"X": [v.name for v in xs]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"func_id": fid,
               "out_meta": [[list(o.shape), str(o.dtype)] for o in outs]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("scatter",
                     inputs={"X": [input.name], "Ids": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]},
                     attrs={"overwrite": overwrite})
    return out


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", name=name)
    out = helper.create_variable_for_type_inference(ref.dtype, ref.shape)
    helper.append_op("scatter_nd_add",
                     inputs={"X": [ref.name], "Index": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(
        "int32", (len(input.shape),) if input.shape else None)
    helper.append_op("shape", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]})
    out.stop_gradient = True
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Ref nn.py:3156 / spectral_norm_op.h: weight / sigma_max via power
    iteration; U and V iterates persist across steps (batch_norm-style
    running state)."""
    helper = LayerHelper("spectral_norm", name=name)
    shape = weight.shape
    perm_h = shape[dim]
    perm_w = int(math.prod(shape)) // perm_h
    from ..framework import unique_name as _un
    from ..initializer import NormalInitializer
    u = helper.create_or_get_global_variable(
        name=_un.generate(helper.name + ".u"), dtype="float32",
        shape=(perm_h,), persistable=True)
    helper.set_variable_initializer(u, NormalInitializer(0.0, 1.0))
    v = helper.create_or_get_global_variable(
        name=_un.generate(helper.name + ".v"), dtype="float32",
        shape=(perm_w,), persistable=True)
    helper.set_variable_initializer(v, NormalInitializer(0.0, 1.0))
    out = helper.create_variable_for_type_inference(weight.dtype,
                                                    weight.shape)
    helper.append_op(
        "spectral_norm",
        inputs={"Weight": [weight.name], "U": [u.name], "V": [v.name]},
        outputs={"Out": [out.name], "UOut": [u.name], "VOut": [v.name]},
        attrs={"dim": int(dim), "power_iters": int(power_iters),
               "eps": float(eps)})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": [x.name]},
                     outputs={"Y": [o.name for o in outs]},
                     attrs={"axis": axis, "num": num})
    return outs


__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "pool2d",
           "adaptive_pool2d", "image_resize", "resize_bilinear",
           "resize_nearest",
           "batch_norm", "layer_norm", "dropout", "softmax", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv", "matmul", "mul",
           "clip", "clip_by_norm", "scale", "reshape", "unsqueeze",
           "transpose", "slice", "cast", "mean", "gather", "split",
           "reduce_sum", "reduce_mean", "squeeze", "stack", "sequence_mask",
           "topk", "where", "autoincreased_step_counter",
           "expand", "log_softmax", "one_hot", "label_smooth", "cumsum",
           "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
           "reduce_any", "embedding_bag", "flatten", "gather_nd",
           "group_norm", "instance_norm", "l2_normalize", "maxout", "pad",
           "pad2d", "prelu", "py_func", "scatter", "scatter_nd_add", "shape",
           "spectral_norm", "unstack"]
