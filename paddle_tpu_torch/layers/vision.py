"""The layers of paddle_tpu/layers/vision.py, with the same signatures:
the linear-chain CRF layers (kernels in ops/crf_ops.py), the 3-D
convolutions and pools, the sampling grids, ``pixel_shuffle``, ``lrn``,
``unfold``, ``temporal_shift``, deformable convolution and the
position-sensitive and precise RoI poolings (kernels in
ops/vision_ops.py), ``bilinear_tensor_product``, ``row_conv`` and the
misc tensor layers (``cos_sim``, ``chunk_eval``, ``crop``,
``data_norm``, ``mean_iou``, ``multiplex``, ``unique``; kernels in
ops/misc_ops.py)."""
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Dense-batch CRF log-likelihood (N, 1): input (N, T, C) emissions,
    label (N, T) or (N, T, 1); the transition parameter is (C + 2, C),
    rows 0 and 1 the start and stop scores, as in the reference."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(
        "float32", (input.shape[0], 1))
    alpha = helper.create_variable_for_type_inference("float32")
    em_exps = helper.create_variable_for_type_inference("float32")
    tr_exps = helper.create_variable_for_type_inference("float32")
    inputs = {"Emission": [input.name], "Transition": [transition.name],
              "Label": [label.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    helper.append_op(
        "linear_chain_crf", inputs=inputs,
        outputs={"LogLikelihood": [ll.name], "Alpha": [alpha.name],
                 "EmissionExps": [em_exps.name],
                 "TransitionExps": [tr_exps.name]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi paths (N, T, 1) int64 with the transition parameter that
    linear_chain_crf learned (pass the same param_attr name). As in the
    JAX package, the parameter is created again under that name, and the
    second creation's attributes win (ROADMAP: the ``crfw`` learning
    rate)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    path = helper.create_variable_for_type_inference(
        "int64", tuple(input.shape[:-1]) + (1,))
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    if length is not None:
        inputs["Length"] = [length.name]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path.name]})
    path.stop_gradient = True
    return path


def _triple(v):
    return [v, v, v] if isinstance(v, int) else list(v)


def _conv3_out(i, k, p, s, d=1, ceil=False):
    if i in (None, -1):
        return -1
    num = i + 2 * p - (d * (k - 1) + 1)
    out = (-(-num // s) if ceil else num // s) + 1
    if ceil and (out - 1) * s >= i + p:
        out -= 1  # last window must start inside input+left-pad (ref/torch)
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    helper = LayerHelper("conv3d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _triple(filter_size)
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan = filter_size[0] * filter_size[1] * filter_size[2] * num_channels
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan) ** 0.5))
    out_sp = [_conv3_out(input.shape[2 + i], filter_size[i], padding[i],
                         stride[i], dilation[i]) for i in range(3)]
    pre_bias = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], num_filters) + tuple(out_sp))
    helper.append_op(
        "conv3d", inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    helper = LayerHelper("conv3d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    if output_size is not None:
        output_size = _triple(output_size)
    if filter_size is None:
        # Reference conv_transpose derives the kernel from output_size:
        # out = (in-1)*s - 2p + d*(k-1) + 1  =>  k.
        if output_size is None:
            raise ValueError(
                "conv3d_transpose needs filter_size or output_size")
        if any(input.shape[2 + i] in (None, -1) for i in range(3)):
            raise ValueError(
                "conv3d_transpose cannot derive filter_size from "
                "output_size when input spatial dims are dynamic — pass "
                "filter_size explicitly")
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i] +
             2 * padding[i] - 1) // dilation[i] + 1 for i in range(3)]
        if any(k <= 0 for k in filter_size):
            raise ValueError(
                "conv3d_transpose: output_size %s too small for "
                "input/stride/padding (derived filter_size %s)"
                % (list(output_size), filter_size))
    else:
        filter_size = _triple(filter_size)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    out_sp = []
    for i in range(3):
        s_in = input.shape[2 + i]
        derived = (-1 if s_in in (None, -1) else
                   (s_in - 1) * stride[i] - 2 * padding[i] +
                   dilation[i] * (filter_size[i] - 1) + 1)
        if output_size is not None:
            # Any size in [derived, derived + stride - 1] maps back to the
            # same input extent (same check as ref conv_transpose_op.cc).
            if derived != -1 and not (
                    derived <= output_size[i] < derived + stride[i]):
                raise ValueError(
                    "conv3d_transpose output_size[%d]=%d incompatible with "
                    "input/stride/padding (valid range [%d, %d))"
                    % (i, output_size[i], derived, derived + stride[i]))
            out_sp.append(output_size[i])
        else:
            out_sp.append(derived)
    pre_bias = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], num_filters) + tuple(out_sp))
    attrs = {"strides": stride, "paddings": padding, "dilations": dilation,
             "groups": groups}
    if output_size is not None:
        attrs["output_size"] = list(output_size)
    helper.append_op(
        "conv3d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [pre_bias.name]},
        attrs=attrs)
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCDHW"):
    helper = LayerHelper("pool3d", name=name)
    pool_size = _triple(pool_size)
    pool_stride = _triple(pool_stride)
    pool_padding = _triple(pool_padding)
    if global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1, 1)
    else:
        sp = [_conv3_out(input.shape[2 + i], pool_size[i], pool_padding[i],
                         pool_stride[i], ceil=ceil_mode) for i in range(3)]
        shape = (input.shape[0], input.shape[1]) + tuple(sp)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        "pool3d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "exclusive": exclusive,
               "ceil_mode": ceil_mode})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        raise NotImplementedError("require_index is not supported: the "
                                  "pool3d op returns no argmax indices "
                                  "(nor does the JAX package's)")
    helper = LayerHelper("adaptive_pool3d", name=name)
    pool_size = _triple(pool_size)
    shape = (input.shape[0], input.shape[1]) + tuple(pool_size)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(
        "pool3d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "adaptive": True})
    return out


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    if not isinstance(out_shape, (list, tuple)):
        raise ValueError(
            "affine_grid needs out_shape as a static list/tuple "
            "[N, C, H, W]: shapes are fixed when the program is built, so "
            "a Variable out_shape (reference affine_grid_op OutputShape "
            "input) cannot be read here")
    out = helper.create_variable_for_type_inference(
        theta.dtype, (theta.shape[0], out_shape[2], out_shape[3], 2))
    helper.append_op("affine_grid", inputs={"Theta": [theta.name]},
                     outputs={"Output": [out.name]},
                     attrs={"output_shape": [int(s) for s in out_shape]})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    shape = (x.shape[0], x.shape[1], grid.shape[1], grid.shape[2])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("grid_sampler",
                     inputs={"X": [x.name], "Grid": [grid.name]},
                     outputs={"Output": [out.name]})
    return out


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle")
    r = int(upscale_factor)
    n, c, h, w = x.shape
    out = helper.create_variable_for_type_inference(
        x.dtype, (n, c // (r * r), h * r, w * r))
    helper.append_op("pixel_shuffle", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"upscale_factor": r})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format="NCHW"):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mid = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", name=name)
    ks = [kernel_sizes] * 2 if isinstance(kernel_sizes, int) \
        else list(kernel_sizes)
    st = [strides] * 2 if isinstance(strides, int) else list(strides)
    pd = [paddings] * 2 if isinstance(paddings, int) else list(paddings)
    dl = [dilations] * 2 if isinstance(dilations, int) else list(dilations)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("unfold", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"kernel_sizes": ks, "strides": st,
                            "paddings": pd, "dilations": dl})
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    helper = LayerHelper("temporal_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("temporal_shift", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"seg_num": int(seg_num),
                            "shift_ratio": float(shift_ratio)})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    helper = LayerHelper("deformable_conv", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = helper.input_dtype()
    groups = groups or 1
    deformable_groups = deformable_groups or 1
    num_channels = input.shape[1]
    fs = [filter_size] * 2 if isinstance(filter_size, int) \
        else list(filter_size)
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 2 if isinstance(dilation, int) \
        else list(dilation)
    filter_shape = [num_filters, num_channels // groups] + fs
    fan = fs[0] * fs[1] * num_channels
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan) ** 0.5))
    inputs = {"Input": [input.name], "Offset": [offset.name],
              "Filter": [w.name]}
    if modulated:
        if mask is None:
            raise ValueError("modulated deformable_conv (v2) requires mask")
        inputs["Mask"] = [mask.name]
    oh = _conv3_out(input.shape[2], fs[0], padding[0], stride[0], dilation[0])
    ow = _conv3_out(input.shape[3], fs[1], padding[1], stride[1], dilation[1])
    pre_bias = helper.create_variable_for_type_inference(
        dtype, (input.shape[0], num_filters, oh, ow))
    helper.append_op(
        "deformable_conv", inputs=inputs,
        outputs={"Output": [pre_bias.name]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "deformable_groups": deformable_groups})
    return helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "psroi_pool", inputs={"X": [input.name], "ROIs": [rois.name]},
        outputs={"Out": [out.name]},
        attrs={"output_channels": int(output_channels),
               "spatial_scale": float(spatial_scale),
               "pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width)})
    return out


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    helper = LayerHelper("prroi_pool", name=name)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if batch_roi_nums is not None:
        inputs["BatchRoINums"] = [batch_roi_nums.name]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "prroi_pool", inputs=inputs, outputs={"Out": [out.name]},
        attrs={"spatial_scale": float(spatial_scale),
               "pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width)})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = x.dtype
    w = helper.create_parameter(
        helper.param_attr, shape=[size, x.shape[1], y.shape[1]], dtype=dtype)
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    bias = helper.create_parameter(helper.bias_attr, shape=[1, size],
                                   dtype=dtype, is_bias=True)
    if bias is not None:
        inputs["Bias"] = [bias.name]
    out = helper.create_variable_for_type_inference(dtype, (x.shape[0], size))
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    helper = LayerHelper("chunk_eval")
    names = ["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"]
    dts = ["float32"] * 3 + ["int32"] * 3
    outs = [helper.create_variable_for_type_inference(dt, (1,))
            for dt in dts]
    inputs = {"Inference": [input.name], "Label": [label.name]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length.name]
    helper.append_op(
        "chunk_eval", inputs=inputs,
        outputs={s: [v.name] for s, v in zip(names, outs)},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": int(num_chunk_types),
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    for v in outs:
        v.stop_gradient = True
    return tuple(outs)


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype, (X.shape[0], 1))
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]})
    return out


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", name=name)
    attrs = {}
    inputs = {"X": [x.name]}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = [int(s) for s in shape]
        out_shape = tuple(int(s) for s in shape)
    else:                                   # Variable: take its static shape
        inputs["Y"] = [shape.name]
        out_shape = tuple(shape.shape)
    if offsets is not None:
        attrs["offsets"] = [int(o) for o in offsets]
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op("crop", inputs=inputs, outputs={"Out": [out.name]},
                     attrs=attrs)
    return out


def crop_tensor(x, shape=None, offsets=None, name=None):
    return crop(x, shape=shape, offsets=offsets, name=name)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    helper = LayerHelper("data_norm", param_attr=param_attr, act=act,
                         name=name)
    c = input.shape[1]
    from ..framework import unique_name as _un
    bsize = helper.create_or_get_global_variable(
        name=_un.generate(helper.name + ".batch_size"), dtype="float32",
        shape=(c,), persistable=True)
    helper.set_variable_initializer(bsize, ConstantInitializer(1e4))
    bsum = helper.create_or_get_global_variable(
        name=_un.generate(helper.name + ".batch_sum"), dtype="float32",
        shape=(c,), persistable=True)
    helper.set_variable_initializer(bsum, ConstantInitializer(0.0))
    bsq = helper.create_or_get_global_variable(
        name=_un.generate(helper.name + ".batch_square_sum"),
        dtype="float32", shape=(c,), persistable=True)
    helper.set_variable_initializer(bsq, ConstantInitializer(1e4))
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    means = helper.create_variable_for_type_inference("float32", (c,))
    scales = helper.create_variable_for_type_inference("float32", (c,))
    helper.append_op(
        "data_norm",
        inputs={"X": [input.name], "BatchSize": [bsize.name],
                "BatchSum": [bsum.name], "BatchSquareSum": [bsq.name]},
        outputs={"Y": [out.name], "Means": [means.name],
                 "Scales": [scales.name], "BatchSizeOut": [bsize.name],
                 "BatchSumOut": [bsum.name], "BatchSquareSumOut": [bsq.name]},
        attrs={"epsilon": epsilon})
    return helper.append_activation(out)


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32", ())
    wrong = helper.create_variable_for_type_inference("int32", (num_classes,))
    correct = helper.create_variable_for_type_inference(
        "int32", (num_classes,))
    helper.append_op("mean_iou",
                     inputs={"Predictions": [input.name],
                             "Labels": [label.name]},
                     outputs={"OutMeanIou": [miou.name],
                              "OutWrong": [wrong.name],
                              "OutCorrect": [correct.name]},
                     attrs={"num_classes": int(num_classes)})
    for v in (miou, wrong, correct):
        v.stop_gradient = True
    return miou, wrong, correct


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(
        inputs[0].dtype, inputs[0].shape)
    helper.append_op("multiplex",
                     inputs={"X": [v.name for v in inputs],
                             "Ids": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", input=input, param_attr=param_attr,
                         act=act)
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype, input.shape)
    helper.append_op("row_conv",
                     inputs={"X": [input.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def unique(x, dtype="int32"):
    """Static shapes, as in the JAX package: Out is sorted and padded to
    len(x); the number of valid leading entries is the 3rd value."""
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    index = helper.create_variable_for_type_inference(dtype, x.shape)
    count = helper.create_variable_for_type_inference("int32", ())
    helper.append_op("unique", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Index": [index.name],
                              "Count": [count.name]})
    for v in (out, index, count):
        v.stop_gradient = True
    return out, index, count


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    index = helper.create_variable_for_type_inference(dtype, x.shape)
    counts = helper.create_variable_for_type_inference(dtype, x.shape)
    count = helper.create_variable_for_type_inference("int32", ())
    helper.append_op("unique_with_counts", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Index": [index.name],
                              "Counts": [counts.name],
                              "Count": [count.name]})
    for v in (out, index, counts, count):
        v.stop_gradient = True
    return out, index, counts


__all__ = ["linear_chain_crf", "crf_decoding", "conv3d", "conv3d_transpose",
           "pool3d", "adaptive_pool3d", "affine_grid", "grid_sampler",
           "pixel_shuffle", "lrn", "unfold", "temporal_shift",
           "deformable_conv", "psroi_pool", "prroi_pool",
           "bilinear_tensor_product", "chunk_eval", "cos_sim", "crop",
           "crop_tensor", "data_norm", "mean_iou", "multiplex", "row_conv",
           "unique", "unique_with_counts"]
