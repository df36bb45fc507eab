"""Sequence layers (counterpart of paddle_tpu/layers/sequence_lod.py,
whole): dense (batch, max_len, ...) tensors with explicit length vectors
in place of the reference's LoD, masks from ``sequence_mask``. Same
signatures and the same ops, attrs and names as the JAX package."""
from ..layer_helper import LayerHelper
from .nn import (sequence_mask, elementwise_mul, reduce_sum, reduce_max,
                 elementwise_div, unsqueeze, expand, softmax)
from . import tensor as tensor_layers

__all__ = [
    "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_first_step",
    "sequence_last_step", "sequence_reverse", "sequence_pad",
    "sequence_unpad", "sequence_erase", "sequence_enumerate",
    "sequence_slice", "sequence_reshape", "sequence_conv",
    "sequence_scatter",
]


def sequence_pool(input, pool_type, lengths=None):
    """input: (N, T, D) dense; lengths: (N,) int — replaces LoD.
    pool_type: sum | average | max | last | first."""
    if pool_type == "first":
        return sequence_first_step(input)
    if pool_type == "last":
        return sequence_last_step(input, lengths)
    if lengths is None:
        if pool_type == "sum":
            return reduce_sum(input, dim=1)
        if pool_type in ("average", "mean"):
            from .nn import reduce_mean
            return reduce_mean(input, dim=1)
        if pool_type == "max":
            return reduce_max(input, dim=1)
        raise ValueError("unsupported pool_type %r" % pool_type)
    mask = sequence_mask(lengths, maxlen=input.shape[1], dtype=input.dtype)
    mask3 = unsqueeze(mask, [2])
    masked = elementwise_mul(input, mask3)
    if pool_type == "sum":
        return reduce_sum(masked, dim=1)
    if pool_type in ("average", "mean"):
        denom = reduce_sum(mask3, dim=1)
        return elementwise_div(reduce_sum(masked, dim=1), denom)
    if pool_type == "max":
        neg = (mask3 + (-1.0)) * 1e30
        return reduce_max(masked + neg, dim=1)
    raise ValueError("unsupported pool_type %r" % pool_type)


def sequence_softmax(input, lengths=None, axis=1):
    if lengths is None:
        return softmax(input, axis=axis)
    mask = sequence_mask(lengths, maxlen=input.shape[axis],
                         dtype=input.dtype)
    bias = (mask + (-1.0)) * 1e30
    return softmax(input + bias, axis=axis)


def _seq_op(op_type, inputs, n_out=1, dtypes=None, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    first = inputs["X"][0]
    dtypes = dtypes or [first.dtype] * n_out
    outs = [helper.create_variable_for_type_inference(dt) for dt in dtypes]
    slots = ["Out", "OutLength"] if n_out == 2 else ["Out"]
    helper.append_op(op_type,
                     inputs={k: [v.name for v in vs]
                             for k, vs in inputs.items()},
                     outputs=dict(zip(slots, [[o.name] for o in outs])),
                     attrs=attrs or {})
    return outs


def sequence_expand(x, y, ref_level=-1, out_len=None, name=None):
    """Repeat row i of x by a per-row count (reference sequence_expand,
    layers/sequence_lod.py:596 + sequence_ops/sequence_expand_op.h).

    Dense encoding: ``y`` is the repeat-count int vector (N,), the dense
    stand-in for the reference's y-LoD at ref_level, and ``out_len`` is
    the static row capacity of the output (>= the total; rows past the
    total come back zeroed). Returns (out, out_length) where out_length
    is the (1,) total.
    """
    if out_len is None:
        raise ValueError(
            "sequence_expand needs a static out_len capacity (shapes are "
            "fixed when the step is captured); pass e.g. N * max_repeat")
    out, out_length = _seq_op(
        "sequence_expand", {"X": [x], "RepeatCounts": [y]}, n_out=2,
        dtypes=[x.dtype, "int32"],
        attrs={"out_len": int(out_len), "ref_level": ref_level}, name=name)
    return out, out_length


def sequence_expand_as(x, y, lengths=None, name=None):
    """Broadcast rows of x (N, D) over y's (N, T, ...) time dimension,
    zeroed past each length (reference sequence_expand_as_op)."""
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x.name], "Y": [y.name]}
    if lengths is not None:
        inputs["Length"] = [lengths.name]
    helper.append_op("sequence_expand_as", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_concat(input, name=None):
    from .tensor import concat
    return concat(input, axis=1)


def sequence_first_step(input):
    from .nn import slice as slice_layer, squeeze
    s = slice_layer(input, axes=[1], starts=[0], ends=[1])
    return squeeze(s, axes=[1])


def sequence_last_step(input, lengths=None):
    from .nn import slice as slice_layer, squeeze, gather_nd
    if lengths is None:
        s = slice_layer(input, axes=[1], starts=[-1],
                        ends=[input.shape[1] + 1])
        return squeeze(s, axes=[1])
    # gather per-row step len_i - 1: take_along_axis via sequence_slice
    # (offset = len-1, slice length = 1)
    from .nn import elementwise_sub
    one = tensor_layers.fill_constant_batch_size_like(
        lengths, shape=[-1], dtype="int32", value=1)
    offset = elementwise_sub(lengths, one)
    out, _ = _seq_op("sequence_slice",
                     {"X": [input], "Offset": [offset],
                      "SliceLength": [one]}, n_out=2,
                     dtypes=[input.dtype, "int32"])
    # slice keeps T (left-aligned); the gathered step sits at t=0
    return squeeze(_slice_time(out, 0, 1), axes=[1])


def sequence_reverse(x, lengths=None, name=None):
    """Reverse each valid prefix (reference sequence_reverse_op); without
    lengths this is a plain time-axis reverse."""
    if lengths is None:
        from .tensor import reverse
        return reverse(x, axis=[1])
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sequence_reverse",
                     inputs={"X": [x.name], "Length": [lengths.name]},
                     outputs={"Y": [out.name]})
    return out


def sequence_pad(x, pad_value=0.0, maxlen=None, lengths=None, name=None):
    """Dense input is already rectangular; this masks everything past each
    row's length to pad_value (and re-caps T at maxlen when given),
    returning (out, lengths) like the reference."""
    helper = LayerHelper("sequence_pad_dense", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lens_out = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [x.name]}
    if lengths is not None:
        inputs["Length"] = [lengths.name]
    helper.append_op("sequence_pad_dense", inputs=inputs,
                     outputs={"Out": [out.name], "Length": [lens_out.name]},
                     attrs={"pad_value": float(pad_value),
                            "padded_length": maxlen if maxlen else -1})
    lens_out.stop_gradient = True
    return out, lens_out


def sequence_unpad(x, length, name=None):
    """Zero the padded region (the dense analogue of stripping padding)."""
    out, _ = sequence_pad(x, pad_value=0.0, lengths=length, name=name)
    return out


def sequence_erase(x, tokens, lengths=None, pad_value=0, name=None):
    """Drop listed tokens and left-compact (reference sequence_erase_op).
    Returns (out, new_lengths)."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    new_len = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [x.name]}
    if lengths is not None:
        inputs["Length"] = [lengths.name]
    helper.append_op("sequence_erase", inputs=inputs,
                     outputs={"Out": [out.name], "OutLength": [new_len.name]},
                     attrs={"tokens": list(tokens), "pad_value": pad_value})
    out.stop_gradient = new_len.stop_gradient = True
    return out, new_len


def sequence_enumerate(input, win_size, pad_value=0, lengths=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    shape = None
    if input.shape is not None:
        shape = tuple(input.shape) + (win_size,)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    inputs = {"X": [input.name]}
    if lengths is not None:
        inputs["Length"] = [lengths.name]
    helper.append_op("sequence_enumerate", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    out.stop_gradient = True
    return out


def sequence_slice(input, offset, length, name=None):
    """Per-row subsequence starting at offset[i] of length[i], left-aligned
    (reference sequence_slice_op). Returns (out, out_lengths)."""
    out, out_len = _seq_op("sequence_slice",
                           {"X": [input], "Offset": [offset],
                            "SliceLength": [length]}, n_out=2,
                           dtypes=[input.dtype, "int32"], name=name)
    out_len.stop_gradient = True
    return out, out_len


def sequence_reshape(input, new_dim, lengths=None):
    """Re-chunk token dim (reference sequence_reshape_op): total payload per
    row is constant, so T*D -> (T*D/new_dim, new_dim). Lengths scale by
    D/new_dim (caller guarantees divisibility, as the reference enforces).

    Returns the reshaped tensor alone (fluid-compatible) when lengths is
    None; with lengths it returns (out, new_lengths)."""
    from .nn import reshape, scale as scale_layer
    from .tensor import cast
    t, d = input.shape[-2], input.shape[-1]
    out = reshape(input, shape=[0, t * d // new_dim, new_dim])
    if lengths is None:
        return out
    scaled = scale_layer(cast(lengths, "float32"), scale=float(d) / new_dim)
    return out, cast(scaled, "int32")


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, lengths=None, name=None):
    """Context-window convolution over time (reference sequence_conv_op):
    the +/- context window stacked, then one matmul. padding_start
    defaults to -(filter_size-1)/2 (centered window)."""
    from .nn import matmul
    if filter_stride != 1:
        raise ValueError("sequence_conv supports filter_stride=1 only "
                         "(as the reference op enforces)")
    helper = LayerHelper("sequence_conv", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = helper.input_dtype()
    d = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=dtype)
    if padding_start is None:
        padding_start = -((filter_size - 1) // 2)
    # window stack: (N, T, filter_size*D) via shifted concat
    shifted = []
    from .tensor import concat
    from .nn import pad as _pad
    t = input.shape[1]
    seq_mask = None
    if lengths is not None:
        # zero the pad region first: shifted windows near the end of each
        # row's valid prefix would otherwise pull in whatever garbage sits
        # past its length (the output mask below can't undo that).
        seq_mask = sequence_mask(lengths, maxlen=t, dtype=dtype)
        input = elementwise_mul(input, unsqueeze(seq_mask, [2]))
    for k in range(filter_size):
        off = padding_start + k
        if off == 0:
            shifted.append(input)
        elif off < 0:
            padded = _pad(input, paddings=[0, 0, -off, 0, 0, 0])
            shifted.append(
                _slice_time(padded, 0, t))
        else:
            padded = _pad(input, paddings=[0, 0, 0, off, 0, 0])
            shifted.append(_slice_time(padded, off, off + t))
    windows = concat(shifted, axis=2)           # (N, T, K*D)
    out = matmul(windows, w)
    pre_act = helper.append_bias_op(out, dim_start=2)
    res = helper.append_activation(pre_act)
    if seq_mask is not None:
        res = elementwise_mul(res, unsqueeze(seq_mask, [2]))
    return res


def _slice_time(x, start, end):
    from .nn import slice as slice_layer
    return slice_layer(x, axes=[1], starts=[start], ends=[end])


def sequence_scatter(input, index, updates, lengths=None, name=None):
    """Scatter per-row updates into per-row positions (ref
    sequence_ops/sequence_scatter_op.h). Dense form: input (N, T),
    index (N, K) positions, updates (N, K) values added at those
    positions (duplicates accumulate, matching scatter-add); lengths
    (N,) masks each row's padded tail of (index, updates) pairs."""
    ins = {"X": [input], "Ids": [index], "Updates": [updates]}
    if lengths is not None:
        ins["Length"] = [lengths]
    out, = _seq_op("sequence_scatter", ins, n_out=1, name=name)
    return out
