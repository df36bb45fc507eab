"""Contrib layers (counterpart of paddle_tpu/contrib/layers/nn.py, ref
python/paddle/fluid/contrib/layers/nn.py), with the JAX package's
signatures and parameter names: the text-matching layers
(``match_matrix_tensor``, ``sequence_topk_avg_pooling``,
``var_conv_2d``, ``shuffle_batch``), ``tree_conv``,
``fused_elemwise_activation``, ``fused_embedding_seq_pool`` and
``multiclass_nms2``. Ragged LoD inputs are padded tensors with explicit
length variables, as in the JAX package; ``search_pyramid_hash`` is
absent there and here.
"""
from ...layer_helper import LayerHelper
from ... import layers

__all__ = [
    "fused_elemwise_activation", "var_conv_2d", "match_matrix_tensor",
    "sequence_topk_avg_pooling", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "shuffle_batch",
]


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """Fused binary+unary compound (ref contrib nn.py:41).  The
    reference hand-fuses e.g. elementwise_add+relu into one CUDA
    kernel; XLA performs that fusion automatically, so this emits the
    composed ops and returns (out, intermediate) with identical
    semantics — the attr set is validated the same way."""
    if not isinstance(functor_list, (list, tuple)) or \
            len(functor_list) != 2:
        raise ValueError("functor_list should be a list of size 2")
    binary = {"elementwise_add", "elementwise_sub", "elementwise_mul"}
    unary = {"relu", "sigmoid", "tanh", "scale", "gelu"}

    def apply_one(name, a, b=None):
        if name in binary:
            return getattr(layers, name)(a, b, axis=axis)
        if name == "scale":
            return layers.scale(a, scale=scale)
        return getattr(layers, name)(a)

    f1, f2 = functor_list
    # fluid convention: functor_list[0] is the OUTER functor —
    # [binary, unary] => binary(x, unary(y)); [unary, binary] =>
    # unary(binary(x, y)) (ref fused_elemwise_activation_op.h
    # BinaryCompound/UnaryCompound)
    if f1 in binary and f2 in unary:
        intermediate = apply_one(f2, y)
        out = apply_one(f1, x, intermediate)
    elif f1 in unary and f2 in binary:
        intermediate = apply_one(f2, x, y)
        out = apply_one(f1, intermediate)
    else:
        raise ValueError("functor_list must pair one binary elementwise "
                         "op with one unary activation, got %r" %
                         (functor_list,))
    return (out, intermediate) if save_intermediate_out else out


def var_conv_2d(input, row, col, input_channel, output_channel,
                filter_size, stride=1, param_attr=None, act=None,
                dtype="float32", name=None):
    """Variable-size 2-D conv (ref contrib nn.py:105).  input:
    (N, C_in, H_max, W_max) padded; row/col: (N,) valid extents
    (replacing the reference's row/col LoD inputs)."""
    helper = LayerHelper("var_conv_2d", param_attr=param_attr, name=name,
                         act=act, dtype=dtype)
    fs = filter_size if isinstance(filter_size, (list, tuple)) else \
        [filter_size, filter_size]
    st = stride if isinstance(stride, (list, tuple)) else [stride, stride]
    w = helper.create_parameter(
        helper.param_attr,
        shape=[output_channel, input_channel, fs[0], fs[1]], dtype=dtype)
    n, h, wd = input.shape[0], input.shape[2], input.shape[3]
    out = helper.create_variable_for_type_inference(
        dtype, (n, output_channel, (h + st[0] - 1) // st[0],
                (wd + st[1] - 1) // st[1]))
    helper.append_op(
        "var_conv_2d",
        inputs={"X": [input.name], "W": [w.name], "RowLen": [row.name],
                "ColLen": [col.name]},
        outputs={"Out": [out.name]},
        attrs={"stride": list(st)})
    return helper.append_activation(out)


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    """Bilinear semantic match matrix (ref contrib nn.py:221).
    x: (N, Tx, D1), y: (N, Ty, D2) dense -> (N, channel_num, Tx, Ty)."""
    helper = LayerHelper("match_matrix_tensor", param_attr=param_attr,
                         act=act, name=name, dtype=dtype)
    d1, d2 = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[d1, channel_num, d2], dtype=dtype)
    out = helper.create_variable_for_type_inference(
        dtype, (x.shape[0], channel_num, x.shape[1], y.shape[1]))
    helper.append_op(
        "match_matrix_tensor",
        inputs={"X": [x.name], "Y": [y.name], "W": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"dim_t": channel_num})
    return helper.append_activation(out), w


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """Top-k column-average pooling of a match matrix
    (ref contrib nn.py:304).  input: (N, C, Tx, Ty); row/col: (N,)
    lengths -> (N, Tx, C * len(topks))."""
    helper = LayerHelper("sequence_topk_avg_pooling", input=input)
    n, c, tx = input.shape[0], input.shape[1], input.shape[2]
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, tx, c * len(topks)))
    helper.append_op(
        "sequence_topk_avg_pooling",
        inputs={"X": [input.name], "RowLen": [row.name],
                "ColLen": [col.name]},
        outputs={"Out": [out.name]},
        attrs={"topks": list(topks), "channel_num": channel_num})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """Tree-based convolution (ref contrib nn.py:372).  nodes_vector:
    (N, M, F); edge_set: (N, E, 2) [parent, child], negative-padded.
    Returns (N, M, output_size, num_filters)."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = nodes_vector.dtype
    f = nodes_vector.shape[-1]
    w = helper.create_parameter(
        helper.param_attr, shape=[f, 3, output_size, num_filters],
        dtype=dtype)
    n, m = nodes_vector.shape[0], nodes_vector.shape[1]
    out = helper.create_variable_for_type_inference(
        dtype, (n, m, output_size, num_filters))
    helper.append_op(
        "tree_conv",
        inputs={"NodesVector": [nodes_vector.name],
                "EdgeSet": [edge_set.name], "Filter": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"max_depth": max_depth})
    if helper.bias_attr:
        out = helper.append_bias_op(out, dim_start=2, dim_end=3)
    return helper.append_activation(out)


def fused_embedding_seq_pool(input, size, is_sparse=False,
                             padding_idx=None, combiner="sum",
                             param_attr=None, dtype="float32"):
    """Embedding lookup + sequence pool in one go (ref contrib
    nn.py:437).  input: (N, T) or (N, T, 1) ids -> (N, D).  The
    reference fuses to skip materializing (N*T, D); XLA achieves the
    same fusion from the composed graph, so this emits
    embedding(+masked padding) then sequence_pool."""
    if combiner not in ("sum", "average", "max"):
        raise ValueError("unsupported combiner %r" % combiner)
    emb = layers.embedding(input, size=size, is_sparse=is_sparse,
                           padding_idx=padding_idx, param_attr=param_attr,
                           dtype=dtype)
    pool_type = {"average": "average"}.get(combiner, combiner)
    return layers.sequence_pool(emb, pool_type)


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """multiclass_nms variant that can also return kept-box indices
    (ref contrib nn.py:503) — delegates to the detection layer, which
    already computes Index."""
    return layers.multiclass_nms(
        bboxes, scores, score_threshold, nms_top_k, keep_top_k,
        nms_threshold=nms_threshold, normalized=normalized,
        nms_eta=nms_eta, background_label=background_label,
        return_index=return_index, name=name)


def shuffle_batch(x, seed=None):
    """Random whole-row shuffle (ref contrib nn.py:729); permutation is
    drawn from the deterministic per-op PRNG stream unless a seed attr
    pins it."""
    helper = LayerHelper("shuffle_batch", input=x)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    idx = helper.create_variable_for_type_inference("int64",
                                                    (x.shape[0],))
    helper.append_op(
        "shuffle_batch",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name], "ShuffleIdx": [idx.name]},
        # -1 = unseeded; seed=0 is a legal pinned seed
        attrs={"startup_seed": -1 if seed is None else int(seed)})
    return out
