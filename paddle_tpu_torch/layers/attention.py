"""Attention layers (counterpart of paddle_tpu/layers/attention.py).

One fused ``scaled_dot_product_attention`` op per attention; on a CUDA
tensor it runs the port's flash-attention kernel
(ops/kernels/flash_attention.py).
"""
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn import fc, dropout, reshape, transpose
from .tensor import concat


def fused_attention(q, k, v, mask=None, scale=None, causal=False,
                    impl="auto", sp_axis="sp", name=None):
    """q, k, v: (B, H, T, Dh). impl: "auto" | "flash" (the kernel),
    "xla" (the plain version); "ring"/"ulysses" wait for the multi-GPU
    slice."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, q.shape)
    inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if mask is not None:
        inputs["Mask"] = [mask.name]
    helper.append_op("scaled_dot_product_attention", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"scale": scale, "causal": causal, "impl": impl,
                            "sp_axis": sp_axis})
    return out


def _split_heads(x, n_head, dh):
    r = reshape(x, [0, -1 if x.shape[1] == -1 else x.shape[1], n_head, dh])
    return transpose(r, [0, 2, 1, 3])


def mha_kv_projection(keys, values, d_key, d_value, n_head,
                      param_initializer=None, name="multi_head_att"):
    """Project once into head-split K/V, (N, H, T_src, Dh) each, with the
    parameter names multi_head_attention uses."""
    def _attr(suffix):
        return ParamAttr(name=None if name is None else name + suffix,
                         initializer=param_initializer)

    k = fc(keys, d_key * n_head, num_flatten_dims=2,
           param_attr=_attr("_key_fc.w_0"), bias_attr=_attr("_key_fc.b_0"))
    v = fc(values, d_value * n_head, num_flatten_dims=2,
           param_attr=_attr("_value_fc.w_0"), bias_attr=_attr("_value_fc.b_0"))
    return _split_heads(k, n_head, d_key), _split_heads(v, n_head, d_value)


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0, cache=None,
                         param_initializer=None, name="multi_head_att",
                         is_test=False, causal=False, attn_impl="auto"):
    """The transformer MHA block of ERNIE/BERT and the Transformer (same
    ops and parameter names as the JAX package's). ``cache``: precomputed
    cross-attention ``static_k``/``static_v`` (see mha_kv_projection), or
    an incremental self-attention cache ``{"k", "v"}`` (None at the first
    step): this step's K/V are concatenated onto it along the time axis
    and stored back, and a single query row attends to the whole cache
    (``causal`` dropped)."""
    keys = queries if keys is None else keys
    values = keys if values is None else values

    def _attr(suffix):
        return ParamAttr(name=None if name is None else name + suffix,
                         initializer=param_initializer)

    q = fc(queries, d_key * n_head, num_flatten_dims=2,
           param_attr=_attr("_query_fc.w_0"), bias_attr=_attr("_query_fc.b_0"))
    qh = _split_heads(q, n_head, d_key)
    if cache is not None and "static_k" in cache:
        kh, vh = cache["static_k"], cache["static_v"]
    else:
        kh, vh = mha_kv_projection(keys, values, d_key, d_value, n_head,
                                   param_initializer=param_initializer,
                                   name=name)
        if cache is not None:
            if cache.get("k") is not None:
                kh = concat([cache["k"], kh], axis=2)
                vh = concat([cache["v"], vh], axis=2)
            cache["k"], cache["v"] = kh, vh
            if queries.shape[1] == 1:
                causal = False
    ctx = fused_attention(qh, kh, vh, mask=attn_bias, scale=d_key ** -0.5,
                          causal=causal, impl=attn_impl)
    ctx = transpose(ctx, [0, 2, 1, 3])
    ctx = reshape(ctx, [0, -1 if queries.shape[1] == -1 else queries.shape[1],
                        d_value * n_head])
    if dropout_rate:
        ctx = dropout(ctx, dropout_rate, is_test=is_test,
                      dropout_implementation="upscale_in_train")
    return fc(ctx, d_model, num_flatten_dims=2,
              param_attr=_attr("_output_fc.w_0"),
              bias_attr=_attr("_output_fc.b_0"))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, is_test=False):
    """queries/keys/values: (N, T, D). Multi-head fused attention."""
    helper = LayerHelper("sdpa")
    n, tq, d = queries.shape
    dh = d // num_heads
    q = transpose(reshape(queries, [0, -1 if tq == -1 else tq, num_heads,
                                    dh]), [0, 2, 1, 3])
    k = transpose(reshape(keys, [0, -1 if keys.shape[1] == -1
                                 else keys.shape[1], num_heads, dh]),
                  [0, 2, 1, 3])
    v = transpose(reshape(values, [0, -1 if values.shape[1] == -1
                                   else values.shape[1], num_heads, dh]),
                  [0, 2, 1, 3])
    out = fused_attention(q, k, v)
    out = reshape(transpose(out, [0, 2, 1, 3]), [0, -1 if tq == -1 else tq,
                                                 d])
    if dropout_rate:
        out = dropout(out, dropout_rate, is_test=is_test)
    return out


__all__ = ["fused_attention", "mha_kv_projection", "multi_head_attention",
           "scaled_dot_product_attention"]
