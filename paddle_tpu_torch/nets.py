"""Composite networks (counterpart of paddle_tpu/nets.py; reference
python/paddle/fluid/nets.py)."""
from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]

    def _expand(v):
        return v if isinstance(v, (list, tuple)) \
            else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)
    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """Dense (N,T,D) variant of the reference's LoD sequence_conv_pool."""
    # 1-D conv over time via conv2d on (N,1,T,D)
    x = layers.unsqueeze(input, [1])
    conv = layers.conv2d(x, num_filters, (filter_size, input.shape[-1]),
                         padding=(filter_size // 2, 0),
                         param_attr=param_attr, act=act)
    # (N, F, T', 1) -> (N, T', F)
    conv = layers.squeeze(conv, [3])
    conv = layers.transpose(conv, [0, 2, 1])
    from .layers.sequence_lod import sequence_pool
    return sequence_pool(conv, pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    from .layers.attention import scaled_dot_product_attention as sdpa
    return sdpa(queries, keys, values, num_heads=num_heads,
                dropout_rate=dropout_rate)
