"""Classification model zoo beyond ResNet (counterpart of
paddle_tpu/models/vision.py; reference PaddlePaddle/models
image_classification: mobilenet.py, vgg.py, se_resnext.py).

Static-graph builders in the fluid style, NCHW, with the JAX package's
op order and unique names, so weights cross between the packages by
name. MobileNet's depthwise and SE-ResNeXt's 32-group convolutions go to
cuDNN on the card like every convolution.
"""
import numpy as np

from .. import layers
from ..framework.program import Program, program_guard

__all__ = ["mobilenet_v1", "vgg_net", "se_resnext50",
           "classification_train_program", "synthetic_image_batch"]


def _conv_bn(input, filters, ksize, stride=1, groups=1, act="relu",
             is_test=False):
    conv = layers.conv2d(input, num_filters=filters, filter_size=ksize,
                         stride=stride, padding=(ksize - 1) // 2,
                         groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _depthwise_separable(input, ch_in, ch_out, stride, scale=1.0,
                         is_test=False):
    """MobileNet v1 block: depthwise 3x3 (+BN) then pointwise 1x1 (+BN);
    the depthwise convolution is a conv2d with groups == channels."""
    dw = _conv_bn(input, int(ch_in * scale), 3, stride=stride,
                  groups=int(ch_in * scale), is_test=is_test)
    return _conv_bn(dw, int(ch_out * scale), 1, is_test=is_test)


def mobilenet_v1(input, class_dim=1000, scale=1.0, is_test=False):
    """MobileNet-224 v1 (ref models mobilenet.py)."""
    y = _conv_bn(input, int(32 * scale), 3, stride=2, is_test=is_test)
    cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
           (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
          [(512, 1024, 2), (1024, 1024, 1)]
    for ch_in, ch_out, stride in cfg:
        y = _depthwise_separable(y, ch_in, ch_out, stride, scale, is_test)
    pool = layers.pool2d(y, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def vgg_net(input, class_dim=1000, layers_cfg=16, is_test=False):
    """VGG-11/13/16/19 (ref models vgg.py)."""
    cfgs = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
            16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}
    nums = cfgs[layers_cfg]
    channels = [64, 128, 256, 512, 512]
    y = input
    for reps, ch in zip(nums, channels):
        for _ in range(reps):
            y = layers.conv2d(y, num_filters=ch, filter_size=3, padding=1,
                              act="relu")
        y = layers.pool2d(y, pool_size=2, pool_stride=2, pool_type="max")
    y = layers.fc(y, size=512, act="relu")
    y = layers.dropout(y, dropout_prob=0.5, is_test=is_test)
    y = layers.fc(y, size=512, act="relu")
    y = layers.dropout(y, dropout_prob=0.5, is_test=is_test)
    return layers.fc(y, size=class_dim, act="softmax")


def _squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(num_channels // reduction_ratio, 4),
                        act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    excitation = layers.reshape(excitation, [-1, num_channels, 1, 1])
    return layers.elementwise_mul(input, excitation)


def _se_bottleneck(input, ch_in, filters, stride, cardinality=32,
                   is_test=False):
    conv0 = _conv_bn(input, filters, 1, is_test=is_test)
    conv1 = _conv_bn(conv0, filters, 3, stride=stride, groups=cardinality,
                     is_test=is_test)
    conv2 = _conv_bn(conv1, filters * 2, 1, act=None, is_test=is_test)
    scaled = _squeeze_excitation(conv2, filters * 2)
    if ch_in != filters * 2 or stride != 1:
        short = _conv_bn(input, filters * 2, 1, stride=stride, act=None,
                         is_test=is_test)
    else:
        short = input
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext50(input, class_dim=1000, is_test=False):
    """SE-ResNeXt-50 32x4d (ref models se_resnext.py)."""
    y = _conv_bn(input, 64, 7, stride=2, is_test=is_test)
    y = layers.pool2d(y, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    depth = [3, 4, 6, 3]
    filters = [128, 256, 512, 1024]
    ch_in = 64
    for stage, (reps, f) in enumerate(zip(depth, filters)):
        for i in range(reps):
            y = _se_bottleneck(y, ch_in, f, stride=2 if
                               (i == 0 and stage != 0) else 1,
                               is_test=is_test)
            ch_in = f * 2
    pool = layers.pool2d(y, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.5, is_test=is_test)
    return layers.fc(drop, size=class_dim, act="softmax")


_ARCHS = {"mobilenet": mobilenet_v1, "vgg16": vgg_net,
          "se_resnext50": se_resnext50}


def classification_train_program(arch, class_dim=1000,
                                 image_shape=(3, 224, 224),
                                 optimizer_fn=None, is_test=False):
    """(main, startup, feeds, fetches) for any zoo classifier."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", list(image_shape), "float32")
        label = layers.data("label", [1], "int64")
        prob = _ARCHS[arch](img, class_dim=class_dim, is_test=is_test)
        loss = layers.reduce_mean(layers.cross_entropy(prob, label))
        acc = layers.accuracy(prob, label)
        if optimizer_fn is not None:
            optimizer_fn(loss)
    return main, startup, {"image": img, "label": label}, \
        {"loss": loss, "acc": acc}


def synthetic_image_batch(batch, image_shape=(3, 224, 224), class_dim=1000,
                          seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, *image_shape).astype(np.float32),
            "label": rng.randint(0, class_dim, (batch, 1)).astype(np.int64)}
