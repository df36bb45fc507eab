"""ResNet image classification (static graph), the counterpart of
paddle_tpu/models/resnet.py: NCHW, bottleneck (depth >= 50) or basic
blocks, batch norm with moving stats, a 1000-class fc head; the same
parameter names (``res2a_branch2a_weights``, ``conv1_bn_mean``,
``fc_0.w_0`` ...), so weights cross between the packages by name."""
import math

from .. import layers
from ..framework.program import Program, program_guard
from ..initializer import UniformInitializer
from ..param_attr import ParamAttr


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False):
    conv = layers.conv2d(input, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         param_attr=ParamAttr(name=name + "_weights"),
                         bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             param_attr=ParamAttr(name=name + "_bn_scale"),
                             bias_attr=ParamAttr(name=name + "_bn_offset"),
                             moving_mean_name=name + "_bn_mean",
                             moving_variance_name=name + "_bn_variance")


def shortcut(input, ch_out, stride, name, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2b", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1,
                          name=name + "_branch2c", is_test=is_test)
    short = shortcut(input, num_filters * 4, stride, name + "_branch1",
                     is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          name=name + "_branch2a", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3,
                          name=name + "_branch2b", is_test=is_test)
    short = shortcut(input, num_filters, stride, name + "_branch1",
                     is_test=is_test)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH_CFG = {
    18: (basic_block, [2, 2, 2, 2]),
    34: (basic_block, [3, 4, 6, 3]),
    50: (bottleneck_block, [3, 4, 6, 3]),
    101: (bottleneck_block, [3, 4, 23, 3]),
    152: (bottleneck_block, [3, 8, 36, 3]),
}


def resnet(input, class_dim=1000, depth=50, is_test=False):
    """Logits (N, class_dim) of a ResNet of ``depth`` over NCHW images."""
    block_fn, counts = _DEPTH_CFG[depth]
    x = conv_bn_layer(input, 64, 7, stride=2, act="relu", name="conv1",
                      is_test=is_test)
    x = layers.pool2d(x, 3, "max", 2, 1)
    for b, (nf, cnt) in enumerate(zip([64, 128, 256, 512], counts)):
        for i in range(cnt):
            stride = 2 if i == 0 and b != 0 else 1
            x = block_fn(x, nf, stride, "res%d%c" % (b + 2, ord("a") + i),
                         is_test=is_test)
    pool = layers.pool2d(x, global_pooling=True, pool_type="avg")
    pool = layers.reshape(pool, [0, pool.shape[1]])
    stdv = 1.0 / math.sqrt(pool.shape[1])
    return layers.fc(pool, class_dim,
                     param_attr=ParamAttr(
                         name="fc_0.w_0",
                         initializer=UniformInitializer(-stdv, stdv)),
                     bias_attr=ParamAttr(name="fc_0.b_0"))


def resnet_train_program(depth=50, class_dim=1000, image_shape=(3, 224, 224),
                         optimizer_fn=None, is_test=False):
    """(main, startup, feed names, {"loss", "acc1", "acc5"}): softmax CE
    of ``resnet``'s logits against int64 labels, top-1 and top-5
    accuracy; ``optimizer_fn(loss)`` appends the update."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        image = layers.data("image", list(image_shape), dtype="float32")
        label = layers.data("label", [1], dtype="int64")
        logits = resnet(image, class_dim, depth, is_test=is_test)
        loss, softmax = layers.softmax_with_cross_entropy(
            logits, label, return_softmax=True)
        loss = layers.mean(loss)
        acc1 = layers.accuracy(softmax, label, k=1)
        acc5 = layers.accuracy(softmax, label, k=min(5, class_dim))
        if optimizer_fn is not None:
            optimizer_fn(loss)
    return main, startup, ["image", "label"], {"loss": loss, "acc1": acc1,
                                               "acc5": acc5}
