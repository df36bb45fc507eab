"""YOLOv3 object detection (counterpart of paddle_tpu/models/yolov3.py;
reference PaddlePaddle/models yolov3 with the fluid detection ops).

A darknet-style backbone with the standard 3-scale YOLOv3 heads, built
from the port's layers: training sums ``yolov3_loss`` over the scales;
inference decodes with ``yolo_box`` and keeps a fixed-capacity
``multiclass_nms``. ``tiny=True`` shrinks channels and depth for tests
while keeping every op of the full model.
"""
import numpy as np

from .. import layers
from ..framework.program import Program, program_guard

__all__ = ["yolov3_body", "yolov3_train_program", "yolov3_infer_program",
           "synthetic_detection_batch", "YOLO_ANCHORS"]

YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


def _conv_bn(x, ch, ksize, stride=1, is_test=False):
    y = layers.conv2d(x, num_filters=ch, filter_size=ksize, stride=stride,
                      padding=(ksize - 1) // 2, bias_attr=False)
    return layers.batch_norm(y, act=None, is_test=is_test)


def _dark_block(x, ch, is_test=False):
    y = layers.leaky_relu(_conv_bn(x, ch, 1, is_test=is_test), alpha=0.1)
    y = layers.leaky_relu(_conv_bn(y, ch * 2, 3, is_test=is_test),
                          alpha=0.1)
    return layers.elementwise_add(x, y)


def yolov3_body(image, class_num=80, tiny=True, is_test=False):
    """Backbone + 3 detection heads.  Returns the list of raw head
    tensors (N, mask*(5+classes), H_s, W_s) for downsample 32/16/8."""
    w = 8 if tiny else 32
    depths = [1, 1, 2] if tiny else [1, 2, 8]
    y = layers.leaky_relu(_conv_bn(image, w, 3, is_test=is_test), 0.1)
    routes = []
    for stage, reps in enumerate(depths):
        y = layers.leaky_relu(
            _conv_bn(y, w * 2 ** (stage + 1), 3, stride=2,
                     is_test=is_test), 0.1)
        for _ in range(reps):
            y = _dark_block(y, w * 2 ** stage, is_test=is_test)
        routes.append(y)
    # two more downsamples to reach stride 32
    for extra in range(2):
        y = layers.leaky_relu(
            _conv_bn(y, w * 2 ** (4 + extra), 3, stride=2,
                     is_test=is_test), 0.1)
        routes.append(y)
    heads = []
    # heads at stride 32, 16, 8 with top-down feature reuse
    if image.shape[2] % 32 or image.shape[3] % 32:
        raise ValueError(
            "yolov3_body needs the image size divisible by 32 so the "
            "top-down FPN upsample aligns across strides; got %r" %
            (tuple(image.shape[2:]),))
    route = None
    for i, feat in enumerate(routes[::-1][:3]):
        if route is not None:
            route = layers.resize_nearest(route, scale=2.0)
            if route.shape[2] != feat.shape[2]:
                raise ValueError(
                    "FPN shape mismatch: upsampled route %r vs feature "
                    "%r" % (tuple(route.shape), tuple(feat.shape)))
            feat = layers.concat([route, feat], axis=1)
        ch = feat.shape[1]
        tip = layers.leaky_relu(_conv_bn(feat, ch, 3, is_test=is_test),
                                0.1)
        n_mask = len(YOLO_ANCHOR_MASKS[i])
        head = layers.conv2d(tip, num_filters=n_mask * (5 + class_num),
                             filter_size=1)
        heads.append(head)
        route = tip
    return heads


def yolov3_train_program(class_num=4, image_size=96, max_box=10,
                         tiny=True, optimizer_fn=None):
    """(main, startup, feeds, fetches): summed 3-scale yolov3_loss."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [3, image_size, image_size], "float32")
        gt_box = layers.data("gt_box", [max_box, 4], "float32")
        gt_label = layers.data("gt_label", [max_box], "int32")
        heads = yolov3_body(img, class_num=class_num, tiny=tiny)
        losses = []
        for head, mask, down in zip(heads, YOLO_ANCHOR_MASKS, [32, 16, 8]):
            l = layers.yolov3_loss(
                head, gt_box, gt_label, anchors=YOLO_ANCHORS,
                anchor_mask=mask, class_num=class_num, ignore_thresh=0.7,
                downsample_ratio=down, use_label_smooth=False)
            losses.append(layers.reduce_mean(l))
        loss = losses[0]
        for l in losses[1:]:
            loss = layers.elementwise_add(loss, l)
        if optimizer_fn is not None:
            optimizer_fn(loss)
    return main, startup, \
        {"image": img, "gt_box": gt_box, "gt_label": gt_label}, \
        {"loss": loss}


def yolov3_infer_program(class_num=4, image_size=96, tiny=True,
                         conf_thresh=0.01, nms_topk=100, keep_topk=50,
                         nms_thresh=0.45):
    """(main, startup, feeds, fetches): yolo_box per scale + NMS."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("image", [3, image_size, image_size], "float32")
        im_size = layers.data("im_size", [2], "int32")
        heads = yolov3_body(img, class_num=class_num, tiny=tiny,
                            is_test=True)
        boxes, scores = [], []
        for head, mask, down in zip(heads, YOLO_ANCHOR_MASKS, [32, 16, 8]):
            anchors = []
            for m in mask:
                anchors.extend(YOLO_ANCHORS[2 * m:2 * m + 2])
            b, s = layers.yolo_box(head, im_size, anchors=anchors,
                                   class_num=class_num,
                                   conf_thresh=conf_thresh,
                                   downsample_ratio=down)
            boxes.append(b)
            scores.append(layers.transpose(s, perm=[0, 2, 1]))
        all_boxes = layers.concat(boxes, axis=1)
        all_scores = layers.concat(scores, axis=2)
        pred = layers.multiclass_nms(
            all_boxes, all_scores, score_threshold=conf_thresh,
            nms_top_k=nms_topk, keep_top_k=keep_topk,
            nms_threshold=nms_thresh, background_label=-1)
    return main, startup, {"image": img, "im_size": im_size}, \
        {"pred": pred}


def synthetic_detection_batch(batch, image_size=96, max_box=10,
                              class_num=4, seed=0):
    rng = np.random.RandomState(seed)
    # normalized xywh gt boxes, zero-padded rows past the true count
    boxes = np.zeros((batch, max_box, 4), np.float32)
    labels = np.zeros((batch, max_box), np.int32)
    for b in range(batch):
        n = rng.randint(1, max_box // 2)
        cx, cy = rng.uniform(0.2, 0.8, (2, n))
        w, h = rng.uniform(0.05, 0.3, (2, n))
        boxes[b, :n] = np.stack([cx, cy, w, h], axis=1)
        labels[b, :n] = rng.randint(0, class_num, n)
    return {"image": rng.rand(batch, 3, image_size,
                              image_size).astype(np.float32),
            "gt_box": boxes, "gt_label": labels}
