"""The ops the rest of the model zoo adds (vision classifiers, DCGAN,
YOLOv3), the port against the JAX package: ``cross_entropy``,
``conv2d_transpose``, ``interp_nearest``, ``interp_bilinear``,
``yolo_box``, ``multiclass_nms`` and ``yolov3_loss``.

Each case builds one op through the public ``layers`` API of both
packages (same calls, same unique names) and runs both with
``Executor(CPUPlace())`` on the same seeded numpy feeds (``run_pair``);
gradients are ``gradients`` of sum_i <out_i, cot_i>, the cotangents fed
as data.

Tolerances: f32 on both sides, one op. A convolution's or a resize's
sums differ only in order: rtol 1e-5, atol 2e-5 (a transposed
convolution's filter gradient sums N*H*W products of O(1) terms). The
losses (cross_entropy, yolov3_loss) and yolo_box's exp and sigmoid
differ by a few ulps: rtol 1e-5, atol 1e-5. What only chooses or moves
data is exact: interp_nearest's picks (and so its values), the NMS
outputs (labels, scores, the boxes in every slot, empty ones included,
Index, NmsRoisNum; NMS reads yolo_box-free inputs here, so its inputs
are equal bits), yolov3_loss's ObjectnessMask and GTMatchMask.
"""
import numpy as np
import pytest

from test_torch_ops import _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-5, atol=2e-5)


def _op(p, op_type):
    return [o for o in p.default_main_program().global_block().ops
            if o.type == op_type][-1]


def _var(p, name):
    return p.default_main_program().global_block().var(name)


# ---- cross_entropy ----------------------------------------------------------

@pytest.mark.parametrize("soft", [False, True])
def test_cross_entropy(soft):
    """Probabilities from a softmax (one row with an exact 0, under the
    1e-20 floor); hard labels with ignore_index (-100, and 2 as a set
    ignore), a label out of range (7: NaN) and one in [-C, 0) (wraps);
    soft labels rows of a distribution. Value and gradient to X."""
    n, c = 6, 5
    probs = np.abs(_x((n, c), 1)) + 0.05
    probs /= probs.sum(1, keepdims=True)
    probs[1, 3] = 0.0
    label = np.array([[0], [3], [-100], [7], [-2], [2]], np.int64)
    soft_label = np.abs(_x((n, c), 2))
    soft_label /= soft_label.sum(1, keepdims=True)

    def build(p):
        x = _grad_data(p, "x", (n, c))
        if soft:
            lbl = _data(p, "label", (n, c))
        else:
            lbl = _data(p, "label", (n, 1), "int64")
        y = p.layers.cross_entropy(x, lbl, soft_label=soft,
                                   ignore_index=-100)
        return _with_grads(p, [y], [x])
    feed = dict({"x": probs.astype(np.float32),
                 "label": soft_label.astype(np.float32) if soft else label},
                **_cots(n))
    tout, _, _ = run_pair(build, [feed], tol=TOL)
    if not soft:
        assert np.isnan(tout[0][3, 0]) and tout[0][2, 0] == 0.0
        assert np.isfinite(tout[1][[0, 1, 2, 4, 5]]).all()


# ---- conv2d_transpose -------------------------------------------------------

@pytest.mark.parametrize("stride,padding,output_size,groups,dilation", [
    (2, 1, None, 1, 1),           # DCGAN's 4x4 s2 p1 upsample
    (2, 1, 11, 1, 1),             # output_size one past the derived 10
    (1, 0, None, 2, 1),           # groups
    (2, 2, None, 2, 2),           # groups and dilation
])
def test_conv2d_transpose(stride, padding, output_size, groups, dilation):
    """Output, and the gradients to the input, the filter and the bias."""
    shape = (2, 4, 5, 5)
    k = 4 if padding == 1 else 3

    def build(p):
        x = _grad_data(p, "x", shape)
        y = p.layers.conv2d_transpose(
            x, 6, output_size=output_size, filter_size=k, padding=padding,
            stride=stride, dilation=dilation, groups=groups)
        op = _op(p, "conv2d_transpose")
        bias = _op(p, "elementwise_add").input("Y")[0]
        return _with_grads(p, [y], [x, _var(p, op.input("Filter")[0]),
                                    _var(p, bias)])
    derived = (5 - 1) * stride - 2 * padding + dilation * (k - 1) + 1
    side = output_size or derived
    tout, _, _ = run_pair(build, [dict({"x": _x(shape)},
                                       **_cots(2 * 6 * side * side))],
                          tol=CONV_TOL)
    assert tout[0].shape == (2, 6, side, side)


# ---- interp_nearest / interp_bilinear ---------------------------------------

@pytest.mark.parametrize("resample,align_corners,align_mode,hw,out", [
    ("NEAREST", True, 1, (19, 19), (38, 38)),    # YOLOv3's FPN upsample
    ("NEAREST", False, 1, (19, 7), (38, 15)),
    ("NEAREST", True, 1, (6, 5), (3, 4)),        # a downsample
    ("BILINEAR", True, 1, (19, 7), (38, 15)),
    ("BILINEAR", False, 0, (19, 7), (38, 15)),   # half-pixel centres
    ("BILINEAR", False, 1, (5, 6), (9, 3)),
])
def test_interp(resample, align_corners, align_mode, hw, out):
    """Values and the gradient to X. Nearest picks the JAX package's
    source indices exactly (ratio * dst + 0.5 lands on .5 at 19 -> 38),
    so its value is exact; bilinear blends in f32."""
    shape = (2, 3) + hw

    def build(p):
        x = _grad_data(p, "x", shape)
        y = p.layers.image_resize(x, out_shape=list(out), resample=resample,
                                  align_corners=align_corners,
                                  align_mode=align_mode)
        return _with_grads(p, [y], [x])
    feed = dict({"x": _x(shape)}, **_cots(2 * 3 * out[0] * out[1]))
    tout, _, _ = run_pair(build, [feed], tol=TOL)
    if resample == "NEAREST":
        run_pair(lambda p: [p.layers.resize_nearest(
            _data(p, "x", shape), out_shape=list(out),
            align_corners=align_corners)], [{"x": feed["x"]}], exact=True)


# ---- yolo_box ---------------------------------------------------------------

def test_yolo_box():
    """Boxes and scores of a 3-anchor head, some predictions under the
    confidence threshold (zeros), images of two sizes."""
    anchors = [10, 13, 16, 30, 33, 23]
    c = 4
    shape = (2, 3 * (5 + c), 5, 6)
    x = _x(shape, 3) * 2.0

    def build(p):
        b, s = p.layers.yolo_box(
            _data(p, "x", shape), _data(p, "im", (2, 2), "int32"),
            anchors=anchors, class_num=c, conf_thresh=0.3,
            downsample_ratio=16)
        return [b, s]
    tout, _, _ = run_pair(build, [{"x": x, "im": np.array(
        [[80, 96], [60, 50]], np.int32)}], tol=TOL)
    assert (tout[1] == 0).any() and (tout[1] > 0).any()


# ---- multiclass_nms ---------------------------------------------------------

def _nms_inputs(n=2, c=4, m=16, seed=0):
    """Boxes with duplicates and heavy overlaps; scores on a 1/8 grid, so
    many tie, some exact zeros."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 8, (n, m, 2))
    wh = rng.uniform(1, 4, (n, m, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[:, 5] = boxes[:, 2]
    boxes[:, 9] = boxes[:, 2] + 0.25
    scores = np.floor(rng.uniform(0, 8, (n, c, m))) / 8.0
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.1, nms_top_k=10, keep_top_k=12,
         nms_threshold=0.3, background_label=0),
    dict(score_threshold=0.0, nms_top_k=-1, keep_top_k=-1,
         nms_threshold=0.4, background_label=-1),
    dict(score_threshold=0.05, nms_top_k=12, keep_top_k=20,
         nms_threshold=0.7, background_label=2, nms_eta=0.8),
    dict(score_threshold=0.2, nms_top_k=16, keep_top_k=8,
         nms_threshold=0.5, background_label=-1, normalized=False),
])
def test_multiclass_nms(kw):
    """Out (labels, scores, the boxes of every slot, empty ones too),
    Index and NmsRoisNum exactly, through ties (scores on a 1/8 grid),
    an adaptive threshold (nms_eta < 1), a background class, keep_top_k
    -1 and unnormalized boxes."""
    boxes, scores = _nms_inputs()

    def build(p):
        out, index = p.layers.multiclass_nms(
            _data(p, "b", boxes.shape), _data(p, "s", scores.shape),
            return_index=True, **kw)
        nums = _var(p, _op(p, "multiclass_nms").output("NmsRoisNum")[0])
        return [out, index, nums]
    tout, _, _ = run_pair(build, [{"b": boxes, "s": scores}], exact=True)
    if kw["keep_top_k"] < 0:                # room for every candidate
        assert (tout[0][..., 0] == -1).any()
    assert (tout[2] > 0).all()


@pytest.mark.parametrize("keep", [5, 40])
def test_static_nms(keep):
    """The single-class static NMS (no layer emits it; appended as the op):
    the kept boxes, their scores (0 in suppressed slots) and Index,
    exactly, through tied scores; keep 40 caps at M."""
    boxes, scores = _nms_inputs(n=1, c=1, m=16, seed=3)

    def build(p):
        helper = p.layer_helper.LayerHelper("static_nms")
        b = _data(p, "b", (16, 4))
        sc = _data(p, "s", (16,))
        outs = [helper.create_variable_for_type_inference(d)
                for d in ("float32", "float32", "int64")]
        helper.append_op("static_nms", inputs={"Boxes": [b.name],
                                               "Scores": [sc.name]},
                         outputs={"Out": [outs[0].name],
                                  "Scores": [outs[1].name],
                                  "Index": [outs[2].name]},
                         attrs={"keep_top_k": keep, "nms_threshold": 0.3})
        return outs
    run_pair(build, [{"b": boxes[0], "s": scores[0, 0]}], exact=True)


# ---- yolov3_loss ------------------------------------------------------------

@pytest.mark.parametrize("gt_score,smooth,mask", [
    (False, True, [0, 1, 2]),
    (True, False, [1, 2]),          # gts whose best anchor is off the mask
])
def test_yolov3_loss(gt_score, smooth, mask):
    """Loss and its gradient to X, ObjectnessMask and GTMatchMask exactly:
    two gts in one cell with one anchor (the later wins the objectness
    target), zero-padded gts, a gt at the image's edge."""
    anchors = [10, 13, 16, 30, 33, 23]
    c, h, w, b = 3, 4, 4, 6
    shape = (2, len(mask) * (5 + c), h, w)
    gt = np.zeros((2, b, 4), np.float32)
    gt[0, :4] = [[0.30, 0.30, 0.40, 0.50], [0.32, 0.33, 0.41, 0.52],
                 [0.80, 0.20, 0.10, 0.15], [0.999, 0.999, 0.30, 0.30]]
    gt[1, :3] = [[0.55, 0.60, 0.70, 0.80], [0.10, 0.90, 0.05, 0.06],
                 [0.56, 0.62, 0.72, 0.79]]
    label = np.array([[0, 2, 1, 1, 0, 0], [2, 0, 1, 0, 0, 0]], np.int32)
    score = np.random.RandomState(5).uniform(0.5, 1.0, (2, b)).astype(
        np.float32)

    def build(p):
        x = _grad_data(p, "x", shape)
        kwargs = dict(anchors=anchors, anchor_mask=mask, class_num=c,
                      ignore_thresh=0.5, downsample_ratio=8,
                      use_label_smooth=smooth)
        if gt_score:
            kwargs["gt_score"] = _data(p, "score", (2, b))
        loss = p.layers.yolov3_loss(x, _data(p, "gt", (2, b, 4)),
                                    _data(p, "label", (2, b), "int32"),
                                    **kwargs)
        op = _op(p, "yolov3_loss")
        return _with_grads(p, [loss], [x]) + [
            _var(p, op.output("ObjectnessMask")[0]),
            _var(p, op.output("GTMatchMask")[0])]
    feed = dict({"x": _x(shape, 7), "gt": gt, "label": label,
                 "score": score}, **_cots(2))
    if not gt_score:
        feed.pop("score")
    tout, _, _ = run_pair(build, [feed], tol=TOL)
    # exact: the masks only choose
    run_pair(lambda p: build(p)[2:], [feed], exact=True)
    objness, match = tout[2], tout[3]
    assert (objness > 0).any()
    assert (match[0, 4:] == -1).all() and (match[1, 3:] == -1).all()
