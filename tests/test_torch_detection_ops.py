"""The 25 detection op types, the port against the JAX package
(paddle_tpu/ops/detection_ops.py, detection_train_ops.py): each registry
kernel's outputs, and the input gradients of roi_align, roi_pool,
sigmoid_focal_loss, ssd_loss, box_clip and roi_perspective_transform
against ``jax.vjp`` (op_library_helpers.compare: f32 rtol 1e-5 and atol
1e-5 unless a case states its bound; what only moves or chooses data,
indices, labels and masks, exactly).

Pinned: roi_pool's ties and overlapping bins (its gradient split among
tied maxima at each stage), retinanet_target_assign's duplicate write
(the last gt sharing a best anchor wins, as XLA's scatter on the CPU),
the ranks of mine_hard_examples and ssd_loss (a stable ascending sort of
-x: ties, -inf and -0.0), the step-key rule of the two sampling ops,
the sampling invariants (Philox cannot match threefry), the eliminating
solve of roi_perspective_transform, and a NaN in bipartite_match.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from op_library_helpers import (TorchCtx, check, compare, f32,
                                registry_flags_match)
from paddle_tpu.ops import detection_train_ops as jtrain
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops import detection_train_ops as ttrain
from paddle_tpu_torch.ops.registry import get_op as tget

DETECTION_OPS = (
    "prior_box", "iou_similarity", "box_coder", "anchor_generator",
    "density_prior_box", "box_clip", "bipartite_match", "target_assign",
    "sigmoid_focal_loss", "polygon_box_transform", "roi_align", "roi_pool",
    "box_decoder_and_assign", "generate_proposals",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "mine_hard_examples", "ssd_loss")
TRAIN_OPS = ("rpn_target_assign", "retinanet_target_assign",
             "generate_proposal_labels", "locality_aware_nms",
             "retinanet_detection_output", "roi_perspective_transform",
             "generate_mask_labels")
EXACT = dict(rtol=0, atol=0)


def _r(seed=0):
    return np.random.RandomState(seed)


class _JaxCtx(object):
    """The JAX package's trace context for a kernel called alone: a fixed
    key for ``ctx.rng()``."""

    def rng(self):
        return jax.random.PRNGKey(0)


def _compare(op, ins, attrs, **kw):
    """op_library_helpers.compare with the JAX kernel under ``jax.jit``."""
    return compare(op, ins, attrs, jit=True, jax_ctx=_JaxCtx(), **kw)


def _run_both(op, ins, attrs, seed=0):
    """Both packages' kernels of ``op`` on the numpy ``ins`` (no
    gradient; the JAX kernel under ``jax.jit``); returns ({slot: [port numpy]}, {slot: [jax numpy]})."""
    raw = jget(op).fn
    jout = jax.jit(lambda cur: raw(_JaxCtx(), cur, attrs))(
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()})
    tout = tget(op).fn(TorchCtx(seed), {
        k: [torch.from_numpy(np.array(v)) for v in vs]
        for k, vs in ins.items()}, attrs)

    def lists(d, conv):
        return {k: [conv(x) for x in (v if isinstance(v, (list, tuple))
                                      else [v])] for k, v in d.items()}
    return lists(tout, lambda t: t.detach().numpy()), \
        lists(jout, np.asarray)


def _boxes(rng, n, size, lo=4.0, hi=None, integer=False):
    """n xyxy boxes inside [0, size)."""
    hi = hi or size / 2
    x1 = rng.uniform(0, size * 0.7, n)
    y1 = rng.uniform(0, size * 0.7, n)
    b = np.stack([x1, y1, np.minimum(x1 + rng.uniform(lo, hi, n), size - 1),
                  np.minimum(y1 + rng.uniform(lo, hi, n), size - 1)], 1)
    return (np.round(b) if integer else b).astype(np.float32)


def test_registry_flags_match():
    assert len(set(DETECTION_OPS + TRAIN_OPS)) == 25
    registry_flags_match(DETECTION_OPS + TRAIN_OPS)


# ---- prior and anchor grids (numpy in both packages: exact) ---------------

@pytest.mark.parametrize("attrs", [
    dict(min_sizes=[60.0], max_sizes=[150.0], aspect_ratios=[2.0, 3.0],
         flip=True, clip=True, offset=0.5),
    dict(min_sizes=[30.0, 45.0], max_sizes=[60.0, 90.0],
         aspect_ratios=[2.0], flip=False, clip=False, step_w=16.0,
         step_h=12.0, variances=[0.1, 0.1, 0.2, 0.2], offset=0.25),
    dict(min_sizes=[285.0], aspect_ratios=[1.0, 2.0], flip=True),
])
def test_prior_box(attrs):
    ins = {"Input": [f32(_r(), 2, 4, 5, 7)],
           "Image": [f32(_r(), 2, 3, 300, 300)]}
    _compare("prior_box", ins, attrs, tol=EXACT)


@pytest.mark.parametrize("attrs", [
    dict(densities=[4, 2, 1], fixed_sizes=[32.0, 64.0, 128.0],
         fixed_ratios=[1.0], clip=False),
    dict(densities=[2, 1], fixed_sizes=[16.0, 40.0],
         fixed_ratios=[1.0, 2.0], clip=True, flatten_to_2d=True,
         step_w=8.0, step_h=8.0),
])
def test_density_prior_box(attrs):
    ins = {"Input": [f32(_r(), 1, 4, 6, 5)],
           "Image": [f32(_r(), 1, 3, 64, 48)]}
    _compare("density_prior_box", ins, attrs, tol=EXACT)


@pytest.mark.parametrize("attrs", [
    dict(anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
         aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0]),
    dict(anchor_sizes=[24.0], aspect_ratios=[1.0, 3.0], stride=[8.0, 12.0],
         offset=0.0, variances=[1.0, 1.0, 1.0, 1.0]),
])
def test_anchor_generator(attrs):
    _compare("anchor_generator", {"Input": [f32(_r(), 1, 2, 5, 8)]}, attrs,
            tol=EXACT)


# ---- box arithmetic --------------------------------------------------------

def test_iou_similarity():
    rng = _r(1)
    x = _boxes(rng, 9, 50)
    y = np.concatenate([_boxes(rng, 6, 50), x[:2],
                        np.zeros((1, 4), np.float32)])
    _compare("iou_similarity", {"X": [x], "Y": [y]}, {})


@pytest.mark.parametrize("var", [True, False])
def test_box_coder_encode_and_decode(var):
    rng = _r(2)
    prior = _boxes(rng, 12, 1.0, lo=0.05, hi=0.4)
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (12, 1))
    ins = {"PriorBox": [prior], "TargetBox": [_boxes(rng, 5, 1.0, 0.05)]}
    if var:
        ins["PriorBoxVar"] = [pvar]
    _compare("box_coder", ins, {"code_type": "encode_center_size"})
    ins["TargetBox"] = [f32(rng, 3, 12, 4)]
    _compare("box_coder", ins, {"code_type": "decode_center_size"})


def test_box_clip_gradient_splits_on_a_bound():
    rng = _r(3)
    boxes = rng.uniform(-10, 60, (2, 7, 4)).astype(np.float32)
    im_info = np.float32([[40, 50, 1.0], [60, 30, 2.0]])
    boxes[0, 0] = [0.0, 0.0, 49.0, 39.0]          # exactly on the bounds
    boxes[1, 1] = [14.0, 29.0, -3.0, 0.0]
    _compare("box_clip", {"Input": [boxes], "ImInfo": [im_info]}, {},
            diff=[("Input", 0)])
    _compare("box_clip", {"Input": [boxes[0]], "ImInfo": [im_info[:1]]}, {},
            diff=[("Input", 0)])


def test_polygon_box_transform():
    _compare("polygon_box_transform",
            {"Input": [f32(_r(4), 2, 8, 5, 6)]}, {})


def test_box_decoder_and_assign():
    rng = _r(5)
    prior = _boxes(rng, 10, 200)
    ins = {"PriorBox": [prior], "PriorBoxVar": [np.float32([0.1, 0.1, 0.2,
                                                             0.2])],
           "TargetBox": [f32(rng, 10, 4 * 5)],
           "BoxScore": [rng.uniform(0, 1, (10, 5)).astype(np.float32)]}
    ins["BoxScore"][0][3, 1:] = 0.5                     # a tie: class 1
    ins["TargetBox"][0][2, 2] = 30.0                    # past box_clip
    _compare("box_decoder_and_assign", ins, {"box_clip": 4.135})
    ins["PriorBoxVar"] = [np.tile(ins["PriorBoxVar"][0], (10, 1))]
    _compare("box_decoder_and_assign", ins, {"box_clip": 1.0})


# ---- matching and targets -------------------------------------------------

@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    rng = _r(6)
    dist = rng.uniform(0, 1, (3, 4, 9)).astype(np.float32)
    dist[0, :, 2] = 0.0                                 # an empty column
    dist[1, 1, :] = dist[1, 2, :]                       # tied rows
    dist[2] = np.round(dist[2] * 4) / 4                 # many ties
    attrs = {"match_type": match_type, "dist_threshold": 0.3}
    _compare("bipartite_match", {"DistMat": [dist]}, attrs,
            exact=("ColToRowMatchIndices", "ColToRowMatchDist"))
    _compare("bipartite_match", {"DistMat": [dist[0]]}, attrs,
            exact=("ColToRowMatchIndices", "ColToRowMatchDist"))


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_nan_stops_the_matching(match_type):
    """An unused NaN is every step's arg-max (``jnp.argmax`` and
    ``torch.argmax`` both put NaN first) and never passes ``> 1e-6``: the
    matching stops there in both packages."""
    dist = _r(7).uniform(0, 1, (2, 3, 5)).astype(np.float32)
    dist[0, 1, 3] = np.nan
    got, want = _compare("bipartite_match", {"DistMat": [dist]},
                        {"match_type": match_type, "dist_threshold": 0.2},
                        exact=("ColToRowMatchIndices", "ColToRowMatchDist"))
    idx = got["ColToRowMatchIndices"][0]
    if match_type == "bipartite":
        assert (idx[0] < 0).all() and (idx[1] >= 0).sum() == 3
    else:                       # the NaN column's best is NaN: unmatched
        assert idx[0, 3] == -1


@pytest.mark.parametrize("neg", [False, True])
def test_target_assign(neg):
    rng = _r(8)
    ins = {"X": [f32(rng, 2, 5, 4)],
           "MatchIndices": [rng.randint(-1, 5, (2, 7)).astype(np.int32)]}
    if neg:
        ins["NegIndices"] = [rng.randint(0, 2, (2, 7, 1)).astype(np.int32)]
    _compare("target_assign", ins, {"mismatch_value": -2.0},
            exact=("Out", "OutWeight"))


def test_sigmoid_focal_loss():
    rng = _r(9)
    x = f32(rng, 12, 6) * 3
    x[0, :3] = [0.0, -0.0, 40.0]
    label = rng.randint(-1, 7, (12, 1)).astype(np.int32)
    for fg in (np.int32([5]), np.int32([0])):
        _compare("sigmoid_focal_loss",
                {"X": [x], "Label": [label], "FgNum": [fg]},
                {"gamma": 2.0, "alpha": 0.25}, diff=[("X", 0)])
    _compare("sigmoid_focal_loss",
            {"X": [x], "Label": [label], "FgNum": [np.int32([3])]},
            {"gamma": 1.5, "alpha": 0.4}, diff=[("X", 0)])


@pytest.mark.parametrize("mining", ["max_negative", "hard_example"])
def test_mine_hard_examples_ranks_as_argsort_of_minus(mining):
    """Ties, -inf and -0.0 among the negatives' losses: the rank is the
    position in a stable ascending sort of -loss, as ``jnp.argsort``."""
    rng = _r(10)
    cls = np.round(rng.uniform(0, 3, (3, 16)) * 2).astype(np.float32) / 2
    cls[0, :4] = [0.0, -0.0, 0.0, -0.0]
    cls[1, 3] = -np.inf
    match = rng.randint(-1, 3, (3, 16)).astype(np.int32)
    match[:, ::5] = -1
    match[2] = -1                                     # no positive
    ins = {"ClsLoss": [cls], "MatchIndices": [match],
           "LocLoss": [np.round(f32(rng, 3, 16)).astype(np.float32)],
           "MatchDist": [rng.uniform(0, 1, (3, 16)).astype(np.float32)]}
    _compare("mine_hard_examples", ins,
            {"neg_pos_ratio": 1.5, "neg_dist_threshold": 0.7,
             "mining_type": mining, "sample_size": 3},
            exact=("NegIndices", "UpdatedMatchIndices"))


def _ssd_inputs(rng, n=3, g=4, p=40, c=5):
    prior = _boxes(rng, p, 1.0, lo=0.05, hi=0.5)
    gt = np.zeros((n, g, 4), np.float32)
    gt[0, :3] = prior[[1, 7, 20]] + 0.01
    gt[1, :2] = _boxes(rng, 2, 1.0, lo=0.1, hi=0.5)
    gt[2, :4] = _boxes(rng, 4, 1.0, lo=0.1, hi=0.6)
    return {"Location": [f32(rng, n, p, 4)],
            "Confidence": [np.round(f32(rng, n, p, c) * 2) / 2],
            "GtBox": [gt],
            "GtLabel": [rng.randint(1, c, (n, g, 1)).astype(np.int32)],
            "PriorBox": [prior],
            "PriorBoxVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                    (p, 1))]}


@pytest.mark.parametrize("attrs", [
    {},
    dict(match_type="bipartite", mining_type="hard_example", sample_size=6,
         normalize=False, loc_loss_weight=2.0, neg_pos_ratio=2.0),
    dict(overlap_threshold=0.3, neg_overlap=0.4, background_label=2),
])
def test_ssd_loss(attrs):
    """Confidences on a half grid: CE ties among negatives, ranked as
    ``argsort(-ce)``."""
    ins = _ssd_inputs(_r(11))
    _compare("ssd_loss", ins, attrs,
            diff=[("Location", 0), ("Confidence", 0)])
    ins.pop("PriorBoxVar")
    _compare("ssd_loss", ins, attrs,
            diff=[("Location", 0), ("Confidence", 0)])


# ---- RoI pooling -----------------------------------------------------------

def _rois(rng, r, h, w, scale):
    b = _boxes(rng, r, min(h, w) / scale)
    b[0] = [-20, -20, 30, 12]                           # off the map
    b[1] = [5, 5, 5.5, 5.2]                             # under a pixel
    return b


@pytest.mark.parametrize("attrs,nums", [
    (dict(pooled_height=3, pooled_width=2, spatial_scale=0.25,
          sampling_ratio=-1), None),
    (dict(pooled_height=2, pooled_width=3, spatial_scale=0.5,
          sampling_ratio=3), [3, 4]),
    (dict(pooled_height=7, pooled_width=7, spatial_scale=1 / 16.0,
          sampling_ratio=3), [3, 4]),
])
def test_roi_align(attrs, nums):
    rng = _r(12)
    x = f32(rng, 2, 3, 9, 11)
    ins = {"X": [x], "ROIs": [_rois(rng, 7, 9, 11, attrs["spatial_scale"])]}
    if nums:
        ins["RoisNum"] = [np.int32(nums)]
    _compare("roi_align", ins, attrs, diff=[("X", 0)])


@pytest.mark.parametrize("attrs,nums", [
    (dict(pooled_height=3, pooled_width=3, spatial_scale=0.5), [2, 4]),
    (dict(pooled_height=4, pooled_width=2, spatial_scale=1.0), None),
    (dict(pooled_height=7, pooled_width=7, spatial_scale=1.0), [3, 3]),
])
def test_roi_pool_ties_and_overlapping_bins(attrs, nums):
    """Integer-valued maps in {0, 1, 2}: most bins hold tied maxima and
    neighbouring bins share a row or column (floor/ceil edges); the
    gradient is split equally among the tied elements at each of the two
    stages, as ``jnp.max``'s; empty bins (RoIs off the map) give 0."""
    rng = _r(13)
    x = rng.randint(0, 3, (2, 2, 8, 10)).astype(np.float32)
    rois = _rois(rng, 6, 8, 10, attrs["spatial_scale"])
    rois[2] = [40, 40, 60, 60]                          # all bins empty
    ins = {"X": [x], "ROIs": [rois]}
    if nums:
        ins["RoisNum"] = [np.int32(nums)]
    got, _ = _compare("roi_pool", ins, attrs, diff=[("X", 0)])
    assert (got["Out"][0][2] == 0).all()


# ---- proposals ------------------------------------------------------------

def _rpn_inputs(rng, n=2, a=3, h=6, w=7, stride=8.0):
    anchors = np.zeros((h, w, a, 4), np.float32)
    cx = (np.arange(w) + 0.5) * stride
    cy = (np.arange(h) + 0.5) * stride
    for k, s in enumerate((12.0, 20.0, 30.0)[:a]):
        anchors[..., k, 0] = cx[None, :] - s
        anchors[..., k, 1] = cy[:, None] - s * 0.7
        anchors[..., k, 2] = cx[None, :] + s
        anchors[..., k, 3] = cy[:, None] + s * 0.7
    return {"Scores": [rng.uniform(0, 1, (n, a, h, w)).astype(np.float32)],
            "BboxDeltas": [f32(rng, n, a * 4, h, w) * 0.5],
            "ImInfo": [np.float32([[h * stride, w * stride, 1.0],
                                   [h * stride - 9, w * stride, 2.0]])[:n]],
            "Anchors": [anchors],
            "Variances": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                  (h, w, a, 1))]}


@pytest.mark.parametrize("attrs", [
    dict(pre_nms_topN=60, post_nms_topN=25, nms_thresh=0.5, min_size=2.0),
    dict(pre_nms_topN=500, post_nms_topN=300, nms_thresh=0.7, min_size=0.1,
         eta=0.9),
])
def test_generate_proposals(attrs):
    _compare("generate_proposals", _rpn_inputs(_r(14)), attrs,
            exact=("RpnRoisNum",))


def test_distribute_and_collect_fpn_proposals():
    rng = _r(15)
    rois = np.concatenate([_boxes(rng, 10, 400, lo=8, hi=40),
                           _boxes(rng, 10, 800, lo=60, hi=500)])[
        rng.permutation(20)]
    attrs = dict(min_level=2, max_level=5, refer_level=4, refer_scale=224)
    for nums in (None, np.int32([15])):
        ins = {"FpnRois": [rois]}
        if nums is not None:
            ins["RoisNum"] = [nums]
        _compare("distribute_fpn_proposals", ins, attrs,
                exact=("MultiFpnRois", "RestoreIndex", "MultiLevelRoIsNum"))
    multi = [_boxes(rng, k, 300) for k in (6, 5, 4)]
    scores = [rng.uniform(0, 1, (k, 1)).astype(np.float32) for k in (6, 5,
                                                                        4)]
    scores[1][2] = scores[0][0]                        # a tie across levels
    ins = {"MultiLevelRois": multi, "MultiLevelScores": scores}
    _compare("collect_fpn_proposals", ins, {"post_nms_topN": 9},
            exact=("FpnRois", "RoisNum"))
    ins["MultiLevelRoisNum"] = [np.int32([4]), np.int32([5]), np.int32([0])]
    _compare("collect_fpn_proposals", ins, {"post_nms_topN": 12},
            exact=("FpnRois", "RoisNum"))


# ---- the training-side ops ---------------------------------------------------

def _gt_batch(rng, b, g, size, valid):
    gt = np.zeros((b, g, 4), np.float32)
    for i, k in enumerate(valid):
        gt[i, :k] = _boxes(rng, k, size, lo=10, hi=size / 2)
    return gt


@pytest.mark.parametrize("crowd,im_info,straddle", [
    (False, False, 0.0), (True, True, 0.0), (False, True, -1.0)])
def test_rpn_target_assign_first_picks(crowd, im_info, straddle):
    """use_random=False: the first fg / bg anchors, exactly."""
    rng = _r(16)
    anchors = _rpn_inputs(rng)["Anchors"][0].reshape(-1, 4)
    ins = {"Anchor": [anchors], "AnchorVar": [np.ones_like(anchors)],
           "GtBoxes": [_gt_batch(rng, 2, 4, 56, (3, 2))]}
    if crowd:
        ins["IsCrowd"] = [np.int32([[0, 1, 0, 0], [0, 0, 0, 0]])]
    if im_info:
        ins["ImInfo"] = [np.float32([[48, 56, 1], [40, 50, 1]])]
    attrs = dict(rpn_batch_size_per_im=20, rpn_fg_fraction=0.25,
                 rpn_straddle_thresh=straddle, rpn_positive_overlap=0.5,
                 rpn_negative_overlap=0.3, use_random=False)
    got, want = _run_both("rpn_target_assign", ins, attrs)
    for k in want:
        check(got[k][0], want[k][0], k == "Labels", k)
    assert (got["Labels"][0] == 1).sum() > 0


def test_retinanet_target_assign_duplicate_best_anchor_takes_the_last():
    """Two gts with the same best anchor: the JAX package's
    ``.at[best_anchor].set`` keeps the later gt's class on the CPU (XLA
    applies duplicates in order); the port picks it by an arg-max."""
    rng = _r(17)
    anchors = _rpn_inputs(rng)["Anchors"][0].reshape(-1, 4)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[0, 0] = anchors[40] + [0, 0, 1, 1]
    gt[0, 1] = anchors[40] + [0, 0, 2, 1]           # same best anchor
    gt[0, 2] = anchors[7] + [1, 0, 0, 0]
    gt[1, :3] = _boxes(rng, 3, 56, lo=10)
    labels = np.int32([[3, 7, 2, 0], [1, 4, 5, 0]])[..., None]
    ins = {"Anchor": [anchors], "AnchorVar": [np.ones_like(anchors)],
           "GtBoxes": [gt], "GtLabels": [labels]}
    got, want = _run_both("retinanet_target_assign", ins,
                          dict(positive_overlap=0.5, negative_overlap=0.4))
    for k in want:
        check(got[k][0], want[k][0], k in ("Labels", "ForegroundNumber"), k)
    assert got["Labels"][0][0, 40] == 7
    ins["IsCrowd"] = [np.int32([[0, 1, 0, 0], [0, 0, 1, 0]])]
    got, want = _run_both("retinanet_target_assign", ins, {})
    for k in want:
        check(got[k][0], want[k][0], k in ("Labels", "ForegroundNumber"), k)
    assert got["Labels"][0][0, 40] == 3


def test_generate_proposal_labels_first_picks():
    rng = _r(18)
    rois = np.stack([_boxes(rng, 30, 60, lo=6, hi=30) for _ in range(2)])
    gt = _gt_batch(rng, 2, 3, 60, (3, 1))
    rois[0, :3] = gt[0] + 0.5                           # foreground RoIs
    ins = {"RpnRois": [rois], "GtClasses": [np.int32([[2, 5, 1], [4, 0, 0]])],
           "GtBoxes": [gt], "IsCrowd": [np.int32([[0, 0, 1], [0, 0, 0]])]}
    attrs = dict(batch_size_per_im=12, fg_fraction=0.25, fg_thresh=0.5,
                 bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                 bbox_reg_weights=[0.1, 0.1, 0.2, 0.2], use_random=False)
    got, want = _run_both("generate_proposal_labels", ins, attrs)
    for k in want:
        check(got[k][0], want[k][0], k in ("Labels", "Rois"), k)
    assert (got["Labels"][0] > 0).sum() >= 2


def test_sample_mask_is_the_jax_rule_on_the_same_scores():
    """The port's ``_sample_mask`` on the JAX package's own uniform draws
    picks the JAX package's entries, tie rule included: a score tied
    with the count-th largest is picked too, and a count of 0 picks
    nothing."""
    for seed in range(20):
        rng = _r(seed)
        elig = rng.uniform(0, 1, 300) < 0.4
        count = int(rng.randint(0, 150))
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jtrain._sample_mask(key, jnp.asarray(elig),
                                              count))
        r = np.array(jax.random.uniform(key, elig.shape))
        if seed == 3:                                 # force a tie
            r[np.flatnonzero(elig)[:2]] = 0.5
            want = _jax_rule(r, elig, count)
        got = ttrain._sample_mask(torch.from_numpy(r)[None],
                                  torch.from_numpy(elig)[None],
                                  torch.tensor([count]))[0].numpy()
        np.testing.assert_array_equal(got, want)


def _jax_rule(r, elig, count):
    scored = jnp.where(elig, r, -1.0)
    n_keep = jnp.minimum(count, jnp.sum(elig))
    thresh = -jnp.sort(-scored)[jnp.maximum(n_keep - 1, 0)]
    return np.asarray(elig & (scored >= thresh) & (n_keep > 0))


def test_sampling_invariants():
    """use_random=True (Philox draws cannot be threefry's): picks are a
    subset of the eligible labels of the first-picks run's rule, the
    counts are min(count, eligible) for fg and the rest of the batch for
    bg, and each eligible anchor's pick frequency over 400 seeds is
    uniform within 5 standard errors."""
    rng = _r(19)
    anchors = _rpn_inputs(rng)["Anchors"][0].reshape(-1, 4)
    gt = _gt_batch(rng, 1, 3, 56, (3,))
    ins = {"Anchor": [torch.from_numpy(anchors)],
           "AnchorVar": [torch.from_numpy(np.ones_like(anchors))],
           "GtBoxes": [torch.from_numpy(gt)]}
    attrs = dict(rpn_batch_size_per_im=24, rpn_fg_fraction=0.25,
                 rpn_positive_overlap=0.5, rpn_negative_overlap=0.3)
    fn = tget("rpn_target_assign").fn
    full = fn(TorchCtx(), ins, dict(attrs, rpn_batch_size_per_im=10 ** 6,
                                    use_random=False))["Labels"][0].numpy()
    n_pos, n_neg = (full == 1).sum(), (full == 0).sum()
    want_fg = min(6, n_pos)
    freq = np.zeros(anchors.shape[0])
    draws = 400
    for seed in range(draws):
        lab = fn(TorchCtx(seed), ins, dict(attrs, use_random=True))[
            "Labels"][0].numpy()
        assert np.all(full[lab == 1] == 1) and np.all(full[lab == 0] == 0)
        assert (lab == 1).sum() == want_fg
        assert (lab == 0).sum() == min(24 - want_fg, n_neg)
        freq += lab == 0
    p = (24 - want_fg) / n_neg
    se = np.sqrt(draws * p * (1 - p))
    assert np.all(np.abs(freq[full == 0] - draws * p) <= 5 * se)
    assert np.all(freq[full != 0] == 0)


def test_locality_aware_nms():
    rng = _r(20)
    base = _boxes(rng, 8, 1.0, lo=0.05, hi=0.3)
    boxes = np.repeat(base, 3, axis=0)[None] + \
        f32(rng, 1, 24, 4) * 0.004                  # runs of near boxes
    boxes = np.concatenate([boxes, boxes[:, ::-1]])
    scores = rng.uniform(0, 1, (2, 2, 24)).astype(np.float32)
    scores[0, 0, 5] = -0.2                          # a negative weight
    ins = {"BBoxes": [boxes.astype(np.float32)], "Scores": [scores]}
    for attrs in (dict(nms_threshold=0.3, score_threshold=0.1,
                       keep_top_k=20),
                  dict(nms_threshold=0.5, score_threshold=0.0, keep_top_k=60,
                       nms_top_k=5, background_label=1),
                  dict(nms_threshold=0.4, keep_top_k=10, normalized=False,
                       nms_eta=0.8)):
        got, want = _run_both("locality_aware_nms", ins, attrs)
        check(got["Out"][0], want["Out"][0], False, "Out")


def _retina_inputs(rng, n=2, c=3):
    levels = [(40, 32.0), (12, 64.0)]
    anchors = [_boxes(rng, a, 200, lo=s / 2, hi=s) for a, s in levels]
    return {"BBoxes": [f32(rng, n, a, 4) * 0.3 for a, _ in levels],
            "Scores": [rng.uniform(0, 1, (n, a, c)).astype(np.float32)
                       for a, _ in levels],
            "Anchors": anchors,
            "ImInfo": [np.float32([[150, 180, 1], [200, 120, 1]])[:n]]}


@pytest.mark.parametrize("attrs", [
    dict(score_threshold=0.3, nms_top_k=10, keep_top_k=12,
         nms_threshold=0.4),
    dict(score_threshold=0.05, nms_top_k=100, keep_top_k=200,
         nms_threshold=0.3),
    dict(score_threshold=0.5, nms_top_k=30, keep_top_k=8,
         nms_threshold=0.5, nms_eta=0.7),
])
def test_retinanet_detection_output(attrs):
    got, want = _run_both("retinanet_detection_output",
                          _retina_inputs(_r(21)), attrs)
    check(got["Out"][0], want["Out"][0], False, "Out")


def test_retinanet_detection_output_tie_at_the_kth_score():
    """Kept by design: a box past the nms_top_k-th tied with its score is
    a candidate in the JAX package's NMS and not in the port's; with no
    such tie the rows agree (above)."""
    ins = _retina_inputs(_r(22), n=1, c=1)
    s0 = ins["Scores"][0]
    s0[0, :, 0] = np.linspace(0.9, 0.5, 40)
    s0[0, 39, 0] = s0[0, 2, 0]                      # ties the 3rd best
    ins["Scores"][1][:] = 0.1
    ins["Anchors"][0][39] = [0, 0, 10, 10]          # far from box 2
    ins["Anchors"][0][2] = [100, 100, 160, 160]
    attrs = dict(score_threshold=0.3, nms_top_k=3, keep_top_k=10,
                 nms_threshold=0.5)
    got, want = _run_both("retinanet_detection_output", ins, attrs)
    kept_got = (got["Out"][0][0, :, 0] >= 0).sum()
    kept_want = (want["Out"][0][0, :, 0] >= 0).sum()
    assert kept_want == kept_got + 1
    check(got["Out"][0][0, :kept_got], want["Out"][0][0, :kept_got], False,
          "rows before the tie")


def _quads(rng, n, r, h, w):
    q = np.zeros((n, r, 8), np.float32)
    for i in range(n):
        for j in range(r):
            x0, y0 = rng.uniform(0, w * 0.5), rng.uniform(0, h * 0.5)
            dx, dy = rng.uniform(3, w * 0.45), rng.uniform(3, h * 0.45)
            sk = rng.uniform(-1.5, 1.5, 4)
            q[i, j] = [x0 + sk[0], y0, x0 + dx, y0 + sk[1],
                       x0 + dx + sk[2], y0 + dy, x0, y0 + dy + sk[3]]
    q[0, 0] = [-4, -3, 30, -2, 28, 20, -5, 18]       # past the map
    return q


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_perspective_transform(scale):
    """The homography of each RoI by the port's eliminating solve
    (``_solve``, no host check) against ``jnp.linalg.solve``: outputs and
    the map's gradient within rtol 1e-4, atol 1e-4 (the two solves
    round differently; an 8 x 8 system of pixel-sized coefficients)."""
    rng = _r(23)
    x = f32(rng, 2, 3, 12, 14)
    q = _quads(rng, 2, 3, 12 / scale, 14 / scale)
    tol = dict(rtol=1e-4, atol=1e-4)
    _compare("roi_perspective_transform", {"X": [x], "ROIs": [q]},
            dict(transformed_height=4, transformed_width=5,
                 spatial_scale=scale), diff=[("X", 0)], tol=tol,
            grad_tol=tol)


def test_solve_needs_no_host_check():
    """``_solve`` against ``jnp.linalg.solve`` on well- and ill-posed
    systems: finite where JAX's is, within 1e-5 relative where the
    system is well conditioned; a singular system gives non-finite
    values without raising (``torch.linalg.solve`` would raise on the
    host)."""
    rng = _r(24)
    a = rng.standard_normal((6, 8, 8)).astype(np.float32)
    a[1] = a[1] @ a[1].T + np.eye(8, dtype=np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    a[5, 3] = 0.0
    a[5, :, 3] = 0.0                                  # singular
    got = ttrain._solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jnp.linalg.solve(jnp.asarray(a),
                                       jnp.asarray(b)[..., None]))[..., 0]
    np.testing.assert_allclose(got[:5], want[:5], rtol=1e-4, atol=1e-4)
    assert not np.isfinite(got[5]).all()


def test_generate_mask_labels():
    rng = _r(25)
    gt_boxes = _gt_batch(rng, 2, 3, 80, (3, 2))
    rois = np.stack([_boxes(rng, 6, 80, lo=8, hi=40) for _ in range(2)])
    rois[0, 0] = gt_boxes[0, 1]
    rois[1, 1] = gt_boxes[1, 0] + [3, -2, 5, 4]
    segms = (rng.uniform(0, 1, (2, 3, 16, 16)) > 0.5).astype(np.int32)
    labels = np.int32([[2, 0, 5, -1, 1, 3], [0, 4, 1, 0, 0, 2]])
    ins = {"ImInfo": [np.float32([[80, 80, 1], [80, 80, 1]])],
           "GtClasses": [np.int32([[1, 2, 3], [4, 5, 0]])],
           "IsCrowd": [np.int32([[0, 0, 1], [0, 0, 0]])],
           "GtSegms": [segms], "Rois": [rois], "LabelsInt32": [labels],
           "GtBoxes": [gt_boxes]}
    for res in (7, 28):
        got, want = _run_both("generate_mask_labels", ins,
                              dict(num_classes=6, resolution=res))
        for k in want:
            check(got[k][0], want[k][0], True, k)


def test_mask_grid_is_jnp_linspace():
    """generate_mask_labels' grid: i times the f32 reciprocal of res - 1,
    which is what ``jnp.linspace(0, 1, res)`` gives on the CPU (not
    i / (res - 1), which differs in the last bit at some i)."""
    for res in (2, 7, 14, 21, 28, 56):
        step = np.float32(1.0) / np.float32(res - 1)
        grid = np.append(np.arange(res - 1, dtype=np.float32) * step,
                         np.float32(1.0))
        np.testing.assert_array_equal(grid,
                                      np.asarray(jnp.linspace(0., 1., res)))


def _sampling_program(pkg, dropout):
    """rpn_target_assign (use_random) in a program of its own, beside a
    dropout (an op flagged ``uses_rng``) or not."""
    main, start = pkg.Program(), pkg.Program()
    main.random_seed = start.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        L = pkg.layers
        anc = L.data("anc", [126, 4], append_batch_size=False)
        gt = L.data("gt", [1, 3, 4], append_batch_size=False)
        x = L.data("x", [4, 4], append_batch_size=False)
        labels = L.rpn_target_assign(
            x, x, anc, anc, gt, rpn_batch_size_per_im=24,
            rpn_fg_fraction=0.25, rpn_positive_overlap=0.5,
            rpn_negative_overlap=0.3, use_random=True)[2]
        fetch = [labels] + ([L.dropout(x, 0.5)] if dropout else [])
    return main, start, fetch


@pytest.mark.parametrize("dropout", [False, True])
def test_sampling_key_is_fixed_unless_a_flagged_op_shares_the_program(
        dropout):
    """Neither sampling op is flagged ``uses_rng``: the JAX package traces
    a program without a flagged op with PRNGKey(seed) at every step, so
    its runs sample the same anchors; beside a dropout the key folds in
    the step and the picks change from run to run. The port draws the
    same way (``RunContext.generator(flagged=False)``)."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    rng = _r(26)
    feed = {"anc": _rpn_inputs(rng)["Anchors"][0].reshape(-1, 4),
            "gt": _gt_batch(rng, 1, 3, 56, (3,)),
            "x": f32(rng, 4, 4)}
    same = {}
    for name, pkg, exe in (("jax", pt, pt.Executor()),
                           ("port", ptt, ptt.Executor(ptt.CPUPlace()))):
        main, start, fetch = _sampling_program(pkg, dropout)
        scope = pkg.Scope()
        exe.run(start, scope=scope)
        runs = [np.asarray(exe.run(main, feed=feed, fetch_list=fetch,
                                   scope=scope)[0]) for _ in range(3)]
        same[name] = [bool((runs[0] == r).all()) for r in runs[1:]]
        assert (runs[0] >= 0).sum() == 24 and (runs[0] == 1).sum() > 0
    assert same["port"] == same["jax"] == [not dropout] * 2


@pytest.mark.parametrize("op,ins,attrs", [
    ("sigmoid_cross_entropy_with_logits",
     {"X": [np.float32([[0.0, -0.0, 0.0, 1.5]])],
      "Label": [np.float32([[0.0, 1.0, 0.3, 0.0]])]}, {}),
    ("abs", {"X": [np.float32([0.0, -0.0, -2.0, 3.0])]}, {}),
    ("yolov3_loss", None, None),
])
def test_abs_gradient_at_zero_is_jnps(op, ins, attrs):
    """A logit of exactly 0 (a dead relu map through a zero bias, as an
    RPN's first step gives): |x|'s gradient there is ``jnp.abs``'s, 1
    (``math_ops.jnp_abs``), so the sigmoid losses' gradients at 0 are the
    JAX package's (-label for sigmoid CE, not sigmoid(0) - label)."""
    if op == "yolov3_loss":
        rng = _r(27)
        x = f32(rng, 2, 3 * 8, 4, 4)
        x[:, ::5] = 0.0
        gt = np.zeros((2, 3, 4), np.float32)
        gt[:, :2] = rng.uniform(0.2, 0.6, (2, 2, 4))
        ins = {"X": [x], "GTBox": [gt],
               "GTLabel": [rng.randint(0, 3, (2, 3)).astype(np.int32)]}
        attrs = dict(anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2],
                     class_num=3, ignore_thresh=0.7, downsample_ratio=32)
    _compare(op, ins, attrs, diff=[("X", 0)],
             grad_outs=["Loss"] if op == "yolov3_loss" else None)


@pytest.mark.parametrize("op,ins,attrs", [
    ("prior_box", {"Input": [np.zeros((1, 2, 3, 4), np.float32)],
                   "Image": [np.zeros((1, 3, 30, 40), np.float32)]},
     dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0])),
    ("anchor_generator", {"Input": [np.zeros((1, 2, 3, 4), np.float32)]},
     dict(anchor_sizes=[16.0, 32.0], aspect_ratios=[0.5, 1.0])),
    ("density_prior_box", {"Input": [np.zeros((1, 2, 3, 4), np.float32)],
                           "Image": [np.zeros((1, 3, 30, 40), np.float32)]},
     dict(densities=[2], fixed_sizes=[8.0], fixed_ratios=[1.0])),
])
def test_grids_keep_one_constant_an_op(op, ins, attrs):
    """Where a step may be captured, ``RunContext.constant`` keeps one
    tensor an op position: the boxes and the variances come out of one
    stacked constant, so a graphed run's variances are not its boxes."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.executor import RunContext
    tins = {k: [torch.from_numpy(v) for v in vs] for k, vs in ins.items()}
    fn = tget(op).fn
    want = fn(TorchCtx(), tins, attrs)
    ctx = RunContext(torch.device("cpu"), ptt.Program(), 0, constants={})
    for _ in range(2):                       # made, then copied
        got = fn(ctx, tins, attrs)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(want[list(want)[0]], want[list(want)[1]])


def test_bins_divide_as_the_jitted_jax_package():
    """A division by a Python number in the JAX package's jitted step is
    XLA's product with the f32 reciprocal (not IEEE division): roi_pool's
    7 x 7 bins over RoIs of extent 7k take the reciprocal's edges (i * 7k
    * (1/7) lands just above an integer at some i, and its ceil one
    pixel past the exact quotient's), in the port as in the JAX package
    under ``jax.jit``."""
    rng = _r(28)
    x = rng.randint(0, 5, (1, 2, 60, 60)).astype(np.float32)
    ext = np.arange(7, 57, 7, dtype=np.float32)          # 7 .. 56
    rois = np.stack([np.zeros_like(ext), np.zeros_like(ext), ext - 1,
                     ext - 1], 1)
    _compare("roi_pool", {"X": [x], "ROIs": [rois]},
             dict(pooled_height=7, pooled_width=7, spatial_scale=1.0),
             diff=[("X", 0)])
    rec = np.float32(1) / np.float32(7)
    moved = [(np.ceil(i * e * rec) != np.ceil(i * e / np.float32(7)))
             for e in ext for i in np.arange(1, 8, dtype=np.float32)]
    assert any(moved)     # e.g. 21 * (1/7) = 3.0000002: ceil gives 4
