"""The two-stage and RetinaNet training-side detection ops (counterparts
of paddle_tpu/ops/detection_train_ops.py): ``rpn_target_assign``,
``retinanet_target_assign``, ``generate_proposal_labels``,
``locality_aware_nms``, ``retinanet_detection_output``,
``roi_perspective_transform`` and ``generate_mask_labels``.

The JAX package's dense design is kept: full per-anchor and per-RoI
tensors with {-1, 0, 1} (or class) labels and 0/1 weights where the
reference emits LoD-compacted samples, so shapes are static and a step
is captured into a CUDA graph like any other. Every image runs at once;
plain torch throughout (the JAX package calls no Pallas kernel here).

Random sampling (``use_random``) keeps ``_sample_mask``'s rule with
uniform scores from the run context's generator: the JAX package's
threefry draws cannot be reproduced, so a sampled pick agrees with it in
distribution only (``use_random=False`` agrees exactly). Neither
sampling op is flagged ``uses_rng`` in either registry, so both draw as
the JAX package traces them: from the run counter only where a flagged
op shares the program, else the same draws at every run
(``RunContext.generator(flagged=False)``).
"""
import torch

from .detection_ops import _clip, _nms_alive, _top_k
from .registry import register_op
from .tensor_ops import add_rows
from .vision_ops import _rows


def _pairwise_iou(a, b):
    """IoU of xyxy boxes a (..., A, 4) against b (..., G, 4) -> (..., A,
    G), 0 where the union is empty."""
    ix = torch.clamp(torch.minimum(a[..., :, None, 2], b[..., None, :, 2]) -
                     torch.maximum(a[..., :, None, 0], b[..., None, :, 0]),
                     min=0.0)
    iy = torch.clamp(torch.minimum(a[..., :, None, 3], b[..., None, :, 3]) -
                     torch.maximum(a[..., :, None, 1], b[..., None, :, 1]),
                     min=0.0)
    inter = ix * iy
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _encode_boxes(anchors, gts):
    """Faster R-CNN regression targets [dx, dy, dw, dh] of gts against
    anchors (both (..., 4) xyxy)."""
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-6)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-6)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    gw = torch.clamp(gts[..., 2] - gts[..., 0], min=1e-6)
    gh = torch.clamp(gts[..., 3] - gts[..., 1], min=1e-6)
    gx = gts[..., 0] + 0.5 * gw
    gy = gts[..., 1] + 0.5 * gh
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


def _decode_boxes(anchors, deltas):
    """The inverse of ``_encode_boxes`` (log sizes capped at 10)."""
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-6)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-6)
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    cap = torch.full((), 10.0, dtype=deltas.dtype, device=deltas.device)
    w = torch.exp(torch.minimum(deltas[..., 2], cap)) * aw
    h = torch.exp(torch.minimum(deltas[..., 3], cap)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _sample_mask(r, eligible, count):
    """Pick min(count, eligible) of the True entries of ``eligible`` (B,
    A) by uniform scores ``r`` (B, A) in [0, 1): the eligible entries
    whose score is at least the count-th largest (paddle_tpu's
    ``_sample_mask``: a score tied with that threshold is picked too, so
    a tie there picks one more); none when the count is 0. ``count``
    (B,) may be a tensor."""
    scored = torch.where(eligible, r, torch.full_like(r, -1.0))
    n_keep = torch.minimum(count, eligible.sum(-1))
    srt = torch.sort(scored, dim=-1, descending=True).values
    at = torch.clamp(n_keep - 1, min=0).long()[:, None]
    thresh = torch.gather(srt, -1, at)
    return eligible & (scored >= thresh) & (n_keep > 0)[:, None]


def _first_count(eligible, count):
    """The first ``count`` True entries of ``eligible`` along the last
    axis (``use_random=False``)."""
    idx = torch.cumsum(eligible.to(torch.int32), dim=-1)
    return eligible & (idx <= count[:, None])


def _uniform(ctx, shape, device):
    return torch.rand(shape, generator=ctx.generator({}, flagged=False),
                      device=device)


def _last_hit(hot):
    """For each column of ``hot`` (B, K, A), 1 + the largest row index k
    whose entry is True (0 where none): the last write of a scatter of
    rows 0..K-1 into columns, as XLA's scatter applies duplicates in
    order on the CPU, made deterministic."""
    k = hot.shape[1]
    rank = torch.arange(1, k + 1, device=hot.device)[None, :, None]
    return (hot * rank).amax(1)


@register_op("rpn_target_assign",
             nondiff=("Anchor", "AnchorVar", "GtBoxes", "IsCrowd",
                      "ImInfo"), differentiable=False)
def _rpn_target_assign(ctx, ins, attrs):
    """Dense RPN targets: anchors (A, 4), ground truths (B, G, 4) zero
    padded -> Labels (B, A) in {-1 ignore, 0 bg, 1 fg}, BBoxTargets (B,
    A, 4) and the inside/outside weights (1 on sampled foreground).
    Positive: IoU >= rpn_positive_overlap, or a valid gt's best anchor;
    negative: below rpn_negative_overlap; crowd overlaps and anchors past
    the straddle margin ignored; then rpn_batch_size_per_im picks, a
    fraction of them foreground, sampled (``use_random``) or the first
    ones."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0]
    b, g = gt.shape[0], gt.shape[1]
    na = anchors.shape[0]
    dev = gt.device
    pos_iou = attrs.get("rpn_positive_overlap", 0.7)
    neg_iou = attrs.get("rpn_negative_overlap", 0.3)
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    straddle = attrs.get("rpn_straddle_thresh", 0.0)
    gt_valid = (gt != 0.0).any(dim=2)
    crowd = ins["IsCrowd"][0].reshape(b, -1).to(torch.bool) \
        if ins.get("IsCrowd") else torch.zeros((b, g), dtype=torch.bool,
                                               device=dev)
    gt_valid = gt_valid & ~crowd
    raw = _pairwise_iou(anchors, gt)                           # (B, A, G)
    ignore = torch.where(crowd[:, None, :], raw,
                         torch.zeros_like(raw)).amax(-1) >= neg_iou
    if straddle >= 0:
        if ins.get("ImInfo"):
            hw = ins["ImInfo"][0][:, :2]
            inside = ((anchors[:, 0] >= -straddle) &
                      (anchors[:, 1] >= -straddle) &
                      (anchors[:, 2] < hw[:, 1:2] + straddle) &
                      (anchors[:, 3] < hw[:, 0:1] + straddle))
        else:
            inside = ((anchors[:, 0] >= -straddle) &
                      (anchors[:, 1] >= -straddle))[None].expand(b, na)
        ignore = ignore | ~inside
    iou = torch.where(gt_valid[:, None, :], raw, torch.full_like(raw, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    labels = torch.full((b, na), -1, dtype=torch.int32, device=dev)
    labels = torch.where(best_iou < neg_iou, 0, labels)
    labels = torch.where(best_iou >= pos_iou, 1, labels)
    # every valid gt's best anchor is positive
    best_anchor = torch.argmax(iou, dim=1)                     # (B, G)
    force = ((best_anchor[..., None] == torch.arange(na, device=dev)) &
             gt_valid[..., None]).any(1)
    labels = torch.where(force, 1, labels)
    labels = torch.where(ignore, -1, labels).to(torch.int32)
    n_fg = torch.full((b,), int(batch * attrs.get("rpn_fg_fraction", 0.5)),
                      dtype=torch.long, device=dev)
    if attrs.get("use_random", True):
        r = _uniform(ctx, (2, b, na), dev)
        fg_pick = _sample_mask(r[0], labels == 1, n_fg)
        bg_pick = _sample_mask(r[1], labels == 0, batch - fg_pick.sum(-1))
    else:
        fg_pick = _first_count(labels == 1, n_fg)
        bg_pick = _first_count(labels == 0, batch - fg_pick.sum(-1))
    labels = torch.where(fg_pick, 1, torch.where(bg_pick, 0, -1)) \
        .to(torch.int32)
    matched = torch.gather(gt, 1, best_gt[..., None].expand(b, na, 4))
    tgt = _encode_boxes(anchors, matched)
    fg = (labels == 1).to(torch.float32)[..., None]
    wt = fg.expand(b, na, 4).contiguous()
    return {"Labels": labels, "BBoxTargets": tgt * fg,
            "BBoxInsideWeights": wt, "BBoxOutsideWeights": wt.clone()}


@register_op("retinanet_target_assign",
             nondiff=("Anchor", "AnchorVar", "GtBoxes", "GtLabels",
                      "IsCrowd", "ImInfo"), differentiable=False)
def _retinanet_target_assign(ctx, ins, attrs):
    """RetinaNet targets: no sampling; Labels (B, A) the matched gt's
    class where IoU >= positive_overlap, 0 below negative_overlap, -1
    between; each valid gt's best anchor takes that gt's class, the last
    such gt winning where two gts share a best anchor (XLA's scatter on
    the CPU applies duplicate writes in order), made deterministic here
    by an arg-max over the gt index; ForegroundNumber (B, 1) at least
    1."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0]
    gl = ins["GtLabels"][0]
    if gl.dim() == 3:
        gl = gl[..., 0]
    b, na = gt.shape[0], anchors.shape[0]
    dev = gt.device
    gt_valid = (gt != 0.0).any(dim=2)
    if ins.get("IsCrowd"):
        gt_valid = gt_valid & ~ins["IsCrowd"][0].reshape(
            gt_valid.shape).to(torch.bool)
    raw = _pairwise_iou(anchors, gt)
    iou = torch.where(gt_valid[:, None, :], raw, torch.full_like(raw, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    gl32 = gl.to(torch.int32)
    cls = torch.gather(gl32, 1, best_gt)
    labels = torch.full((b, na), -1, dtype=torch.int32, device=dev)
    labels = torch.where(best_iou < attrs.get("negative_overlap", 0.4), 0,
                         labels)
    labels = torch.where(best_iou >= attrs.get("positive_overlap", 0.5), cls,
                         labels)
    best_anchor = torch.argmax(iou, dim=1)                     # (B, G)
    hot = (best_anchor[..., None] == torch.arange(na, device=dev)) & \
        gt_valid[..., None]                                    # (B, G, A)
    last = _last_hit(hot)                                      # (B, A)
    forced = torch.gather(gl32, 1, torch.clamp(last - 1, min=0))
    labels = torch.where(last > 0, forced, labels).to(torch.int32)
    matched = torch.gather(gt, 1, best_gt[..., None].expand(b, na, 4))
    tgt = _encode_boxes(anchors, matched)
    fg = (labels >= 1).to(torch.float32)[..., None]
    fg_num = torch.clamp(fg.reshape(b, -1).sum(1), min=1.0).to(torch.int32)
    wt = fg.expand(b, na, 4).contiguous()
    return {"Labels": labels, "BBoxTargets": tgt * fg,
            "BBoxInsideWeights": wt, "BBoxOutsideWeights": wt.clone(),
            "ForegroundNumber": fg_num.reshape(-1, 1)}


@register_op("generate_proposal_labels",
             nondiff=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes",
                      "ImInfo"), differentiable=False)
def _generate_proposal_labels(ctx, ins, attrs):
    """Second-stage RoI sampling, dense: RoIs (B, R, 4), ground truths
    (B, G, 4) and classes -> every RoI with Labels (B, R) (-1 unpicked,
    0 background, the class foreground), BBoxTargets (B, R, 4) over
    ``bbox_reg_weights`` and the weights; batch_size_per_im picks, a
    fraction foreground (IoU >= fg_thresh), the rest background (IoU in
    [bg_thresh_lo, bg_thresh_hi)), sampled or the first ones."""
    rois = ins["RpnRois"][0]
    gt = ins["GtBoxes"][0]
    classes = ins["GtClasses"][0]
    if classes.dim() == 3:
        classes = classes[..., 0]
    b, r = rois.shape[0], rois.shape[1]
    dev = rois.device
    gt_valid = (gt != 0.0).any(dim=2)
    if ins.get("IsCrowd"):
        gt_valid = gt_valid & ~ins["IsCrowd"][0].reshape(
            gt_valid.shape).to(torch.bool)
    batch = int(attrs.get("batch_size_per_im", 512))
    raw = _pairwise_iou(rois, gt)
    iou = torch.where(gt_valid[:, None, :], raw, torch.full_like(raw, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    is_fg = best_iou >= attrs.get("fg_thresh", 0.5)
    is_bg = (best_iou < attrs.get("bg_thresh_hi", 0.5)) & \
        (best_iou >= attrs.get("bg_thresh_lo", 0.0))
    n_fg = torch.full((b,), int(batch * attrs.get("fg_fraction", 0.25)),
                      dtype=torch.long, device=dev)
    if attrs.get("use_random", True):
        u = _uniform(ctx, (2, b, r), dev)
        fg_pick = _sample_mask(u[0], is_fg, n_fg)
        bg_pick = _sample_mask(u[1], is_bg, batch - fg_pick.sum(-1))
    else:
        fg_pick = _first_count(is_fg, n_fg)
        bg_pick = _first_count(is_bg, batch - fg_pick.sum(-1))
    cls = torch.gather(classes.to(torch.int32), 1, best_gt)
    labels = torch.where(fg_pick, cls, torch.where(
        bg_pick, torch.zeros_like(cls), torch.full_like(cls, -1)))
    reg_w = ctx.constant(lambda: torch.tensor(
        attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2]),
        dtype=torch.float32, device=dev))
    matched = torch.gather(gt, 1, best_gt[..., None].expand(b, r, 4))
    tgt = _encode_boxes(rois, matched) / reg_w
    fg = (labels >= 1).to(torch.float32)[..., None]
    wt = fg.expand(b, r, 4).contiguous()
    return {"Rois": rois, "Labels": labels, "BBoxTargets": tgt * fg,
            "BBoxInsideWeights": wt, "BBoxOutsideWeights": wt.clone()}


def _segment_sums(values, seg, num):
    """Sums of ``values`` (K, M, ...) over segment ids ``seg`` (K, M) in
    [0, num) per row k -> (K, num, ...): one sorted
    ``index_put_(accumulate=True)`` (``tensor_ops.add_rows``), so two
    runs on the card give the same bits."""
    k, m = seg.shape
    flat = (seg + torch.arange(k, device=seg.device)[:, None] * num)
    rest = tuple(values.shape[2:])
    out = torch.zeros((k * num,) + rest, dtype=values.dtype,
                      device=values.device)
    ok = torch.ones((k * m,), dtype=torch.bool, device=seg.device)
    return add_rows(out, flat.reshape(-1), ok,
                    values.reshape((k * m,) + rest)).reshape((k, num) + rest)


def _class_topk_rows(s, bb, lab, keep_top_k, score_th):
    """The final step of locality_aware_nms and retinanet_detection_output
    per image: scores s (N, L), boxes bb (N, L, 4), labels lab (L,) ->
    (N, keep_top_k, 6) rows [label, score, x1, y1, x2, y2] best first
    (``lax.top_k``), an entry not above score_th as [-1, -1, 0, 0, 0,
    0], and the same past the L-th row."""
    n, total = s.shape
    k = min(keep_top_k, total)
    top_s, idx = _top_k(s, k)
    keep = top_s > score_th
    neg = torch.full((), -1.0, dtype=s.dtype, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    boxes = torch.gather(bb, 1, idx[..., None].expand(n, k, 4))
    out = torch.cat([torch.where(keep, lab[idx], neg)[..., None],
                     torch.where(keep, top_s, neg)[..., None],
                     torch.where(keep[..., None], boxes, zero)], dim=-1)
    if k < keep_top_k:
        pad = torch.zeros((n, keep_top_k - k, 6), dtype=s.dtype,
                          device=s.device)
        pad[..., :2] = -1.0
        out = torch.cat([out, pad], dim=1)
    return out


def _kth_truncate(sc, top_k):
    """Scores below the ``top_k``-th largest set to -1 (ties with it
    kept), along the last axis."""
    kth = torch.sort(sc, dim=-1, descending=True).values[..., top_k - 1:top_k]
    return torch.where(sc >= kth, sc, torch.full_like(sc, -1.0))


@register_op("locality_aware_nms", nondiff=("BBoxes", "Scores"),
             differentiable=False)
def _locality_aware_nms(ctx, ins, attrs):
    """EAST's locality-aware NMS, dense: boxes (N, M, 4), scores (N, C,
    M). Each box whose IoU with the box before it passes the threshold
    joins its run; a run is one box, the score-weighted mean of its
    members (weights max(score, 0)), at its first index with the
    members' mean score (``_segment_sums``); then greedy NMS per class
    (all classes of all images at once) and the keep_top_k best rows
    (N, keep_top_k, 6)."""
    boxes = ins["BBoxes"][0]
    scores = ins["Scores"][0]
    iou_th = attrs.get("nms_threshold", 0.3)
    score_th = attrs.get("score_threshold", 0.0)
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_top_k = int(attrs.get("nms_top_k", -1))
    background = int(attrs.get("background_label", -1))
    n, c, m = scores.shape
    dev = boxes.device
    cls = [k for k in range(c) if k != background]
    # slices, not a list index (a host copy, which a capture refuses)
    sc = torch.cat([scores[:, :background], scores[:, background + 1:]],
                   1) if 0 <= background < c else scores     # (N, C', M)
    cc = len(cls)
    # each box's IoU with the box before it, (N, M - 1)
    iou_prev = _pairwise_iou(boxes[:, 1:, None, :],
                             boxes[:, :-1, None, :])[..., 0, 0]
    merge = torch.cat([torch.zeros((n, 1), dtype=boxes.dtype, device=dev),
                       iou_prev], dim=1) > iou_th           # (N, M)
    seg = torch.cumsum((~merge).to(torch.long), dim=1)       # (N, M)
    segk = seg[:, None].expand(n, cc, m).reshape(n * cc, m)
    flat_sc = sc.reshape(n * cc, m)
    w = torch.clamp(flat_sc, min=0.0)
    bx = boxes[:, None].expand(n, cc, m, 4).reshape(n * cc, m, 4)
    seg_w = _segment_sums(w, segk, m + 1)
    seg_box = _segment_sums(bx * w[..., None], segk, m + 1)
    seg_s = _segment_sums(flat_sc, segk, m + 1) / torch.clamp(
        _segment_sums(torch.ones_like(flat_sc), segk, m + 1), min=1.0)
    merged = seg_box / torch.clamp(seg_w[..., None], min=1e-8)
    first = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                       ~merge[:, 1:]], dim=1)
    firstk = first[:, None].expand(n, cc, m).reshape(n * cc, m)
    mb = torch.where(firstk[..., None], torch.gather(
        merged, 1, segk[..., None].expand(n * cc, m, 4)),
        torch.zeros((), dtype=boxes.dtype, device=dev))
    ms = torch.where(firstk, torch.gather(seg_s, 1, segk),
                     torch.full((), -1.0, dtype=sc.dtype, device=dev))
    if 0 < nms_top_k < m:
        ms = _kth_truncate(ms, nms_top_k)
    alive = _nms_alive(mb, ms, iou_th, score_th,
                       normalized=attrs.get("normalized", True),
                       nms_eta=attrs.get("nms_eta", 1.0))
    s = torch.where(alive, ms, torch.full((), -1.0, dtype=ms.dtype,
                                          device=dev))
    lab = ctx.constant(lambda: torch.tensor(
        cls, dtype=torch.float32, device=dev).repeat_interleave(m))
    return {"Out": _class_topk_rows(s.reshape(n, cc * m),
                                    mb.reshape(n, cc * m, 4), lab,
                                    keep_top_k, score_th)}


@register_op("retinanet_detection_output",
             nondiff=("BBoxes", "Scores", "Anchors", "ImInfo"),
             differentiable=False)
def _retinanet_detection_output(ctx, ins, attrs):
    """RetinaNet's inference head: per-level deltas (N, A_l, 4), sigmoid
    scores (N, A_l, C) and anchors (A_l, 4), decoded, clipped to ImInfo,
    concatenated; per class greedy NMS of its ``nms_top_k`` best boxes
    (``lax.top_k``'s order), every image and class at once; the
    ``keep_top_k`` best rows (N, keep_top_k, 6) [label (1-based), score,
    x1, y1, x2, y2]. The JAX package runs the NMS over all A boxes with
    the scores under the k-th best set to -1; a box can only be
    suppressed by one visited before it, so the survivors are the same,
    except that a box beyond the k-th tied with the k-th score stays a
    candidate there and not here (its (C, A, A) IoU matrix does not fit
    a card at RetinaNet's 200k anchors)."""
    im_info = ins["ImInfo"][0]
    score_th = attrs.get("score_threshold", 0.05)
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    n = im_info.shape[0]
    dev = im_info.device
    hmax = im_info[:, 0:1] - 1
    wmax = im_info[:, 1:2] - 1
    boxes, scores = [], []
    for d, s, a in zip(ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        dec = _decode_boxes(a.reshape(-1, 4), d.reshape(n, -1, 4))
        zero = torch.zeros((), dtype=dec.dtype, device=dev)
        boxes.append(torch.stack([_clip(dec[..., 0], zero, wmax),
                                  _clip(dec[..., 1], zero, hmax),
                                  _clip(dec[..., 2], zero, wmax),
                                  _clip(dec[..., 3], zero, hmax)], -1))
        scores.append(s.reshape(n, dec.shape[1], -1))
    boxes = torch.cat(boxes, 1)                               # (N, A, 4)
    sc = torch.cat(scores, 1).transpose(1, 2)                 # (N, C, A)
    c, a_tot = sc.shape[1], sc.shape[2]
    if 0 < nms_top_k < a_tot:
        k = nms_top_k
        sc, idx = _top_k(sc, k)                               # (N, C, K)
        cand = torch.gather(boxes[:, None].expand(n, c, a_tot, 4), 2,
                            idx[..., None].expand(n, c, k, 4))
    else:
        k = a_tot
        cand = boxes[:, None].expand(n, c, a_tot, 4)
    alive = _nms_alive(cand, sc, attrs.get("nms_threshold", 0.3), score_th,
                       nms_eta=attrs.get("nms_eta", 1.0))
    s = torch.where(alive, sc, torch.full((), -1.0, dtype=sc.dtype,
                                          device=dev))
    lab = ctx.constant(lambda: torch.arange(
        1, c + 1, dtype=torch.float32, device=dev).repeat_interleave(k))
    return {"Out": _class_topk_rows(s.reshape(n, c * k),
                                    cand.reshape(n, c * k, 4), lab,
                                    keep_top_k, score_th)}


def _solve(a, b):
    """x of a x = b for a batch of small systems, a (..., n, n), b (...,
    n): Gaussian elimination with partial pivoting (the largest |a_ik| of
    column k, the first on a tie, as LAPACK's getrf), in plain tensor
    ops: no singularity check reads the device, so a step holding it is
    captured into a CUDA graph (``torch.linalg.solve`` checks on the
    host)."""
    n = a.shape[-1]
    m = torch.cat([a, b[..., None]], dim=-1)                   # (..., n, n+1)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        p = torch.argmax(m[..., k:, k].abs(), dim=-1) + k
        rowk = m[..., k, :]
        rowp = torch.gather(m, -2, p[..., None, None].expand(
            p.shape + (1, n + 1)))[..., 0, :]
        is_k = (rows == k)[:, None]
        is_p = (rows == p[..., None])[..., None]
        m = torch.where(is_k, rowp[..., None, :],
                        torch.where(is_p, rowk[..., None, :], m))
        f = m[..., k + 1:, k] / m[..., k, k][..., None]
        m = torch.cat([m[..., :k + 1, :],
                       m[..., k + 1:, :] - f[..., None] * m[..., k:k + 1, :]],
                      dim=-2)
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = m[..., i, n]
        for j in range(i + 1, n):
            acc = acc - m[..., i, j] * x[j]
        x[i] = acc / m[..., i, i]
    return torch.stack(x, dim=-1)


@register_op("roi_perspective_transform", nondiff=("ROIs",))
def _roi_perspective_transform(ctx, ins, attrs):
    """Perspective-warped RoI crops: X (N, C, H, W), quads (N, R, 8)
    clockwise [x1 y1 ... x4 y4] times spatial_scale -> (N, R, C, out_h,
    out_w), each output point bilinear-sampled (four taps of the map's
    row table) where the homography sending the output grid's corners to
    the quad's puts it, zero outside the map. The homography solves the
    8 x 8 system (plus 1e-6 I) of each RoI by ``_solve``."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    out_h = int(attrs.get("transformed_height", 8))
    out_w = int(attrs.get("transformed_width", 8))
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    r = rois.shape[1]
    dev = x.device
    dst = rois.reshape(n, r, 4, 2) * scale
    with torch.no_grad():
        src = ((0.0, 0.0), (out_w - 1.0, 0.0), (out_w - 1.0, out_h - 1.0),
               (0.0, out_h - 1.0))
        zero = torch.zeros((n, r), dtype=x.dtype, device=dev)
        one = torch.ones((n, r), dtype=x.dtype, device=dev)
        eqs = []
        for i, (sx, sy) in enumerate(src):
            dx, dy = dst[..., i, 0], dst[..., i, 1]
            sxv, syv = zero + sx, zero + sy
            eqs.append(torch.stack([sxv, syv, one, zero, zero, zero,
                                    -dx * sx, -dx * sy], -1))
            eqs.append(torch.stack([zero, zero, zero, sxv, syv, one,
                                    -dy * sx, -dy * sy], -1))
        amat = torch.stack(eqs, -2) + 1e-6 * torch.eye(
            8, dtype=x.dtype, device=dev)
        sol = _solve(amat, dst.reshape(n, r, 8))
        hom = torch.cat([sol, torch.ones((n, r, 1), dtype=x.dtype,
                                         device=dev)], -1).reshape(n, r, 3, 3)
        yy, xx = torch.meshgrid(
            torch.arange(out_h, dtype=x.dtype, device=dev),
            torch.arange(out_w, dtype=x.dtype, device=dev), indexing="ij")
        grid = torch.stack([xx.reshape(-1), yy.reshape(-1),
                            torch.ones(out_h * out_w, dtype=x.dtype,
                                       device=dev)])          # (3, P)
        pts = torch.matmul(hom, grid)                         # (N, R, 3, P)
        den = torch.clamp(pts[..., 2, :], min=1e-6)
        px = pts[..., 0, :] / den
        py = pts[..., 1, :] / den
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        inside = ((px >= 0) & (px <= w - 1) & (py >= 0) &
                  (py <= h - 1)).to(x.dtype)
    table = _rows(x)
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]

    def at(ix, iy):
        ix = torch.clamp(ix, 0, w - 1).long()
        iy = torch.clamp(iy, 0, h - 1).long()
        return table[base + iy * w + ix]                     # (N, R, P, C)

    fxb, fyb = fx[..., None], fy[..., None]
    val = (at(x0, y0) * (1 - fxb) * (1 - fyb) +
           at(x0 + 1, y0) * fxb * (1 - fyb) +
           at(x0, y0 + 1) * (1 - fxb) * fyb +
           at(x0 + 1, y0 + 1) * fxb * fyb)
    val = val * inside[..., None]
    return {"Out": val.permute(0, 1, 3, 2).reshape(n, r, c, out_h, out_w)}


@register_op("generate_mask_labels",
             nondiff=("ImInfo", "GtClasses", "IsCrowd", "GtSegms",
                      "Rois", "LabelsInt32"), differentiable=False)
def _generate_mask_labels(ctx, ins, attrs):
    """Mask R-CNN targets, dense: GtSegms (B, G, S, S) bitmaps registered
    to GtBoxes (B, G, 4). For each foreground RoI (label > 0), the
    bitmap of its best-IoU gt sampled at a res x res grid over the RoI
    (nearest pixel; 0 outside the gt box) in its class's slot of
    MaskInt32 (B, R, num_classes * res * res), -1 everywhere else. The
    grid is ``jnp.linspace(0, 1, res)``'s values: i times the f32
    reciprocal of res - 1."""
    segms = ins["GtSegms"][0]
    rois = ins["Rois"][0]
    labels = ins["LabelsInt32"][0]
    gt_boxes = ins["GtBoxes"][0]
    res = int(attrs.get("resolution", 14))
    num_classes = int(attrs.get("num_classes", 81))
    b, r = labels.shape
    g, s = segms.shape[1], segms.shape[-1]
    dev = rois.device
    gt_valid = (gt_boxes != 0.0).any(dim=2)
    if ins.get("IsCrowd"):
        gt_valid = gt_valid & ~ins["IsCrowd"][0].reshape(
            gt_valid.shape).to(torch.bool)
    raw = _pairwise_iou(rois, gt_boxes)
    best = torch.argmax(torch.where(gt_valid[:, None, :], raw,
                                    torch.full_like(raw, -1.0)), dim=2)
    box = torch.gather(gt_boxes, 1, best[..., None].expand(b, r, 4))

    def make_grid():
        step = torch.tensor(1.0, dtype=torch.float32) / max(res - 1, 1)
        out = torch.arange(res, dtype=torch.float32) * step
        out[-1] = 1.0
        return out.to(dev)
    lin = ctx.constant(make_grid)
    ry = rois[..., 1:2] + (rois[..., 3:4] - rois[..., 1:2]) * lin
    rx = rois[..., 0:1] + (rois[..., 2:3] - rois[..., 0:1]) * lin
    gy = (ry - box[..., 1:2]) / torch.clamp(box[..., 3:4] - box[..., 1:2],
                                            min=1e-6)
    gx = (rx - box[..., 0:1]) / torch.clamp(box[..., 2:3] - box[..., 0:1],
                                            min=1e-6)
    iy = torch.clamp(torch.round(gy * (s - 1)), 0, s - 1).long()
    ix = torch.clamp(torch.round(gx * (s - 1)), 0, s - 1).long()
    inside = ((gy >= 0) & (gy <= 1))[..., :, None] & \
        ((gx >= 0) & (gx <= 1))[..., None, :]                 # (B,R,res,res)
    plane = (torch.arange(b, device=dev)[:, None] * g + best) * s
    at = ((plane[..., None] + iy)[..., :, None] * s + ix[..., None, :])
    val = segms.reshape(-1)[at].to(torch.float32)
    flat = torch.where(inside, val, torch.zeros((), device=dev)) \
        .reshape(b, r, 1, res * res)
    cls = torch.clamp(labels, 0, num_classes - 1).long()
    slot = (cls[..., None] == torch.arange(num_classes, device=dev)) & \
        (labels > 0)[..., None]                                # (B, R, NC)
    out = torch.where(slot[..., None], flat,
                      torch.full((), -1.0, device=dev))
    return {"MaskRois": rois, "RoiHasMaskInt32": (labels > 0).to(torch.int32),
            "MaskInt32": out.reshape(b, r, num_classes * res * res)
            .to(torch.int32)}
