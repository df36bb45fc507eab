"""The detection ops of paddle_tpu/ops/detection_ops.py: the SSD head's
(``prior_box``, ``density_prior_box``, ``box_coder``,
``iou_similarity``, ``bipartite_match``, ``target_assign``,
``mine_hard_examples``, ``ssd_loss``), YOLOv3's (``yolo_box``,
``yolov3_loss``), the NMS family (``multiclass_nms`` with its greedy
core ``_nms_alive``, ``static_nms``), the two-stage detectors' RPN and
RoI ops (``anchor_generator``, ``generate_proposals``, ``box_clip``,
``roi_align``, ``roi_pool``, ``box_decoder_and_assign``,
``distribute_fpn_proposals``, ``collect_fpn_proposals``), RetinaNet's
``sigmoid_focal_loss`` and EAST's ``polygon_box_transform``.

The JAX package computes them with ``jnp`` and ``lax.fori_loop``, no
Pallas call, so they are plain torch here, with static shapes and no
value read back to the host, so a served request or a training step is
captured into a CUDA graph like any other. Orders that decide results
follow the JAX package exactly: ``jnp.argsort`` (stable, equal values
lower index first, -0.0 equal to 0.0, NaN last) is a stable ascending
``torch.sort`` of the same key (a stable descending sort where the JAX
package sorts the negated key and no NaN can occur), ``lax.top_k``
(lower index first among ties, -0.0 below 0.0) is ``torch.topk`` of
order keys without ties (``tensor_ops._float_order_key``),
``jnp.argmax`` (the first maximum, a NaN before any number) is
``torch.argmax``; the NMS and matching loops run their greedy steps over
all images and classes at once. Prior and anchor grids depend on shapes
and attributes only: they are made in numpy, as in the JAX package, once
per plan (``RunContext.constant``). A RoI pooling reads rows of an
(N * H * W, C) table by advanced indexing, whose backward is the sorted
``index_put_(accumulate=True)`` (``tensor_ops.add_rows``'s), so two runs
on the card give the same bits.
"""
import math

import numpy as np
import torch

from .math_ops import jnp_abs, recip_f32 as _recip
from .registry import register_op
from .tensor_ops import _float_order_key
from .vision_ops import _batch_index, _rows


def _consts(ctx, values, device):
    """An f32 tensor of the attr-derived ``values`` (made once per plan
    where the step may be captured: ``RunContext.constant``)."""
    return ctx.constant(lambda: torch.tensor(values, dtype=torch.float32,
                                             device=device))


def _top_k(x, k):
    """(values, indices) of ``lax.top_k(x, k)`` along the last axis."""
    idx = torch.topk(_float_order_key(x), k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


@register_op("yolo_box", nondiff=("X", "ImgSize"), differentiable=False)
def _yolo_box(ctx, ins, attrs):
    """Decode a YOLOv3 head (N, A*(5+C), H, W) into (N, A*H*W, 4) xyxy
    boxes in image pixels and (N, A*H*W, C) scores; a prediction whose
    objectness is not above ``conf_thresh`` gives zeros."""
    x = ins["X"][0]
    img_size = ins["ImgSize"][0]
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    downsample = attrs.get("downsample_ratio", 32)
    conf_thresh = attrs.get("conf_thresh", 0.01)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device)
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    anc = _consts(ctx, [anchors[0::2], anchors[1::2]], x.device)
    aw = anc[0][None, :, None, None]
    ah = anc[1][None, :, None, None]
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / h
    bw = torch.exp(x[:, :, 2]) * aw / (w * downsample)
    bh = torch.exp(x[:, :, 3]) * ah / (h * downsample)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    mask = (conf > conf_thresh).to(x.dtype)
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    boxes = torch.stack([(bx - bw / 2) * img_w, (by - bh / 2) * img_h,
                         (bx + bw / 2) * img_w, (by + bh / 2) * img_h],
                        dim=-1)
    boxes = (boxes * mask[..., None]).reshape(n, na * h * w, 4)
    scores = (probs * mask[:, :, None]).permute(0, 1, 3, 4, 2)
    return {"Boxes": boxes,
            "Scores": scores.reshape(n, na * h * w, class_num)}


def _nms_alive(boxes, scores, iou_th, score_th=0.0, normalized=True,
               nms_eta=1.0):
    """Greedy NMS survivor mask of boxes (..., m, 4) with scores (..., m),
    every leading index (image, class) at once: one loop of m steps over
    tensors shaped (..., m), never one loop per image and class. Boxes
    are visited in score order (a stable descending sort); a box dies if
    it overlaps a higher-scoring live box by more than the threshold,
    which ``nms_eta`` < 1 decays after each live box while above 0.5.
    ``normalized=False`` adds the reference's +1 pixel to widths and
    heights. Returns a bool mask in the input order."""
    m = boxes.shape[-2]
    off = 0.0 if normalized else 1.0
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    s = torch.gather(scores, -1, order)
    area = torch.clamp(b[..., 2] - b[..., 0] + off, min=0) * \
        torch.clamp(b[..., 3] - b[..., 1] + off, min=0)

    def side(lo, hi):
        # the overlap of every pair along one axis, (..., m, m)
        return torch.clamp(
            torch.minimum(b[..., :, None, hi], b[..., None, :, hi]) -
            torch.maximum(b[..., :, None, lo], b[..., None, :, lo]) + off,
            min=0)
    inter = side(0, 2) * side(1, 3)
    iou = inter / torch.clamp(area[..., :, None] + area[..., None, :] - inter,
                              min=1e-10)
    ar = torch.arange(m, device=boxes.device)
    later = ar[None, :] > ar[:, None]                    # (m, m): j > i
    alive = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    th = torch.full(s.shape[:-1], iou_th, dtype=torch.float32,
                    device=s.device)
    for i in range(m):
        live = alive[..., i]
        sup = (iou[..., i, :] > th[..., None]) & later[i] & live[..., None]
        if nms_eta < 1.0:
            th = torch.where((th > 0.5) & live, th * nms_eta, th)
        alive = alive & ~sup
    alive = alive & (s > score_th)
    return torch.zeros_like(alive).scatter(-1, order, alive)


@register_op("static_nms", nondiff=("Boxes", "Scores"),
             differentiable=False)
def _static_nms(ctx, ins, attrs):
    """Top-k-capped NMS of boxes (M, 4) with a static output: keep_top_k
    boxes, score 0 in suppressed slots, the candidates capped at
    4 * keep_top_k before suppression."""
    boxes, scores = ins["Boxes"][0], ins["Scores"][0]
    keep = min(attrs.get("keep_top_k", 100), boxes.shape[0])
    cap = min(keep * 4, boxes.shape[0])
    order = torch.sort(scores, descending=True, stable=True).indices[:cap]
    boxes_s, scores_s = boxes[order], scores[order]
    alive = _nms_alive(boxes_s, scores_s, attrs.get("nms_threshold", 0.45))
    final = torch.where(alive, scores_s, torch.zeros_like(scores_s))
    order2 = torch.sort(final, descending=True, stable=True).indices[:keep]
    return {"Out": boxes_s[order2], "Scores": final[order2],
            "Index": order[order2]}


@register_op("multiclass_nms", nondiff=("BBoxes", "Scores"),
             differentiable=False)
def _multiclass_nms(ctx, ins, attrs):
    """Static-shape multiclass NMS: (N, keep_top_k, 6) rows [label, score,
    x1, y1, x2, y2] best first, -1 labels and 0 scores in empty slots
    (whose boxes are those the stable top-k puts there, as in the JAX
    package), ``Index`` the kept box's row of BBoxes (-1 empty) and
    ``NmsRoisNum`` the kept count per image. Each class keeps its
    ``nms_top_k`` best candidates, NMS runs over all images and classes
    at once (``_nms_alive``), then the best ``keep_top_k`` of all
    classes (every survivor for -1)."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]   # (N,M,4), (N,C,M)
    score_th = float(attrs.get("score_threshold", 0.0))
    iou_th = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", -1))
    keep_top_k = int(attrs.get("keep_top_k", -1))
    bg = int(attrs.get("background_label", 0))
    n, cc, m = scores.shape
    m_eff = min(m, nms_top_k) if nms_top_k > 0 else m
    if keep_top_k <= 0:
        keep_top_k = cc * m_eff
    keep_top_k = min(keep_top_k, cc * m_eff)
    dev = scores.device
    if m_eff < m:
        sc, cand = _top_k(scores, m_eff)                  # (N, C, m_eff)
        boxes = torch.gather(
            bboxes[:, None].expand(n, cc, m, 4), 2,
            cand[..., None].expand(n, cc, m_eff, 4))
    else:
        sc = scores
        cand = torch.arange(m, device=dev).expand(n, cc, m)
        boxes = bboxes[:, None].expand(n, cc, m, 4)
    alive = _nms_alive(boxes, sc, iou_th, score_th,
                       bool(attrs.get("normalized", True)),
                       float(attrs.get("nms_eta", 1.0)))
    zero = torch.zeros((), dtype=sc.dtype, device=dev)
    flat_s = torch.where(alive, sc, zero).reshape(n, cc * m_eff)
    flat_l = torch.arange(cc, device=dev).repeat_interleave(m_eff)
    if bg >= 0:
        flat_s = torch.where(flat_l == bg, zero, flat_s)
    top_s, idx = _top_k(flat_s, keep_top_k)
    sel_b = torch.gather(boxes.reshape(n, cc * m_eff, 4), 1,
                         idx[..., None].expand(n, keep_top_k, 4))
    kept = top_s > 0
    sel_l = torch.where(kept, flat_l[idx], -1).to(sc.dtype)
    sel_i = torch.where(kept, torch.gather(cand.reshape(n, cc * m_eff), 1,
                                           idx), -1).to(torch.int32)
    out = torch.cat([sel_l[..., None], top_s[..., None], sel_b], dim=-1)
    return {"Out": out, "Index": sel_i,
            "NmsRoisNum": kept.sum(-1).to(torch.int32)}


def _bce_logits(x, label):
    """BCE with logits, max(x, 0) - x * label + log1p(exp(-|x|))
    (``torch.maximum``: a tie at 0 splits its gradient, as
    ``jnp.maximum``'s does; ``jnp_abs``: |x|'s gradient 1 at 0, as
    ``jnp.abs``'s)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) - x * label + \
        torch.log1p(torch.exp(-jnp_abs(x)))


def _iou_xywh(x1, y1, w1, h1, x2, y2, w2, h2):
    ow = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) - \
        torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
    oh = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) - \
        torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)


@register_op("yolov3_loss", nondiff=("GTBox", "GTLabel", "GTScore"))
def _yolov3_loss(ctx, ins, attrs):
    """YOLOv3's training loss per image (the JAX op's arithmetic),
    differentiable in X only: each prediction's best IoU against the
    ground truths sets the ignore mask; each ground truth picks its best
    anchor by wh-IoU and, when that anchor is in ``anchor_mask``, adds
    location (BCE xy + L1 wh, scaled by (2 - w*h) * score), class (BCE
    against a smoothed one-hot) and an objectness target, a later box
    overwriting an earlier one in the same cell. Cells are picked by
    one-hot products and the overwrite by a deterministic arg-max over
    the box index, never by scattered gathers, so the gradient sums in a
    fixed order on the card (a replay equals an op-by-op run)."""
    x = ins["X"][0]                                   # (N, M*(5+C), H, W)
    gb = ins["GTBox"][0]                              # (N, B, 4) xywh
    gl = ins["GTLabel"][0]                            # (N, B)
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    n, _, h, w = x.shape
    an_num, mask_num, b = len(anchors) // 2, len(anchor_mask), gb.shape[1]
    input_size = downsample * h
    if gl.dim() == 3:
        gl = gl[..., 0]
    gs = ins["GTScore"][0] if ins.get("GTScore") else \
        torch.ones((n, b), dtype=x.dtype, device=x.device)
    label_pos, label_neg = 1.0, 0.0
    if attrs.get("use_label_smooth", True):
        delta = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - delta, delta
    an2mask = [-1] * an_num
    for p, a in enumerate(anchor_mask):
        an2mask[a] = p
    # rows: every anchor's w, h, mask position; then the masked anchors'
    anc = _consts(ctx, [anchors[0::2], anchors[1::2], an2mask,
                        [anchors[2 * a] for a in anchor_mask] +
                        [0] * (an_num - mask_num),
                        [anchors[2 * a + 1] for a in anchor_mask] +
                        [0] * (an_num - mask_num)], x.device)
    aw_all, ah_all = anc[0], anc[1]
    aw_m = anc[3, :mask_num][None, :, None, None]
    ah_m = anc[4, :mask_num][None, :, None, None]
    xi = x.reshape(n, mask_num, 5 + class_num, h, w)
    valid = (gb[..., 2] > 1e-6) & (gb[..., 3] > 1e-6)   # (N, B)

    with torch.no_grad():                 # the ignore mask has no gradient
        gx = torch.arange(w, dtype=x.dtype, device=x.device)
        gy = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
        px = (gx + torch.sigmoid(xi[:, :, 0])) / w        # (N, M, H, W)
        py = (gy + torch.sigmoid(xi[:, :, 1])) / h
        pw = torch.exp(xi[:, :, 2]) * aw_m / input_size
        ph = torch.exp(xi[:, :, 3]) * ah_m / input_size
        g = gb[:, None, None, None]                       # (N,1,1,1,B,4)
        ious = _iou_xywh(px[..., None], py[..., None], pw[..., None],
                         ph[..., None], g[..., 0], g[..., 1], g[..., 2],
                         g[..., 3])                       # (N,M,H,W,B)
        ious = torch.where(valid[:, None, None, None], ious,
                           torch.zeros_like(ious))
        objness = torch.where(ious.amax(-1) > ignore_thresh, -1.0,
                              0.0).to(x.dtype)

    # each gt's best anchor (the first on a tie, as jnp.argmax)
    a_iou = _iou_xywh(0.0, 0.0, aw_all / input_size, ah_all / input_size,
                      0.0, 0.0, gb[..., 2:3], gb[..., 3:4])   # (N, B, A)
    best_n = torch.argmax(a_iou, dim=-1)                      # (N, B)
    midx = anc[2][best_n].long()
    pos = valid & (midx >= 0)
    gi = torch.clamp((gb[..., 0] * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gb[..., 1] * h).to(torch.int32), 0, h - 1)
    msafe = torch.clamp(midx, min=0)
    tx = gb[..., 0] * w - gi
    ty = gb[..., 1] * h - gj
    tw = torch.log(torch.clamp(gb[..., 2] * input_size / aw_all[best_n],
                               min=1e-10))
    th = torch.log(torch.clamp(gb[..., 3] * input_size / ah_all[best_n],
                               min=1e-10))
    scale = (2.0 - gb[..., 2] * gb[..., 3]) * gs
    # each gt's cell row of X by a one-hot product (N, B, M*H*W) @ (N,
    # M*H*W, 5+C): exact, and its gradient a fixed-order matmul
    cells = mask_num * h * w
    flat = (msafe * h + gj) * w + gi                          # (N, B)
    hot = flat[..., None] == torch.arange(cells, device=x.device)
    xr = xi.permute(0, 1, 3, 4, 2).reshape(n, cells, 5 + class_num)
    cell = torch.bmm(hot.to(x.dtype), xr)                     # (N, B, 5+C)
    loc = (_bce_logits(cell[..., 0], tx) + _bce_logits(cell[..., 1], ty) +
           jnp_abs(cell[..., 2] - tw) + jnp_abs(cell[..., 3] - th)) * \
        scale
    onehot = torch.arange(class_num, device=x.device) == gl[..., None]
    tgt = torch.where(onehot, label_pos, label_neg).to(x.dtype)
    lbl = _bce_logits(cell[..., 5:], tgt).sum(-1) * gs
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pos_loss = torch.where(pos, loc + lbl, zero).sum(-1)      # (N,)

    # objectness targets: a positive gt's score in its cell, the last gt
    # of a cell winning (the largest 1-based gt index hitting it)
    hits = (hot & pos[..., None]) * torch.arange(
        1, b + 1, device=x.device)[None, :, None]              # (N, B, cells)
    last = hits.amax(1)                                        # (N, cells)
    picked = torch.gather(gs, 1, torch.clamp(last - 1, min=0))
    objness = torch.where(last > 0, picked,
                          objness.reshape(n, cells)).reshape(objness.shape)
    logit = xi[:, :, 4]
    obj_loss = torch.where(
        objness > 1e-5, _bce_logits(logit, 1.0) * objness,
        torch.where(objness > -0.5, _bce_logits(logit, 0.0), zero))
    match = torch.where(valid, midx, -1).to(torch.int32)
    return {"Loss": pos_loss + obj_loss.sum((1, 2, 3)),
            "ObjectnessMask": objness, "GTMatchMask": match}


# ---------------------------------------------------------------------------
# prior and anchor grids: numpy from shapes and attributes, as in the JAX
# package, made once per plan
# ---------------------------------------------------------------------------

def _grid_const(ctx, boxes, var, device):
    """(boxes, variances) as f32 tensors on ``device`` from numpy arrays of
    one shape, made once per plan where the step may be captured: one
    stacked constant, as ``RunContext.constant`` keeps one a op."""
    both = ctx.constant(lambda: torch.from_numpy(np.ascontiguousarray(
        np.stack([boxes, var]), np.float32)).to(device))
    return both[0], both[1]


@register_op("prior_box", nondiff=("Input", "Image"), differentiable=False)
def _prior_box(ctx, ins, attrs):
    """SSD priors (H, W, P, 4) in [0, 1] image units and their variances
    (paddle_tpu's :18): per cell, each min size at every aspect ratio
    (flipped too with ``flip``), then sqrt(min * max) when max sizes are
    given."""
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", [1.0]):
        ar = float(ar)
        if not any(abs(ar - x) < 1e-6 for x in ars):
            ars.append(ar)
            if attrs.get("flip", True):
                ars.append(1.0 / ar)
    step_w = attrs.get("step_w", 0.0) or iw / w
    step_h = attrs.get("step_h", 0.0) or ih / h
    offset = attrs.get("offset", 0.5)
    boxes = []
    for s in min_sizes:
        for ar in ars:
            boxes.append((s * math.sqrt(ar), s / math.sqrt(ar)))
        if max_sizes:
            ms = max_sizes[min_sizes.index(s)]
            boxes.append((math.sqrt(s * ms), math.sqrt(s * ms)))
    num_priors = len(boxes)
    bw = np.array([b[0] for b in boxes]) / 2.0
    bh = np.array([b[1] for b in boxes]) / 2.0
    cxg, cyg = np.meshgrid((np.arange(w) + offset) * step_w,
                           (np.arange(h) + offset) * step_h)
    out = np.zeros((h, w, num_priors, 4), np.float32)
    out[..., 0] = (cxg[..., None] - bw) / iw
    out[..., 1] = (cyg[..., None] - bh) / ih
    out[..., 2] = (cxg[..., None] + bw) / iw
    out[..., 3] = (cyg[..., None] + bh) / ih
    if attrs.get("clip", True):
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.array(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                           np.float32), (h, w, num_priors, 1))
    boxes_t, var_t = _grid_const(ctx, out, var, feat.device)
    return {"Boxes": boxes_t, "Variances": var_t}


@register_op("anchor_generator", nondiff=("Input",), differentiable=False)
def _anchor_generator(ctx, ins, attrs):
    """Faster R-CNN anchors (H, W, A, 4) in input-image pixels
    (paddle_tpu's :212): centres at idx * stride + offset * (stride - 1),
    the base box of each ratio from the stride cell's area, scaled by
    size / stride."""
    feat = ins["Input"][0]
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(r) for r in attrs.get("aspect_ratios", [1.0])]
    sw, sh = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = float(attrs.get("offset", 0.5))
    aw, ah = [], []
    for ar in ratios:
        base_w = round(math.sqrt(sw * sh / ar))
        base_h = round(base_w * ar)
        for s in sizes:
            aw.append(s / sw * base_w)
            ah.append(s / sh * base_h)
    aw = np.asarray(aw, np.float32)
    ah = np.asarray(ah, np.float32)
    cxg, cyg = np.meshgrid(
        np.arange(w, dtype=np.float32) * sw + offset * (sw - 1),
        np.arange(h, dtype=np.float32) * sh + offset * (sh - 1))
    out = np.empty((h, w, aw.shape[0], 4), np.float32)
    out[..., 0] = cxg[..., None] - 0.5 * (aw - 1)
    out[..., 1] = cyg[..., None] - 0.5 * (ah - 1)
    out[..., 2] = cxg[..., None] + 0.5 * (aw - 1)
    out[..., 3] = cyg[..., None] + 0.5 * (ah - 1)
    var = np.tile(np.asarray(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                             np.float32), (h, w, aw.shape[0], 1))
    anc, var_t = _grid_const(ctx, out, var, feat.device)
    return {"Anchors": anc, "Variances": var_t}


@register_op("density_prior_box", nondiff=("Input", "Image"),
             differentiable=False)
def _density_prior_box(ctx, ins, attrs):
    """Density priors (paddle_tpu's :251): per fixed size a density x
    density grid of shifted centres, one box per fixed ratio, in [0, 1]
    image units; (H * W * P, 4) with ``flatten_to_2d``."""
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    fixed_sizes = [float(s) for s in attrs["fixed_sizes"]]
    fixed_ratios = [float(r) for r in attrs["fixed_ratios"]]
    densities = [int(d) for d in attrs["densities"]]
    step_w = float(attrs.get("step_w", 0.0)) or iw / w
    step_h = float(attrs.get("step_h", 0.0)) or ih / h
    offset = float(attrs.get("offset", 0.5))
    step_avg = int((step_w + step_h) * 0.5)
    offs = []
    for fs, density in zip(fixed_sizes, densities):
        shift = step_avg // density
        for r in fixed_ratios:
            bw = fs * math.sqrt(r)
            bh = fs / math.sqrt(r)
            base = -step_avg / 2.0 + shift / 2.0
            for di in range(density):
                for dj in range(density):
                    offs.append((base + dj * shift, base + di * shift,
                                 bw / 2.0, bh / 2.0))
    offs = np.asarray(offs, np.float32)
    cxg, cyg = np.meshgrid(
        (np.arange(w, dtype=np.float32) + offset) * step_w,
        (np.arange(h, dtype=np.float32) + offset) * step_h)
    px = cxg[..., None] + offs[:, 0]
    py = cyg[..., None] + offs[:, 1]
    out = np.stack([np.maximum((px - offs[:, 2]) / iw, 0.0),
                    np.maximum((py - offs[:, 3]) / ih, 0.0),
                    np.minimum((px + offs[:, 2]) / iw, 1.0),
                    np.minimum((py + offs[:, 3]) / ih, 1.0)], axis=-1)
    if attrs.get("clip", False):
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                             np.float32), (h, w, offs.shape[0], 1))
    out = out.astype(np.float32)
    if attrs.get("flatten_to_2d", False):
        out = out.reshape(-1, 4)
        var = var.reshape(-1, 4)
    boxes_t, var_t = _grid_const(ctx, out, var, feat.device)
    return {"Boxes": boxes_t, "Variances": var_t}


# ---------------------------------------------------------------------------
# box arithmetic
# ---------------------------------------------------------------------------

def _clip(v, lo, hi):
    """``jnp.clip(v, lo, hi)``: maximum with ``lo``, then minimum with
    ``hi`` (tensors), so a value on a bound splits its gradient."""
    return torch.minimum(hi, torch.maximum(lo, v))


@register_op("iou_similarity", nondiff=("X", "Y"), differentiable=False)
def _iou_similarity(ctx, ins, attrs):
    """IoU of every pair of xyxy boxes: X (N, 4), Y (M, 4) -> (N, M)."""
    x, y = ins["X"][0], ins["Y"][0]
    area_x = torch.clamp(x[:, 2] - x[:, 0], min=0) * \
        torch.clamp(x[:, 3] - x[:, 1], min=0)
    area_y = torch.clamp(y[:, 2] - y[:, 0], min=0) * \
        torch.clamp(y[:, 3] - y[:, 1], min=0)
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_x[:, None] + area_y[None, :] - inter
    return {"Out": inter / torch.clamp(union, min=1e-10)}


@register_op("box_coder", nondiff=("PriorBox", "PriorBoxVar", "TargetBox"),
             differentiable=False)
def _box_coder(ctx, ins, attrs):
    """encode_center_size: target boxes (N, 4) against priors (M, 4) ->
    (N, M, 4) deltas over the variances; decode_center_size: deltas
    (N, M, 4) -> xyxy boxes."""
    prior = ins["PriorBox"][0]
    target = ins["TargetBox"][0]
    var = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.ones_like(prior)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if attrs.get("code_type", "encode_center_size") == "encode_center_size":
        tw = target[:, 2] - target[:, 0]
        th = target[:, 3] - target[:, 1]
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / var[None, :, 0],
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / var[None, :, 1],
            torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10)) /
            var[None, :, 2],
            torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10)) /
            var[None, :, 3]], dim=-1)
        return {"OutputBox": out}
    d = target
    cx = d[..., 0] * var[None, :, 0] * pw[None, :] + pcx[None, :]
    cy = d[..., 1] * var[None, :, 1] * ph[None, :] + pcy[None, :]
    w = torch.exp(d[..., 2] * var[None, :, 2]) * pw[None, :]
    h = torch.exp(d[..., 3] * var[None, :, 3]) * ph[None, :]
    return {"OutputBox": torch.stack([cx - w * 0.5, cy - h * 0.5,
                                      cx + w * 0.5, cy + h * 0.5], dim=-1)}


@register_op("box_clip", nondiff=("ImInfo",))
def _box_clip(ctx, ins, attrs):
    """Boxes (N, M, 4) or (M, 4) clipped to [0, dim / scale - 1] of their
    image's ImInfo row (h, w, scale); a coordinate on a bound splits its
    gradient, as ``jnp.clip``'s."""
    boxes = ins["Input"][0]
    im_info = ins["ImInfo"][0]
    squeeze = boxes.dim() == 2
    if squeeze:
        boxes = boxes[None]
    hmax = (im_info[:, 0] / im_info[:, 2] - 1.0)[:, None]
    wmax = (im_info[:, 1] / im_info[:, 2] - 1.0)[:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = torch.stack([_clip(boxes[..., 0], zero, wmax),
                       _clip(boxes[..., 1], zero, hmax),
                       _clip(boxes[..., 2], zero, wmax),
                       _clip(boxes[..., 3], zero, hmax)], dim=-1)
    return {"Output": out[0] if squeeze else out}


@register_op("polygon_box_transform", differentiable=False)
def _polygon_box_transform(ctx, ins, attrs):
    """EAST geometry offsets (N, G, H, W) -> absolute quad coordinates:
    4 * w - x in even channels, 4 * h - x in odd ones."""
    x = ins["Input"][0]
    _, g, h, w = x.shape
    wi = torch.arange(w, dtype=x.dtype, device=x.device)
    hi = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    even = (torch.arange(g, device=x.device) % 2 == 0)[:, None, None]
    return {"Output": torch.where(even, 4.0 * wi - x, 4.0 * hi - x)}


@register_op("box_decoder_and_assign",
             nondiff=("PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"),
             differentiable=False)
def _box_decoder_and_assign(ctx, ins, attrs):
    """Per-class deltas (M, 4 * C) decoded against the priors (+1 pixel
    widths, log-size deltas clipped to ``box_clip``), and each RoI's box
    of its best class from class 1 on (the background column never
    wins)."""
    prior = ins["PriorBox"][0]
    var = ins["PriorBoxVar"][0]
    score = ins["BoxScore"][0]
    clip = float(attrs.get("box_clip", 4.135))
    m, c = score.shape
    d = ins["TargetBox"][0].reshape(m, c, 4)
    if var.dim() == 1:
        var = var.expand(m, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    lo = torch.full((), -clip, dtype=d.dtype, device=d.device)
    hi = torch.full((), clip, dtype=d.dtype, device=d.device)
    dx = d[..., 0] * var[:, None, 0]
    dy = d[..., 1] * var[:, None, 1]
    dw = _clip(d[..., 2] * var[:, None, 2], lo, hi)
    dh = _clip(d[..., 3] * var[:, None, 3], lo, hi)
    cx = dx * pw[:, None] + pcx[:, None]
    cy = dy * ph[:, None] + pcy[:, None]
    bw = torch.exp(dw) * pw[:, None]
    bh = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2,
                           cx + bw / 2 - 1, cy + bh / 2 - 1], -1)
    if c > 1:
        best = torch.argmax(score[:, 1:], dim=1) + 1
    else:
        best = torch.zeros((m,), dtype=torch.long, device=score.device)
    assigned = torch.gather(decoded, 1,
                            best[:, None, None].expand(m, 1, 4))[:, 0]
    return {"DecodeBox": decoded.reshape(m, c * 4),
            "OutputAssignBox": assigned}


# ---------------------------------------------------------------------------
# SSD matching, targets and loss
# ---------------------------------------------------------------------------

def _bipartite_match(dist, match_type, overlap_threshold):
    """Greedy bipartite matching of every image's (R, C) distance matrix
    at once (dist (N, R, C); paddle_tpu's ``_bipartite_match_single``):
    min(R, C) steps, each taking the largest entry (the first in raster
    order) among unused rows and unmatched columns while it exceeds
    1e-6; "per_prediction" then gives a still-unmatched column its best
    row when that distance passes the threshold. A NaN is the largest
    entry to ``torch.argmax`` as to ``jnp.argmax`` and never passes a
    comparison, so an unused NaN stops the matching where the JAX package
    stops it. Returns (col_match int32 (N, C), col_dist (N, C))."""
    n, r, c = dist.shape
    dev = dist.device
    col_match = torch.full((n, c), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((n, c), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((n, r), dtype=torch.bool, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dist.dtype, device=dev)
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    for _ in range(min(r, c)):
        masked = torch.where(row_used[:, :, None] |
                             (col_match[:, None, :] >= 0), ninf, dist)
        flat = masked.reshape(n, r * c)
        at = torch.argmax(flat, dim=1)
        best = torch.gather(flat, 1, at[:, None])[:, 0]
        take = (best > 1e-6)[:, None]
        hit_c = (cols == (at % c)[:, None]) & take
        col_match = torch.where(hit_c, (at // c).to(torch.int32)[:, None],
                                col_match)
        col_dist = torch.where(hit_c, best[:, None], col_dist)
        row_used = row_used | ((rows == (at // c)[:, None]) & take)
    if match_type == "per_prediction":
        best_row = torch.argmax(dist, dim=1).to(torch.int32)
        best_val = torch.amax(dist, dim=1)
        extra = (col_match < 0) & (best_val > overlap_threshold)
        col_match = torch.where(extra, best_row, col_match)
        col_dist = torch.where(extra, best_val, col_dist)
    return col_match, col_dist


@register_op("bipartite_match", nondiff=("DistMat",), differentiable=False)
def _bipartite_match_op(ctx, ins, attrs):
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    m, d = _bipartite_match(dist, attrs.get("match_type", "bipartite"),
                            float(attrs.get("dist_threshold", 0.5)))
    return {"ColToRowMatchIndices": m, "ColToRowMatchDist": d}


@register_op("target_assign", nondiff=("X", "MatchIndices", "NegIndices"),
             differentiable=False)
def _target_assign(ctx, ins, attrs):
    """Out[i, j] = X[i, match[i, j]] where matched, else the mismatch
    value; OutWeight 1 where matched or (NegIndices) negative."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0]
    n, c = match.shape
    safe = torch.clamp(match, min=0).long()
    out = torch.gather(x, 1, safe[..., None].expand(n, c, x.shape[2]))
    mismatch = torch.full((), attrs.get("mismatch_value", 0),
                          dtype=x.dtype, device=x.device)
    out = torch.where((match >= 0)[..., None], out, mismatch)
    wt = (match >= 0).to(torch.float32)[..., None]
    if ins.get("NegIndices"):
        neg = ins["NegIndices"][0]
        wt = torch.maximum(wt, neg.to(torch.float32).reshape(wt.shape))
    return {"Out": out, "OutWeight": wt}


def _rank_of(key):
    """Each entry's position in ``jnp.argsort(key)`` along the last axis
    (stable ascending; the inverse of the sorting permutation)."""
    order = torch.sort(key, dim=-1, stable=True).indices
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


@register_op("mine_hard_examples",
             nondiff=("ClsLoss", "LocLoss", "MatchIndices", "MatchDist"),
             differentiable=False)
def _mine_hard_examples(ctx, ins, attrs):
    """OHEM negatives as a (N, P) 0/1 mask: the ceil(pos * ratio) (or
    ``sample_size``) largest losses among the negatives, ranked by a
    stable ascending sort of -loss (the JAX package's ``argsort(-x)``),
    and the match indices with the picked negatives set to -1."""
    cls_loss = ins["ClsLoss"][0]
    match = ins["MatchIndices"][0]
    loss = cls_loss + ins["LocLoss"][0] if ins.get("LocLoss") else cls_loss
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    mining_type = attrs.get("mining_type", "max_negative")
    sample_size = int(attrs.get("sample_size", 0))
    is_neg = match < 0
    if ins.get("MatchDist") and mining_type == "max_negative":
        is_neg = is_neg & (ins["MatchDist"][0] <
                           float(attrs.get("neg_dist_threshold", 0.5)))
    num_pos = (match >= 0).sum(dim=1)
    if mining_type == "hard_example" and sample_size > 0:
        limit = torch.full_like(num_pos, sample_size)
    else:
        limit = torch.ceil(num_pos * ratio).to(torch.int32)
    ninf = torch.full((), float("-inf"), dtype=loss.dtype, device=loss.device)
    rank = _rank_of(-torch.where(is_neg, loss, ninf))
    sel = is_neg & (rank < limit[:, None])
    upd = torch.where(sel, torch.full_like(match, -1), match)
    return {"NegIndices": sel.to(torch.int32), "UpdatedMatchIndices": upd}


@register_op("ssd_loss", nondiff=("GtBox", "GtLabel", "PriorBox",
                                  "PriorBoxVar"))
def _ssd_loss(ctx, ins, attrs):
    """SSD's multibox loss per prior (N, P), differentiable in Location
    and Confidence (paddle_tpu's :939): ground truths (N, G, 4) zero
    padded, matched to the priors by IoU (``_bipartite_match``, every
    image at once), encoded against the priors; smooth-L1 on the matched
    priors plus softmax CE on them and on the hard negatives, ranked by a
    stable ascending sort of -CE; divided by the batch's matched count
    with ``normalize``."""
    loc = ins["Location"][0]
    conf = ins["Confidence"][0]
    gb = ins["GtBox"][0]
    gl = ins["GtLabel"][0]
    prior = ins["PriorBox"][0].reshape(-1, 4)
    pvar = ins["PriorBoxVar"][0].reshape(-1, 4) if ins.get("PriorBoxVar") \
        else torch.ones((prior.shape[0], 4), dtype=loc.dtype,
                        device=loc.device)
    background = int(attrs.get("background_label", 0))
    neg_overlap = float(attrs.get("neg_overlap", 0.5))
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    mining_type = attrs.get("mining_type", "max_negative")
    sample_size = int(attrs.get("sample_size", 0) or 0)
    if mining_type not in ("max_negative", "hard_example"):
        raise ValueError("ssd_loss: unsupported mining_type %r" % mining_type)
    if gl.dim() == 3:
        gl = gl[..., 0]
    n, p, c = conf.shape
    g = gb.shape[1]
    dev = loc.device
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    valid = ((gb[..., 2] - gb[..., 0]) > 1e-6) & \
        ((gb[..., 3] - gb[..., 1]) > 1e-6)                     # (N, G)
    area_g = torch.clamp(gb[..., 2] - gb[..., 0], min=0) * \
        torch.clamp(gb[..., 3] - gb[..., 1], min=0)
    area_p = torch.clamp(pw, min=0) * torch.clamp(ph, min=0)
    lt = torch.maximum(gb[:, :, None, :2], prior[None, None, :, :2])
    rb = torch.minimum(gb[:, :, None, 2:], prior[None, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area_g[..., None] + area_p - inter, min=1e-10)
    iou = torch.where(valid[..., None], iou, torch.zeros_like(iou))
    match, mdist = _bipartite_match(iou, attrs.get("match_type",
                                                   "per_prediction"),
                                    float(attrs.get("overlap_threshold",
                                                    0.5)))
    matched = match >= 0
    msafe = torch.clamp(match, min=0).long()                 # (N, P)
    gm = torch.gather(gb, 1, msafe[..., None].expand(n, p, 4))
    gw = gm[..., 2] - gm[..., 0]
    gh = gm[..., 3] - gm[..., 1]
    gcx = gm[..., 0] + gw * 0.5
    gcy = gm[..., 1] + gh * 0.5
    enc = torch.stack([
        (gcx - pcx) / pw / pvar[:, 0],
        (gcy - pcy) / ph / pvar[:, 1],
        torch.log(torch.clamp(gw / pw, min=1e-10)) / pvar[:, 2],
        torch.log(torch.clamp(gh / ph, min=1e-10)) / pvar[:, 3]], -1)
    diff = loc - enc
    ad = torch.abs(diff)
    sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5).sum(-1)
    zero = torch.zeros((), dtype=loc.dtype, device=dev)
    loc_loss = torch.where(matched, sl1, zero)
    tlabel = torch.where(matched, torch.gather(gl, 1, msafe).long(),
                         torch.full((), background, dtype=torch.long,
                                    device=dev))
    ce = torch.logsumexp(conf, dim=-1) - \
        torch.gather(conf, -1, tlabel[..., None])[..., 0]
    num_pos = matched.sum(dim=1)
    if mining_type == "hard_example" and sample_size > 0:
        limit = torch.full_like(num_pos, sample_size)
    else:
        limit = torch.ceil(num_pos * ratio).to(torch.int32)
    is_neg = (~matched) & (mdist < neg_overlap)
    ninf = torch.full((), float("-inf"), dtype=ce.dtype, device=dev)
    rank = _rank_of(-torch.where(is_neg, ce.detach(), ninf))
    sel_neg = is_neg & (rank < limit[:, None])
    conf_loss = torch.where(matched | sel_neg, ce, zero)
    loss = float(attrs.get("conf_loss_weight", 1.0)) * conf_loss + \
        float(attrs.get("loc_loss_weight", 1.0)) * loc_loss
    if attrs.get("normalize", True):
        loss = loss / torch.clamp(num_pos.sum(), min=1).to(loss.dtype)
    return {"Loss": loss}


@register_op("sigmoid_focal_loss", nondiff=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, ins, attrs):
    """Focal loss of logits (N, C) against labels in 0..C (0 background,
    -1 ignored), divided by the foreground count (at least 1)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1)
    fg = ins["FgNum"][0].reshape(-1)[0]
    gamma = float(attrs.get("gamma", 2.0))
    alpha = float(attrs.get("alpha", 0.25))
    d = torch.arange(1, x.shape[1] + 1, device=x.device)
    lab = label[:, None]
    c_pos = (lab == d).to(x.dtype)
    c_neg = ((lab != -1) & (lab != d)).to(x.dtype)
    fg_num = torch.clamp(fg, min=1).to(x.dtype)
    p = torch.sigmoid(x)
    tiny = torch.full((), 1e-37, dtype=x.dtype, device=x.device)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(torch.maximum(p, tiny))
    pos_x = (x >= 0).to(x.dtype)
    term_neg = torch.pow(p, gamma) * (
        -x * pos_x - torch.log1p(torch.exp(x - 2.0 * x * pos_x)))
    out = -c_pos * term_pos * (alpha / fg_num) \
        - c_neg * term_neg * ((1.0 - alpha) / fg_num)
    return {"Out": out}


# ---------------------------------------------------------------------------
# RoI pooling
# ---------------------------------------------------------------------------

@register_op("roi_align", nondiff=("ROIs", "RoisNum"))
def _roi_align(ctx, ins, attrs):
    """RoIAlign (paddle_tpu's :432): each bin the mean of an sr x sr grid
    of bilinear samples (a fixed 2 x 2 grid for ``sampling_ratio`` <= 0,
    as the JAX package; the reference adapts it to the RoI's size). The
    four taps of every sample are rows of the map's (N * H * W, C) table,
    so no RoI's copy of the map is made: (R, PH*sr, PW*sr, C) a tap.
    Divisions by the bin and sample counts are products with their f32
    reciprocals (``_recip``): a RoI's corner at ~1,000 pixels moves the
    output by ~1e-4 for one ulp of its bin width."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    n, c, h, w = x.shape
    r = rois.shape[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    sr = int(attrs.get("sampling_ratio", -1))
    if sr <= 0:
        sr = 2
    dev = x.device
    bidx = _batch_index(ins, "RoisNum", r, n, dev)
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    rw = torch.clamp(rois[:, 2] * scale - x1, min=1.0)
    rh = torch.clamp(rois[:, 3] * scale - y1, min=1.0)
    it = (torch.arange(sr, device=dev, dtype=rois.dtype) + 0.5) * _recip(sr)
    gy = y1[:, None, None] + (
        torch.arange(ph, device=dev, dtype=rois.dtype)[None, :, None] +
        it) * (rh * _recip(ph))[:, None, None]
    gx = x1[:, None, None] + (
        torch.arange(pw, device=dev, dtype=rois.dtype)[None, :, None] +
        it) * (rw * _recip(pw))[:, None, None]

    def bilinear_1d(coord, size):
        lo_b = torch.zeros((), dtype=coord.dtype, device=dev)
        hi_b = torch.full((), size - 1.0, dtype=coord.dtype, device=dev)
        coord = _clip(coord.reshape(r, -1), lo_b, hi_b)
        lo = torch.floor(coord)
        return lo.long(), torch.clamp(lo.long() + 1, max=size - 1), \
            coord - lo

    y0, y1i, fy = bilinear_1d(gy, h)                       # (R, PH*S)
    x0, x1i, fx = bilinear_1d(gx, w)                       # (R, PW*S)
    table = _rows(x)
    base = (bidx * (h * w))[:, None, None]

    def tap(yy, xx):
        return table[base + yy[:, :, None] * w + xx[:, None, :]]

    fyb = fy[:, :, None, None]
    fxb = fx[:, None, :, None]
    vals = (tap(y0, x0) * (1 - fyb) * (1 - fxb) +
            tap(y0, x1i) * (1 - fyb) * fxb +
            tap(y1i, x0) * fyb * (1 - fxb) +
            tap(y1i, x1i) * fyb * fxb)                     # (R,PH*S,PW*S,C)
    out = vals.reshape(r, ph, sr, pw, sr, c).sum(dim=(2, 4)) * \
        _recip(sr * sr)
    return {"Out": out.permute(0, 3, 1, 2).contiguous()}


@register_op("roi_pool", nondiff=("ROIs", "RoisNum"))
def _roi_pool(ctx, ins, attrs):
    """RoIPool (paddle_tpu's :493): quantized bins, each the max of its
    pixels, an empty bin 0. Two stages, as in the JAX package: the max
    over each bin's columns, then over its rows, each a masked max over
    the RoI's map whose gradient ``torch.amax`` splits equally among tied
    elements, as ``jnp.max``'s does."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    n, c, h, w = x.shape
    r = rois.shape[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    dev = x.device
    bidx = _batch_index(ins, "RoisNum", r, n, dev)
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale)
    y2 = torch.round(rois[:, 3] * scale)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)

    def bin_mask(start, extent, p, size):
        # (R, P, size): pixels in [start + floor(i e / p),
        #                          start + ceil((i + 1) e / p)), the
        # quotient i e times p's f32 reciprocal (_recip): the JAX
        # package's jitted bins, which an exact i e / p moves at extents
        # a multiple of p does not divide exactly (7 x 7 bins: 413 of
        # 2,793 edges over extents 1-399)
        i = torch.arange(p, dtype=torch.float32, device=dev)
        lo = torch.clamp(start[:, None] + torch.floor(
            i * extent[:, None] * _recip(p)), 0, size)
        hi = torch.clamp(start[:, None] + torch.ceil(
            (i + 1) * extent[:, None] * _recip(p)), 0, size)
        pix = torch.arange(size, dtype=torch.float32, device=dev)
        return (pix >= lo[..., None]) & (pix < hi[..., None])

    mh = bin_mask(y1, rh, ph, h)                           # (R, PH, H)
    mw = bin_mask(x1, rw, pw, w)                           # (R, PW, W)
    xb = x[bidx]                                           # (R, C, H, W)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=dev)
    t = torch.stack([torch.where(mw[:, None, None, j, :], xb, neg).amax(-1)
                     for j in range(pw)], dim=-1)          # (R, C, H, PW)
    out = torch.stack([torch.where(mh[:, None, i, :, None], t, neg).amax(2)
                       for i in range(ph)], dim=2)         # (R, C, PH, PW)
    empty = ~(mh.any(-1)[:, None, :, None] & mw.any(-1)[:, None, None, :])
    return {"Out": torch.where(empty, torch.zeros((), dtype=x.dtype,
                                                  device=dev), out)}


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------

@register_op("generate_proposals",
             nondiff=("Scores", "BboxDeltas", "ImInfo", "Anchors",
                      "Variances"), differentiable=False)
def _generate_proposals(ctx, ins, attrs):
    """RPN proposals with static shapes, every image at once: decode
    (+1 pixel widths, log sizes clipped at log(1000 / 16)), clip to the
    image, mask boxes under ``min_size`` to -inf, keep the ``pre_nms_topN``
    best (``lax.top_k``'s order), greedy NMS (``_nms_alive``: one step a
    candidate), then the ``post_nms_topN`` best survivors, zero padded;
    RpnRoisNum the finite count per image."""
    scores = ins["Scores"][0]                            # (N, A, H, W)
    deltas = ins["BboxDeltas"][0]                        # (N, A*4, H, W)
    im_info = ins["ImInfo"][0]                           # (N, 3)
    n, a, h, w = scores.shape
    anc = ins["Anchors"][0].reshape(-1, 4)
    vr = ins["Variances"][0].reshape(-1, 4)
    total = a * h * w
    pre_n = min(int(attrs.get("pre_nms_topN", 6000)), total)
    post_n = min(int(attrs.get("post_nms_topN", 1000)), pre_n)
    sc = scores.permute(0, 2, 3, 1).reshape(n, total)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, total, 4)
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx = anc[:, 0] + aw * 0.5
    acy = anc[:, 1] + ah * 0.5
    cx = vr[:, 0] * dl[..., 0] * aw + acx
    cy = vr[:, 1] * dl[..., 1] * ah + acy
    clip = torch.full((), math.log(1000.0 / 16.0), dtype=dl.dtype,
                      device=dl.device)
    bw = torch.exp(torch.minimum(vr[:, 2] * dl[..., 2], clip)) * aw
    bh = torch.exp(torch.minimum(vr[:, 3] * dl[..., 3], clip)) * ah
    hmax = (im_info[:, 0] / im_info[:, 2] - 1.0)[:, None]
    wmax = (im_info[:, 1] / im_info[:, 2] - 1.0)[:, None]
    zero = torch.zeros((), dtype=dl.dtype, device=dl.device)
    props = torch.stack([_clip(cx - bw / 2, zero, wmax),
                         _clip(cy - bh / 2, zero, hmax),
                         _clip(cx + bw / 2 - 1, zero, wmax),
                         _clip(cy + bh / 2 - 1, zero, hmax)], -1)
    ms = (float(attrs.get("min_size", 0.1)) * im_info[:, 2])[:, None]
    keep = ((props[..., 2] - props[..., 0] + 1 >= ms) &
            (props[..., 3] - props[..., 1] + 1 >= ms))
    ninf = torch.full((), float("-inf"), dtype=sc.dtype, device=sc.device)
    top_s, idx = _top_k(torch.where(keep, sc, ninf), pre_n)
    pb = torch.gather(props, 1, idx[..., None].expand(n, pre_n, 4))
    alive = _nms_alive(pb, top_s, float(attrs.get("nms_thresh", 0.5)),
                       nms_eta=float(attrs.get("eta", 1.0)))
    out_s, oidx = _top_k(torch.where(alive, top_s, ninf), post_n)
    ob = torch.gather(pb, 1, oidx[..., None].expand(n, post_n, 4))
    good = torch.isfinite(out_s)
    return {"RpnRois": torch.where(good[..., None], ob, zero),
            "RpnRoiProbs": torch.where(good, out_s, zero)[..., None],
            "RpnRoisNum": good.sum(-1).to(torch.int32)}


@register_op("distribute_fpn_proposals", nondiff=("FpnRois", "RoisNum"),
             differentiable=False)
def _distribute_fpn_proposals(ctx, ins, attrs):
    """Each RoI (R, 4) to its FPN level, floor(log2(sqrt(area) /
    refer_scale + 1e-6)) + refer_level clipped: per level the level's
    RoIs first in input order (a stable sort), zero padded to R, and
    their count; RestoreIndex each input RoI's position in the levels'
    concatenation (padding RoIs, past RoisNum, after every level)."""
    rois = ins["FpnRois"][0]
    min_level = int(attrs["min_level"])
    max_level = int(attrs["max_level"])
    refer_level = int(attrs["refer_level"])
    refer_scale = int(attrs["refer_scale"])
    r = rois.shape[0]
    dev = rois.device
    num_lvl = max_level - min_level + 1
    ar = torch.arange(r, device=dev)
    valid = ar < ins["RoisNum"][0].reshape(-1)[0] if ins.get("RoisNum") \
        else torch.ones((r,), dtype=torch.bool, device=dev)
    scale = torch.sqrt(torch.clamp(
        (rois[:, 2] - rois[:, 0] + 1) * (rois[:, 3] - rois[:, 1] + 1),
        min=0.0))
    lvl = torch.floor(torch.log2(scale * _recip(refer_scale) + 1e-6)) + \
        refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    lidx = torch.where(valid, lvl - min_level,
                       torch.full_like(lvl, num_lvl))
    zero = torch.zeros((), dtype=rois.dtype, device=dev)
    multi, nums = [], []
    for i in range(num_lvl):
        mask = lidx == i
        order = torch.sort((~mask).to(torch.uint8), stable=True).indices
        cnt = mask.sum().to(torch.int32)
        multi.append(torch.where((ar < cnt)[:, None], rois[order], zero))
        nums.append(cnt)
    counts = torch.stack(nums)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0).to(torch.int32)])
    same = (lidx[None, :] == lidx[:, None]) & (ar[None, :] < ar[:, None])
    pos = offsets[lidx.long()] + same.sum(1).to(torch.int32)
    return {"MultiFpnRois": multi, "RestoreIndex": pos[:, None],
            "MultiLevelRoIsNum": [cnt[None] for cnt in nums]}


@register_op("collect_fpn_proposals",
             nondiff=("MultiLevelRois", "MultiLevelScores",
                      "MultiLevelRoisNum"), differentiable=False)
def _collect_fpn_proposals(ctx, ins, attrs):
    """The levels' RoIs concatenated and the ``post_nms_topN`` best by
    score (``lax.top_k``'s order; a level's RoIs past its count at
    -inf), zero padded, with the finite count."""
    rois = torch.cat([x.reshape(-1, 4) for x in ins["MultiLevelRois"]], 0)
    scores = torch.cat([x.reshape(-1) for x in ins["MultiLevelScores"]], 0)
    if ins.get("MultiLevelRoisNum"):
        valid = [torch.arange(t.reshape(-1, 4).shape[0], device=t.device) <
                 cnt.reshape(()) for t, cnt in zip(
                     ins["MultiLevelRois"], ins["MultiLevelRoisNum"])]
        scores = torch.where(torch.cat(valid), scores, torch.full(
            (), float("-inf"), dtype=scores.dtype, device=scores.device))
    post_n = min(int(attrs.get("post_nms_topN", 100)), scores.shape[0])
    top_s, idx = _top_k(scores, post_n)
    good = torch.isfinite(top_s)
    return {"FpnRois": torch.where(good[:, None], rois[idx],
                                   torch.zeros((), dtype=rois.dtype,
                                               device=rois.device)),
            "RoisNum": good.sum().to(torch.int32)[None]}
