"""YOLOv3's detection ops (counterparts in paddle_tpu/ops/detection_ops.py):
``yolo_box``, ``multiclass_nms`` with its greedy-NMS core
(``_nms_alive``), ``static_nms``, and ``yolov3_loss``.

The JAX package computes them with ``jnp`` and ``lax.fori_loop``, no
Pallas call, so they are plain torch here, with static shapes and no
value read back to the host, so a served request or a training step is
captured into a CUDA graph like any other. Orders that decide results
follow the JAX package exactly: ``jnp.argsort`` (stable, equal scores
lower index first) is a stable descending ``torch.sort``, ``lax.top_k``
(lower index first among ties, -0.0 below 0.0) is ``torch.topk`` of
order keys without ties (``tensor_ops._float_order_key``); the NMS loop
runs its m greedy steps over all images and classes at once. The other
detection ops of the JAX file (SSD, RPN, RoI) are not ported yet.
"""
import torch

from .registry import register_op
from .tensor_ops import _float_order_key


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
    ``jnp.maximum``'s does)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(x, zero) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))


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
           torch.abs(cell[..., 2] - tw) + torch.abs(cell[..., 3] - th)) * \
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
