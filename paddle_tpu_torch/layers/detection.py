"""Detection layers (counterpart of paddle_tpu/layers/detection.py, whose
functions, signatures and parameter names these are, so
``io.set_params_from_numpy`` copies a JAX-built model's weights across):
the SSD head (``prior_box``, ``density_prior_box``, ``multi_box_head``,
``box_coder``, ``bipartite_match``, ``target_assign``, ``ssd_loss``,
``detection_output``), YOLOv3's, the NMS family, the RPN and RoI layers
of Faster and Mask R-CNN, RetinaNet's and EAST's. A reference output of
variable length (a LoD tensor) is a fixed-capacity tensor with counts or
masks, as in the JAX package.
"""
from ..layer_helper import LayerHelper

__all__ = [
    'prior_box', 'density_prior_box', 'multi_box_head', 'anchor_generator',
    'bipartite_match', 'target_assign', 'detection_output', 'ssd_loss',
    'sigmoid_focal_loss', 'iou_similarity', 'box_coder',
    'polygon_box_transform', 'yolov3_loss', 'yolo_box', 'box_clip',
    'multiclass_nms', 'distribute_fpn_proposals', 'collect_fpn_proposals',
    'box_decoder_and_assign', 'generate_proposals', 'roi_align', 'roi_pool',
    'rpn_target_assign', 'retinanet_target_assign',
    'generate_proposal_labels', 'locality_aware_nms',
    'retinanet_detection_output', 'roi_perspective_transform',
    'generate_mask_labels',
]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    shape = None
    if x.shape is not None and y.shape is not None:
        shape = (x.shape[0], y.shape[0])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op("iou_similarity", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    out.stop_gradient = True
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None and hasattr(prior_box_var, "name"):
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized, "axis": axis})
    out.stop_gradient = True
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    dtype = input.dtype
    box = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "prior_box", inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [box.name], "Variances": [var.name]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    box.stop_gradient = var.stop_gradient = True
    return box, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    dtype = input.dtype
    box = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "density_prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [box.name], "Variances": [var.name]},
        attrs={"densities": list(densities), "fixed_sizes": list(fixed_sizes),
               "fixed_ratios": list(fixed_ratios), "variances": list(variance),
               "clip": clip, "step_w": steps[0], "step_h": steps[1],
               "offset": offset, "flatten_to_2d": flatten_to_2d})
    box.stop_gradient = var.stop_gradient = True
    return box, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    dtype = input.dtype
    anchor = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "anchor_generator", inputs={"Input": [input.name]},
        outputs={"Anchors": [anchor.name], "Variances": [var.name]},
        attrs={"anchor_sizes": list(anchor_sizes or [64., 128., 256., 512.]),
               "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
               "variances": list(variance),
               "stride": list(stride or [16.0, 16.0]), "offset": offset})
    anchor.stop_gradient = var.stop_gradient = True
    return anchor, var


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_distance = helper.create_variable_for_type_inference(
        dist_matrix.dtype)
    helper.append_op(
        "bipartite_match", inputs={"DistMat": [dist_matrix.name]},
        outputs={"ColToRowMatchIndices": [match_indices.name],
                 "ColToRowMatchDist": [match_distance.name]},
        attrs={"match_type": "bipartite" if match_type is None
               else match_type,
               "dist_threshold": 0.5 if dist_threshold is None
               else dist_threshold})
    match_indices.stop_gradient = match_distance.stop_gradient = True
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op("target_assign", inputs=inputs,
                     outputs={"Out": [out.name],
                              "OutWeight": [out_weight.name]},
                     attrs={"mismatch_value": 0 if mismatch_value is None
                            else mismatch_value})
    out.stop_gradient = out_weight.stop_gradient = True
    return out, out_weight


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("box_clip", inputs={"Input": [input.name],
                                         "ImInfo": [im_info.name]},
                     outputs={"Output": [out.name]})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("polygon_box_transform", inputs={"Input": [input.name]},
                     outputs={"Output": [out.name]})
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("yolo_box",
                     inputs={"X": [x.name], "ImgSize": [img_size.name]},
                     outputs={"Boxes": [boxes.name], "Scores": [scores.name]},
                     attrs={"anchors": list(anchors), "class_num": class_num,
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    boxes.stop_gradient = scores.stop_gradient = True
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    objness = helper.create_variable_for_type_inference(x.dtype)
    match = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [x.name], "GTBox": [gt_box.name],
              "GTLabel": [gt_label.name]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score.name]
    helper.append_op(
        "yolov3_loss", inputs=inputs,
        outputs={"Loss": [loss.name], "ObjectnessMask": [objness.name],
                 "GTMatchMask": [match.name]},
        attrs={"anchors": list(anchors), "anchor_mask": list(anchor_mask),
               "class_num": class_num, "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio,
               "use_label_smooth": use_label_smooth})
    objness.stop_gradient = match.stop_gradient = True
    return loss


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sigmoid_focal_loss",
                     inputs={"X": [x.name], "Label": [label.name],
                             "FgNum": [fg_num.name]},
                     outputs={"Out": [out.name]},
                     attrs={"gamma": gamma, "alpha": alpha})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             name=None):
    """Dense-gt SSD loss: gt_box (N, G, 4) zero-padded, gt_label (N, G)."""
    helper = LayerHelper("ssd_loss", name=name)
    loss = helper.create_variable_for_type_inference(location.dtype)
    inputs = {"Location": [location.name], "Confidence": [confidence.name],
              "GtBox": [gt_box.name], "GtLabel": [gt_label.name],
              "PriorBox": [prior_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op(
        "ssd_loss", inputs=inputs, outputs={"Loss": [loss.name]},
        attrs={"background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
               "loc_loss_weight": loc_loss_weight,
               "conf_loss_weight": conf_loss_weight,
               "match_type": match_type, "mining_type": mining_type,
               "normalize": normalize, "sample_size": sample_size or 0})
    return loss


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, return_index=False, name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    index = helper.create_variable_for_type_inference("int32")
    nums = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "multiclass_nms",
        inputs={"BBoxes": [bboxes.name], "Scores": [scores.name]},
        outputs={"Out": [out.name], "Index": [index.name],
                 "NmsRoisNum": [nums.name]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label})
    out.stop_gradient = index.stop_gradient = nums.stop_gradient = True
    if return_index:
        return out, index
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """SSD inference head (reference layers/detection.py detection_output):
    decode loc deltas against priors then multiclass NMS. `scores` are
    post-softmax (N, P, C)."""
    from . import nn as _nn
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores_t = _nn.transpose(scores, perm=[0, 2, 1])     # (N, C, P)
    return multiclass_nms(decoded, scores_t, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD multibox head (reference layers/detection.py multi_box_head):
    per feature map a 3x3 conv for loc (+4/prior) and conf (+C/prior),
    priors from prior_box; outputs concatenated over maps."""
    from . import nn as _nn
    from . import tensor as _tensor
    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio interpolation
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes, vars_ = [], [], [], []
    for i, inp in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else None
        if not isinstance(min_size, (list, tuple)):
            min_size = [min_size]
        ar = aspect_ratios[i]
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        st = steps[i] if steps else (
            [step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0])
        if not isinstance(st, (list, tuple)):
            st = [st, st]
        box, var = prior_box(inp, image, min_size,
                             [max_size] if max_size else None, ar, variance,
                             flip, clip, st, offset)
        # same flip/dedup expansion as the prior_box kernel so the conv
        # channel count matches the kernel's prior count
        ars = [1.0]
        for a in ar:
            if not any(abs(a - x) < 1e-6 for x in ars):
                ars.append(a)
                if flip:
                    ars.append(1.0 / a)
        num_priors = len(min_size) * len(ars) + \
            (len(min_size) if max_size else 0)
        loc = _nn.conv2d(inp, num_priors * 4, kernel_size, padding=pad,
                         stride=stride)
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = _nn.reshape(loc, shape=[0, -1, 4])
        conf = _nn.conv2d(inp, num_priors * num_classes, kernel_size,
                          padding=pad, stride=stride)
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = _nn.reshape(conf, shape=[0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes.append(_nn.reshape(box, shape=[-1, 4]))
        vars_.append(_nn.reshape(var, shape=[-1, 4]))

    mbox_locs = _tensor.concat(locs, axis=1)
    mbox_confs = _tensor.concat(confs, axis=1)
    box = _tensor.concat(boxes, axis=0)
    var = _tensor.concat(vars_, axis=0)
    return mbox_locs, mbox_confs, box, var


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = helper.create_variable_for_type_inference(prior_box.dtype)
    assigned = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(
        "box_decoder_and_assign",
        inputs={"PriorBox": [prior_box.name],
                "PriorBoxVar": [prior_box_var.name],
                "TargetBox": [target_box.name],
                "BoxScore": [box_score.name]},
        outputs={"DecodeBox": [decoded.name],
                 "OutputAssignBox": [assigned.name]},
        attrs={"box_clip": box_clip})
    decoded.stop_gradient = assigned.stop_gradient = True
    return decoded, assigned


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    nums = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "generate_proposals",
        inputs={"Scores": [scores.name], "BboxDeltas": [bbox_deltas.name],
                "ImInfo": [im_info.name], "Anchors": [anchors.name],
                "Variances": [variances.name]},
        outputs={"RpnRois": [rois.name], "RpnRoiProbs": [probs.name],
                 "RpnRoisNum": [nums.name]},
        attrs={"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta})
    rois.stop_gradient = probs.stop_gradient = nums.stop_gradient = True
    if return_rois_num:
        return rois, probs, nums
    return rois, probs


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    num_lvl = max_level - min_level + 1
    multi_rois = [helper.create_variable_for_type_inference(fpn_rois.dtype)
                  for _ in range(num_lvl)]
    restore = helper.create_variable_for_type_inference("int32")
    lvl_nums = [helper.create_variable_for_type_inference("int32")
                for _ in range(num_lvl)]
    inputs = {"FpnRois": [fpn_rois.name]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num.name]
    helper.append_op(
        "distribute_fpn_proposals", inputs=inputs,
        outputs={"MultiFpnRois": [v.name for v in multi_rois],
                 "RestoreIndex": [restore.name],
                 "MultiLevelRoIsNum": [v.name for v in lvl_nums]},
        attrs={"min_level": min_level, "max_level": max_level,
               "refer_level": refer_level, "refer_scale": refer_scale})
    for v in multi_rois + lvl_nums + [restore]:
        v.stop_gradient = True
    if rois_num is not None:
        return multi_rois, restore, lvl_nums
    return multi_rois, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None, name=None):
    helper = LayerHelper("collect_fpn_proposals", name=name)
    out = helper.create_variable_for_type_inference(multi_rois[0].dtype)
    nums = helper.create_variable_for_type_inference("int32")
    inputs = {"MultiLevelRois": [v.name for v in multi_rois],
              "MultiLevelScores": [v.name for v in multi_scores]}
    if rois_num_per_level is not None:
        inputs["MultiLevelRoisNum"] = [v.name for v in rois_num_per_level]
    helper.append_op("collect_fpn_proposals", inputs=inputs,
                     outputs={"FpnRois": [out.name], "RoisNum": [nums.name]},
                     attrs={"post_nms_topN": post_nms_top_n})
    out.stop_gradient = nums.stop_gradient = True
    if rois_num_per_level is not None:
        return out, nums
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num.name]
    helper.append_op("roi_align", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_num=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num.name]
    helper.append_op("roi_pool", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """RPN training targets (ref detection.py rpn_target_assign /
    rpn_target_assign_op.cc).  Dense form: gt_boxes (B, G, 4)
    zero-padded; returns per-anchor tensors instead of LoD-compacted
    samples — (scores_pred, loc_pred, labels (B, A), bbox_targets
    (B, A, 4), bbox_inside_weights); multiply losses by the weights /
    mask on labels >= 0 to reproduce the sampled-minibatch loss."""
    helper = LayerHelper("rpn_target_assign")
    a = anchor_box.shape[0] if anchor_box.shape else None
    b = gt_boxes.shape[0] if gt_boxes.shape else None
    labels = helper.create_variable_for_type_inference("int32", (b, a))
    tgt = helper.create_variable_for_type_inference("float32", (b, a, 4))
    inw = helper.create_variable_for_type_inference("float32", (b, a, 4))
    outw = helper.create_variable_for_type_inference("float32",
                                                     (b, a, 4))
    inputs = {"Anchor": [anchor_box.name], "AnchorVar": [anchor_var.name],
              "GtBoxes": [gt_boxes.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if im_info is not None:
        inputs["ImInfo"] = [im_info.name]
    helper.append_op(
        "rpn_target_assign", inputs=inputs,
        outputs={"Labels": [labels.name], "BBoxTargets": [tgt.name],
                 "BBoxInsideWeights": [inw.name],
                 "BBoxOutsideWeights": [outw.name]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random})
    for v in (labels, tgt, inw, outw):
        v.stop_gradient = True
    return cls_logits, bbox_pred, labels, tgt, inw


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                            anchor_var, gt_boxes, gt_labels, is_crowd=None,
                            im_info=None, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4):
    """RetinaNet training targets (ref detection.py
    retinanet_target_assign): labels carry the 1-based gt class; no
    subsampling (focal loss owns the imbalance).  Returns
    (cls_logits, bbox_pred, labels (B, A), bbox_targets, inside_w,
    fg_num (B, 1))."""
    helper = LayerHelper("retinanet_target_assign")
    a = anchor_box.shape[0] if anchor_box.shape else None
    b = gt_boxes.shape[0] if gt_boxes.shape else None
    labels = helper.create_variable_for_type_inference("int32", (b, a))
    tgt = helper.create_variable_for_type_inference("float32", (b, a, 4))
    inw = helper.create_variable_for_type_inference("float32", (b, a, 4))
    outw = helper.create_variable_for_type_inference("float32",
                                                     (b, a, 4))
    fg = helper.create_variable_for_type_inference("int32", (b, 1))
    inputs = {"Anchor": [anchor_box.name], "AnchorVar": [anchor_var.name],
              "GtBoxes": [gt_boxes.name], "GtLabels": [gt_labels.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if im_info is not None:
        inputs["ImInfo"] = [im_info.name]
    helper.append_op(
        "retinanet_target_assign", inputs=inputs,
        outputs={"Labels": [labels.name], "BBoxTargets": [tgt.name],
                 "BBoxInsideWeights": [inw.name],
                 "BBoxOutsideWeights": [outw.name],
                 "ForegroundNumber": [fg.name]},
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap})
    for v in (labels, tgt, inw, outw, fg):
        v.stop_gradient = True
    return cls_logits, bbox_pred, labels, tgt, inw, fg


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=512,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False,
                             is_cascade_rcnn=False):
    """Second-stage RoI sampling (ref detection.py
    generate_proposal_labels).  Dense form: rois (B, R, 4); returns
    (rois, labels (B, R) {-1,0,class}, bbox_targets (B, R, 4),
    inside_w, outside_w)."""
    if is_cls_agnostic or is_cascade_rcnn:
        raise NotImplementedError(
            "generate_proposal_labels: is_cls_agnostic / "
            "is_cascade_rcnn modes are not implemented in the dense "
            "redesign")
    helper = LayerHelper("generate_proposal_labels")
    b = rpn_rois.shape[0] if rpn_rois.shape else None
    r = rpn_rois.shape[1] if rpn_rois.shape else None
    rois = helper.create_variable_for_type_inference("float32",
                                                     (b, r, 4))
    labels = helper.create_variable_for_type_inference("int32", (b, r))
    tgt = helper.create_variable_for_type_inference("float32", (b, r, 4))
    inw = helper.create_variable_for_type_inference("float32", (b, r, 4))
    outw = helper.create_variable_for_type_inference("float32",
                                                     (b, r, 4))
    inputs = {"RpnRois": [rpn_rois.name], "GtClasses": [gt_classes.name],
              "GtBoxes": [gt_boxes.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if im_info is not None:
        inputs["ImInfo"] = [im_info.name]
    helper.append_op(
        "generate_proposal_labels", inputs=inputs,
        outputs={"Rois": [rois.name], "Labels": [labels.name],
                 "BBoxTargets": [tgt.name],
                 "BBoxInsideWeights": [inw.name],
                 "BBoxOutsideWeights": [outw.name]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi,
               "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "use_random": use_random})
    for v in (rois, labels, tgt, inw, outw):
        v.stop_gradient = True
    return rois, labels, tgt, inw, outw


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """EAST-style locality-aware NMS (ref detection.py
    locality_aware_nms): score-weighted merge of consecutive
    overlapping boxes, then standard NMS.  bboxes (N, M, 4), scores
    (N, C, M) -> (N, keep_top_k, 6)."""
    helper = LayerHelper("locality_aware_nms", name=name)
    n = bboxes.shape[0] if bboxes.shape else None
    out = helper.create_variable_for_type_inference(
        "float32", (n, keep_top_k, 6))
    helper.append_op(
        "locality_aware_nms",
        inputs={"BBoxes": [bboxes.name], "Scores": [scores.name]},
        outputs={"Out": [out.name]},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label})
    out.stop_gradient = True
    return out


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet inference head (ref detection.py
    retinanet_detection_output): per-FPN-level deltas/scores/anchors
    lists; decode + clip + class NMS -> (B, keep_top_k, 6)."""
    helper = LayerHelper("retinanet_detection_output")
    b = bboxes[0].shape[0] if bboxes[0].shape else None
    out = helper.create_variable_for_type_inference(
        "float32", (b, keep_top_k, 6))
    helper.append_op(
        "retinanet_detection_output",
        inputs={"BBoxes": [v.name for v in bboxes],
                "Scores": [v.name for v in scores],
                "Anchors": [v.name for v in anchors],
                "ImInfo": [im_info.name]},
        outputs={"Out": [out.name]},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "nms_eta": nms_eta})
    out.stop_gradient = True
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    """Perspective roi crops for rotated-text heads (ref detection.py
    roi_perspective_transform).  Dense form: rois (B, R, 8) quads ->
    (B, R, C, out_h, out_w)."""
    helper = LayerHelper("roi_perspective_transform")
    b = input.shape[0] if input.shape else None
    r = rois.shape[1] if rois.shape else None
    c = input.shape[1] if input.shape else None
    out = helper.create_variable_for_type_inference(
        input.dtype, (b, r, c, transformed_height, transformed_width))
    helper.append_op(
        "roi_perspective_transform",
        inputs={"X": [input.name], "ROIs": [rois.name]},
        outputs={"Out": [out.name]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_boxes=None):
    """Mask-RCNN mask targets (ref detection.py generate_mask_labels).
    Dense contract: gt_segms (B, G, S, S) bitmaps registered to
    gt_boxes (B, G, 4); rois (B, R, 4); labels_int32 (B, R) from
    generate_proposal_labels.  Returns (mask_rois, roi_has_mask_int32,
    mask_int32 (B, R, num_classes*res*res), -1 = ignore)."""
    if gt_boxes is None:
        raise ValueError(
            "dense generate_mask_labels needs gt_boxes (B, G, 4): the "
            "bitmaps in gt_segms are registered to them")
    helper = LayerHelper("generate_mask_labels")
    b = rois.shape[0] if rois.shape else None
    r = rois.shape[1] if rois.shape else None
    mask_rois = helper.create_variable_for_type_inference(
        "float32", (b, r, 4))
    has_mask = helper.create_variable_for_type_inference("int32", (b, r))
    mask = helper.create_variable_for_type_inference(
        "int32", (b, r, num_classes * resolution * resolution))
    inputs = {"ImInfo": [im_info.name], "GtClasses": [gt_classes.name],
              "GtSegms": [gt_segms.name], "Rois": [rois.name],
              "LabelsInt32": [labels_int32.name],
              "GtBoxes": [gt_boxes.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    helper.append_op(
        "generate_mask_labels", inputs=inputs,
        outputs={"MaskRois": [mask_rois.name],
                 "RoiHasMaskInt32": [has_mask.name],
                 "MaskInt32": [mask.name]},
        attrs={"num_classes": num_classes, "resolution": resolution})
    for v in (mask_rois, has_mask, mask):
        v.stop_gradient = True
    return mask_rois, has_mask, mask
