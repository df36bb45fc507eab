"""YOLOv3's detection layers (counterpart of paddle_tpu/layers/detection.py):
``yolo_box``, ``yolov3_loss`` and ``multiclass_nms``; the SSD, RPN and
RoI layers of the JAX file come with their ops in a later slice."""
from ..layer_helper import LayerHelper


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


__all__ = ["yolo_box", "yolov3_loss", "multiclass_nms"]
