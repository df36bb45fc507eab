"""Loss layers (counterpart of paddle_tpu/layers/loss.py, the whole
file since the op library's slice)."""
from ..layer_helper import LayerHelper


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = tuple(input.shape[:-1]) + (1,) if input.shape else None
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype,
                                                        logits.shape)
    loss_shape = None
    if logits.shape is not None:
        loss_shape = list(logits.shape)
        loss_shape[axis] = 1
        loss_shape = tuple(loss_shape)
    loss = helper.create_variable_for_type_inference(logits.dtype, loss_shape)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits.name], "Label": [label.name]},
        outputs={"Softmax": [softmax.name], "Loss": [loss.name]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def fused_mlm_head_loss(hidden, weight, label, bias=None, cast_bf16=False):
    """LM/MLM head ``hidden (T, D) @ weight^T (+ bias)`` and per-token
    softmax CE loss ``(T, 1)`` in one op; ``weight`` is the (V, D) tied
    embedding table, ``cast_bf16`` runs the projection from bf16 inputs
    with f32 sums."""
    helper = LayerHelper("fused_mlm_head_loss")
    t = hidden.shape[0] if hidden.shape else None
    loss = helper.create_variable_for_type_inference(
        "float32", (t, 1) if t is not None else None)
    inputs = {"Hidden": [hidden.name], "Weight": [weight.name],
              "Label": [label.name]}
    if bias is not None:
        inputs["Bias"] = [bias.name]
    helper.append_op(
        "fused_mlm_head_loss", inputs=inputs,
        outputs={"Loss": [loss.name]},
        attrs={"cast_bf16": bool(cast_bf16)})
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss (N, 1) on the dense, padded convention: ``input`` (T, N,
    C) time-major unnormalised logits (softmax applied inside, as
    warp-ctc does), ``label`` (N, Lmax), per-example ``input_length`` and
    ``label_length``."""
    helper = LayerHelper("warpctc")
    n = input.shape[1] if input.shape is not None else None
    out = helper.create_variable_for_type_inference(
        input.dtype, (n, 1) if n is not None else None)
    inputs = {"Logits": [input.name], "Label": [label.name]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length.name]
    if label_length is not None:
        inputs["LabelLength"] = [label_length.name]
    helper.append_op("warpctc", inputs=inputs, outputs={"Loss": [out.name]},
                     attrs={"blank": int(blank),
                            "norm_by_times": bool(norm_by_times)})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("square_error_cost",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [loss.name], "Diff": [diff.name]},
                     attrs={"sigma": sigma or 1.0})
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    loss = helper.create_variable_for_type_inference(input.dtype)
    resid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("huber_loss",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [loss.name], "Residual": [resid.name]},
                     attrs={"delta": float(delta)})
    return loss


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("log_loss",
                     inputs={"Predicted": [input.name],
                             "Labels": [label.name]},
                     outputs={"Loss": [loss.name]},
                     attrs={"epsilon": float(epsilon)})
    return loss


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("kldiv_loss",
                     inputs={"X": [x.name], "Target": [target.name]},
                     outputs={"Loss": [loss.name]},
                     attrs={"reduction": reduction})
    return loss


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    shape = (input.shape[0], 1) if input.shape else None
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op("bpr_loss",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype, left.shape)
    act = helper.create_variable_for_type_inference(left.dtype, left.shape)
    helper.append_op("margin_rank_loss",
                     inputs={"X1": [left.name], "X2": [right.name],
                             "Label": [label.name]},
                     outputs={"Out": [out.name], "Activated": [act.name]},
                     attrs={"margin": float(margin)})
    return out


def mse_loss(input, label):
    helper = LayerHelper("mse_loss")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("mse_loss",
                     inputs={"Input": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def rank_loss(label, left, right, name=None):
    """RankNet pairwise loss (ref layers/loss.py:1260 rank_loss):
    sigmoid CE on (left - right) with label in {0, 1}."""
    from .nn import elementwise_sub
    diff = elementwise_sub(left, right)
    return sigmoid_cross_entropy_with_logits(diff, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair metric loss (ref layers/loss.py:1588): soft-label softmax CE
    on the anchor/positive similarity matrix + Beta*l2_reg embedding L2."""
    from .nn import (reshape, expand, transpose, matmul, reduce_sum,
                     reduce_mean, elementwise_div, elementwise_add, scale,
                     cast)
    from .ops import square
    from .control_flow import equal
    beta = 0.25
    n = labels.shape[0]
    lab = reshape(labels, [n, 1])
    lab = expand(lab, [1, n])
    same = cast(equal(lab, transpose(lab, [1, 0])), "float32")
    soft = elementwise_div(same, reduce_sum(same, dim=1, keep_dim=True))
    l2 = scale(elementwise_add(
        reduce_mean(reduce_sum(square(anchor), dim=1)),
        reduce_mean(reduce_sum(square(positive), dim=1))),
        scale=beta * float(l2_reg))
    sim = matmul(anchor, positive, transpose_y=True)
    ce = softmax_with_cross_entropy(sim, soft, soft_label=True)
    return elementwise_add(reduce_mean(ce), l2)


def teacher_student_sigmoid_loss(input, label,
                                 soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """CTR distillation loss (ref layers/loss.py:1437 +
    teacher_student_sigmoid_loss_op.h label-encoding cases)."""
    from .nn import clip
    x = clip(input, soft_max_lower_bound, soft_max_up_bound)
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("teacher_student_sigmoid_loss",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Y": [out.name]})
    return out


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """Class-center clustering loss with in-graph center updates (ref
    layers/loss.py:53 center_loss + center_loss_op.h)."""
    from .. import initializer as init_mod
    from . import tensor as T
    helper = LayerHelper("center_loss", param_attr=param_attr)
    dim = input.shape[-1]
    centers = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_classes, dim], dtype=str(input.dtype),
        default_initializer=init_mod.Constant(0.0))
    centers.trainable = False        # updated by the op, not the optimizer
    rate = T.fill_constant([1], "float32", float(alpha))
    loss = helper.create_variable_for_type_inference(input.dtype)
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "center_loss",
        inputs={"X": [input.name], "Label": [label.name],
                "Centers": [centers.name],
                "CenterUpdateRate": [rate.name]},
        outputs={"Loss": [loss.name], "SampleCenterDiff": [diff.name],
                 "CentersOut": [centers.name]},
        attrs={"update_center": bool(update_center)})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance (ref layers/loss.py:352), dense (N, T) ids +
    optional lengths; ignored_tokens is not supported (filter host-side)."""
    if ignored_tokens:
        raise NotImplementedError(
            "edit_distance ignored_tokens: filter tokens in the data "
            "pipeline (dense/static design)")
    helper = LayerHelper("edit_distance")
    inputs = {"Hyps": [input.name], "Refs": [label.name]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length.name]
    if label_length is not None:
        inputs["RefsLength"] = [label_length.name]
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op("edit_distance", inputs=inputs,
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_num.name]},
                     attrs={"normalized": bool(normalized)})
    return out, seq_num


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss with its own weight/bias params
    (ref layers/loss.py:624 nce). custom_dist is unsupported (uniform /
    log_uniform samplers only)."""
    if custom_dist is not None:
        raise NotImplementedError("nce custom_dist sampler")
    if sample_weight is not None:
        raise NotImplementedError("nce sample_weight (weight examples in "
                                  "the data pipeline instead)")
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=str(input.dtype))
    inputs = {"Input": [input.name], "Label": [label.name],
              "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[num_total_classes, 1],
                                    dtype=str(input.dtype), is_bias=True)
        inputs["Bias"] = [b.name]
    cost = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("nce", inputs=inputs,
                     outputs={"Cost": [cost.name]},
                     attrs={"num_total_classes": int(num_total_classes),
                            "num_neg_samples": int(num_neg_samples),
                            "sampler": sampler})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None,
             is_custom=False, is_sparse=False):
    """Hierarchical sigmoid over the default complete binary tree (ref
    layers/loss.py:838 hsigmoid). Custom trees (path_table/path_code) are
    unsupported."""
    if is_custom or path_table is not None or path_code is not None:
        raise NotImplementedError("hsigmoid custom trees")
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_classes - 1, dim],
                                dtype=str(input.dtype))
    inputs = {"X": [input.name], "Label": [label.name], "W": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[num_classes - 1, 1],
                                    dtype=str(input.dtype), is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out.name], "PreOut": [pre.name]},
                     attrs={"num_classes": int(num_classes)})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Softmax CE over true + sampled classes (ref layers/loss.py:999).
    seed is ignored: sampling uses the Executor's seeded per-op
    generator."""
    if use_customized_samples:
        raise NotImplementedError("customized samples")
    if num_true != 1:
        raise NotImplementedError("sampled softmax with num_true != 1")
    if not remove_accidental_hits:
        raise NotImplementedError(
            "remove_accidental_hits=False (the kernel always masks "
            "accidental hits)")
    helper = LayerHelper("sampled_softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("sampled_softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name],
                             "Label": [label.name]},
                     outputs={"Loss": [loss.name]},
                     attrs={"num_samples": int(num_samples)})
    return loss


__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "fused_mlm_head_loss",
           "sigmoid_cross_entropy_with_logits", "warpctc",
           "square_error_cost", "smooth_l1", "huber_loss",
           "log_loss", "kldiv_loss", "bpr_loss",
           "margin_rank_loss", "mse_loss", "rank_loss",
           "npair_loss", "teacher_student_sigmoid_loss",
           "center_loss", "edit_distance", "nce", "hsigmoid",
           "sampled_softmax_with_cross_entropy"]
