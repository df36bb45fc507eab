"""Loss layers (counterpart of paddle_tpu/layers/loss.py) for the losses
BERT, GPT, ResNet, DeepFM, CRNN-CTC and the vision classifiers use."""
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


__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "fused_mlm_head_loss",
           "sigmoid_cross_entropy_with_logits", "warpctc"]
