"""Metric layers (counterpart of paddle_tpu/layers/metric_op.py)."""
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from .nn import topk


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k=k)
    acc = helper.create_variable_for_type_inference("float32", (1,))
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", (1,))
    if total is None:
        total = helper.create_variable_for_type_inference("int32", (1,))
    helper.append_op(
        "accuracy",
        inputs={"Out": [values.name], "Indices": [indices.name],
                "Label": [label.name]},
        outputs={"Accuracy": [acc.name], "Correct": [correct.name],
                 "Total": [total.name]})
    acc.stop_gradient = True
    return acc


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming AUC of ``input``'s last column against ``label``: the
    histograms are int64 persistables (``<name>_stat_pos``,
    ``<name>_stat_neg``, zero in the startup program) that the op reads
    and writes back; returns (AUC, [StatPos, StatNeg])."""
    helper = LayerHelper("auc")
    stats = []
    for kind in ("pos", "neg"):
        stat = helper.create_or_get_global_variable(
            name="%s_stat_%s" % (helper.name, kind), dtype="int64",
            shape=(num_thresholds + 1,), persistable=True)
        helper.set_variable_initializer(stat, ConstantInitializer(0.0))
        stats.append(stat)
    auc_out = helper.create_variable_for_type_inference("float32", (1,))
    helper.append_op(
        "auc",
        inputs={"Predict": [input.name], "Label": [label.name],
                "StatPos": [stats[0].name], "StatNeg": [stats[1].name]},
        outputs={"AUC": [auc_out.name], "StatPosOut": [stats[0].name],
                 "StatNegOut": [stats[1].name]},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    auc_out.stop_gradient = True
    return auc_out, stats


__all__ = ["accuracy", "auc"]
