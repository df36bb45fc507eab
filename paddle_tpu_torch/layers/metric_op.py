"""Metric layers (counterpart of paddle_tpu/layers/metric_op.py)."""
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


__all__ = ["accuracy"]
