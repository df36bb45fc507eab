"""Metric op kernels (counterpart of paddle_tpu/ops/metric_ops.py)."""
import torch

from .registry import register_op


@register_op("accuracy", nondiff=("Out", "Indices", "Label"),
             differentiable=False)
def _accuracy(ctx, ins, attrs):
    """Top-k accuracy; every output is made on the device (the row count
    as a fill), so a captured step holds no host copy."""
    indices = ins["Indices"][0]          # (N, k) top-k indices
    label = ins["Label"][0].reshape(-1, 1)
    num_correct = (indices == label).any(dim=1).float().sum()
    total = indices.shape[0]
    return {"Accuracy": (num_correct / total).reshape((1,)),
            "Correct": num_correct.to(torch.int32).reshape((1,)),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}
