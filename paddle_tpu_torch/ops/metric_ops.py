"""Metric op kernels: accuracy, auc (counterpart of
paddle_tpu/ops/metric_ops.py)."""
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


@register_op("auc", nondiff=("Predict", "Label", "StatPos", "StatNeg"),
             differentiable=False)
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over binned histograms, the JAX op's algorithm:
    each score goes to bin ``clip(int(score * num_thresholds), 0,
    num_thresholds)`` of StatPos (label > 0) or StatNeg; the updated
    histograms are integrated by the trapezoid rule from the highest
    threshold down. The histograms stay int64, as Paddle keeps them, and
    the integral is float64, on the device (the JAX package, without
    64-bit mode, has int32 bins and f32 sums). StatPosOut and StatNegOut
    name the same persistables as StatPos and StatNeg."""
    predict = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = attrs.get("num_thresholds", 4095)
    score = predict[:, -1] if predict.dim() == 2 else predict.reshape(-1)
    idx = torch.clamp((score * num_thresholds).to(torch.int32), 0,
                      num_thresholds).long()
    positive = label > 0
    stat_pos = stat_pos.index_add(0, idx, positive.to(stat_pos.dtype))
    stat_neg = stat_neg.index_add(0, idx, (~positive).to(stat_neg.dtype))
    tp = stat_pos.flip(0).cumsum(0).flip(0).double()
    fp = stat_neg.flip(0).cumsum(0).flip(0).double()
    tot_pos, tot_neg = tp[0], fp[0]
    zero = torch.zeros((1,), dtype=tp.dtype, device=tp.device)
    tp_next = torch.cat([tp[1:], zero])
    fp_next = torch.cat([fp[1:], zero])
    area = ((fp - fp_next) * (tp + tp_next) / 2.0).sum()
    auc = torch.where((tot_pos > 0) & (tot_neg > 0),
                      area / torch.clamp(tot_pos * tot_neg, min=1.0),
                      torch.zeros((), dtype=tp.dtype, device=tp.device))
    return {"AUC": auc.float().reshape((1,)), "StatPosOut": stat_pos,
            "StatNegOut": stat_neg}
