"""Neural-net op kernels BERT inference runs: lookup_table, dropout,
layer_norm (counterparts in paddle_tpu/ops/nn_ops.py)."""
import math

import torch

from .kernels import layer_norm as _ln_kernel
from .registry import NotPortedError, register_op


@register_op("lookup_table", nondiff=("Ids",))
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    out = w[ids]
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return {"Out": out}


@register_op("dropout", uses_rng=True)
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    mask = torch.ones_like(x, dtype=torch.uint8)
    if attrs.get("is_test", False):
        if impl == "upscale_in_train":
            return {"Out": x, "Mask": mask}
        return {"Out": x * (1.0 - p), "Mask": mask}
    if p <= 0.0:
        return {"Out": x, "Mask": mask}
    raise NotPortedError(
        "dropout with is_test=False and dropout_prob=%r draws a random mask; "
        "training-mode dropout arrives with the BERT training slice of "
        "paddle_tpu_torch" % (p,))


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Collapse to (rows, cols) at begin_norm_axis and run the LayerNorm
    kernel wrapper; Mean/Variance come from its per-row mean and rstd."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    cols = math.prod(x.shape[begin:])
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    y, mean, rstd = _ln_kernel.layer_norm(x.reshape(-1, cols), scale, bias,
                                          eps)
    return {"Y": y.reshape(x.shape),
            "Mean": mean.reshape(lead),
            "Variance": (rstd.pow(-2) - eps).reshape(lead)}
