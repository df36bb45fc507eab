"""Random init op kernels (counterparts in paddle_tpu/ops/random_ops.py).

Each draws from the seeded ``torch.Generator`` that ``ctx.generator``
hands it: the op's own ``seed`` attr when non-zero, else one derived from
the program's random_seed and the op's position. torch's Philox stream is
not JAX's threefry, so the two packages agree in distribution only.
"""
import torch

from .registry import register_op
from ..framework.dtypes import to_torch_dtype


@register_op("gaussian_random", uses_rng=True)
def _gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(generator=ctx.generator(attrs))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", uses_rng=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=ctx.generator(attrs))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * out
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}


@register_op("uniform_random", uses_rng=True)
def _uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator(attrs))
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "float32")))}
