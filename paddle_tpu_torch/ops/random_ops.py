"""Random op kernels (counterparts of every op of
paddle_tpu/ops/random_ops.py).

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


@register_op("randint", uses_rng=True)
def _randint(ctx, ins, attrs):
    """Integers uniform in [low, high)."""
    out = torch.randint(attrs.get("low", 0), attrs.get("high", 100),
                        tuple(attrs["shape"]), generator=ctx.generator(attrs),
                        device=ctx.device)
    return {"Out": out.to(to_torch_dtype(attrs.get("dtype", "int64")))}


@register_op("randperm", uses_rng=True)
def _randperm(ctx, ins, attrs):
    """A permutation of 0 .. n-1: a stable argsort of int64 keys drawn on
    the device, so a captured step draws a new one at every replay."""
    n = attrs["n"]
    keys = torch.randint(0, 2 ** 62, (n,), generator=ctx.generator(attrs),
                         device=ctx.device)
    perm = torch.sort(keys, stable=True).indices
    return {"Out": perm.to(to_torch_dtype(attrs.get("dtype", "int64")))}


@register_op("bernoulli", uses_rng=True)
def _bernoulli(ctx, ins, attrs):
    """1 with probability X (uniform < X, as ``jax.random.bernoulli``)."""
    x = ins["X"][0]
    u = torch.rand(x.shape, generator=ctx.generator(attrs), device=x.device)
    return {"Out": (u < x).to(x.dtype)}


@register_op("sampling_id", uses_rng=True, nondiff=("X",))
def _sampling_id(ctx, ins, attrs):
    """One class a row, drawn in proportion to X's row (unnormalised
    probabilities), by the Gumbel-max rule ``jax.random.categorical``
    uses on log(max(x, 1e-20)); int64."""
    x = ins["X"][0]
    u = torch.rand(x.shape, generator=ctx.generator(attrs), device=x.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return {"Out": torch.argmax(torch.log(torch.clamp(x.float(), min=1e-20))
                                + gumbel, dim=-1)}
