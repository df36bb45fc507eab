"""Control-flow op kernels (counterpart of
paddle_tpu/ops/control_flow_ops.py). Only ``remat_block`` so far.

``remat_block`` runs a ``recompute_segment``'s sub-block. Its forward
runs the segment's ops with no autograd and keeps only the segment's
inputs (the activation that enters it and the parameters it captures);
its backward runs the segment again with autograd on detached copies of
those inputs and differentiates that run. The JAX package gets the same
from ``jax.checkpoint``. The re-run launches the same kernels on the same
inputs, so it recomputes the same values: the flash-attention and
LayerNorm autograd Functions inside it bring their hand-written backward
kernels, and a dropout draws the mask it drew in the forward: its
generator is keyed on the run and on the op's block and position, not on
a global RNG state, and on a CUDA card the re-run's draw takes a twin
generator seeded as the forward's was, which also holds inside a
captured step (``RunContext.generator``). So nothing is
stashed, and ``torch.utils.checkpoint`` is not used.
"""
import torch

from .registry import register_op


class _RematBlock(torch.autograd.Function):
    """``run(env)`` runs the segment on ``env``, its inputs bound to
    ``in_names``; the outputs are ``env[out_names]``."""

    @staticmethod
    def forward(fctx, run, in_names, out_names, *vals):
        env = dict(zip(in_names, vals))
        run(env, out_names)
        outs = tuple(env[n] for n in out_names)
        fctx.run, fctx.in_names, fctx.out_names = run, in_names, out_names
        fctx.save_for_backward(*vals)
        fctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(fctx, *cots):
        vals = fctx.saved_tensors
        wants = fctx.needs_input_grad[3:]
        leaves = [v.detach().requires_grad_(w and v.is_floating_point())
                  for v, w in zip(vals, wants)]
        env = dict(zip(fctx.in_names, leaves))
        with torch.enable_grad():
            fctx.run(env, fctx.out_names)
        outs, grads_out = [], []
        for n, c in zip(fctx.out_names, cots):
            o = env[n]
            if c is not None and o.requires_grad:
                outs.append(o)
                grads_out.append(c.to(o.dtype))
        wrt = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(outs, wrt, grads_out,
                                         allow_unused=True)
                     if outs and wrt else [None] * len(wrt))
        return (None, None, None) + tuple(
            next(grads) if x.requires_grad else None for x in leaves)


@register_op("remat_block")
def _remat_block(ctx, ins, attrs):
    """A rematerialized segment: the sub-block ``attrs["sub_block"]`` run
    on ``In`` (bound to ``in_names``), giving ``Out`` (its
    ``out_names``)."""
    block = ctx.program.block(attrs["sub_block"])

    def run(env, keep):
        ctx.run_block(block, env, keep)

    outs = _RematBlock.apply(run, list(attrs["in_names"]),
                             list(attrs["out_names"]), *ins["In"])
    return {"Out": list(outs)}
