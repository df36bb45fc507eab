"""Control-flow op kernels (counterpart of
paddle_tpu/ops/control_flow_ops.py): ``cond``, ``while_loop``,
``bounded_while``, ``recurrent_scan``, ``select_input``, ``print`` and
``remat_block``.

Every op here runs a sub-block of the program through
``RunContext.run_block``, on an environment of the names the sub-block
reads: the op's explicit inputs (its ``Captures``, loop variables,
sequence slices), never the outer step's values. A sub-block's ops run
under the autograd mode of the op that owns it, so where the Executor
runs that op with autograd (a ``grad_of`` names it) its ``grad_of``
differentiates through the sub-block's ops to the captures, as
``jax.vjp`` does through ``lax.cond``/``lax.scan`` in the JAX package.

How each meets the CUDA graph of the Executor's step
(framework/compiled_step.py):

- ``bounded_while``, ``recurrent_scan`` and ``select_input`` have a trip
  count fixed when the program is built and never read a device value on
  the host: a ``bounded_while`` iteration past its predicate's turn keeps
  its carry with ``torch.where`` on the device. They are captured like
  any other op.
- ``cond`` and ``while_loop`` read their predicate on the host (the
  branch, or whether to go on, is chosen there), and ``print`` reads its
  tensor there. They are registered ``syncs_host``: a step holding one
  in any block runs op by op, and the Executor records why
  (``Executor.refusals``).

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


def _leaf_if_constant(val):
    """A float output that the run computed without autograd while the op
    runs with it (a branch that returns a constant) becomes a leaf of its
    own: its cotangent then adds nothing, as ``lax.cond``'s vjp gives
    zeros there."""
    if torch.is_grad_enabled() and val.is_floating_point() and \
            not val.requires_grad:
        return val.detach().requires_grad_()
    return val


def _predicate(val):
    """A scalar predicate read on the host."""
    return bool(val.reshape(()).item())


@register_op("cond", nondiff=("Cond",), syncs_host=True)
def _cond(ctx, ins, attrs):
    """The branch that ``Cond`` picks (read on the host), run on the
    captures; ``Out`` is its ``*_out_names``."""
    taken = "true" if _predicate(ins["Cond"][0]) else "false"
    block = ctx.program.block(attrs[taken + "_block"])
    names = attrs[taken + "_out_names"]
    env = dict(zip(attrs.get("capture_names", []), ins.get("Captures", [])))
    ctx.run_block(block, env, names)
    return {"Out": [_leaf_if_constant(env[n]) for n in names]}


def _loop_env(cap_names, caps, names, vals):
    """A loop block's environment: the captures and the loop vars."""
    env = dict(zip(cap_names, caps))
    env.update(zip(names, vals))
    return env


@register_op("while_loop", nondiff=("LoopVars",), differentiable=False,
             syncs_host=True)
def _while_loop(ctx, ins, attrs):
    """The body block while the cond block's ``cond_out_name`` holds, read
    on the host before each trip. Forward only, as in the JAX package
    (``lax.while_loop``)."""
    program = ctx.program
    cond_block = program.block(attrs["cond_block"])
    body_block = program.block(attrs["body_block"])
    names, cond_out = attrs["loop_var_names"], attrs["cond_out_name"]
    cap_names = attrs.get("capture_names", [])
    caps, vals = ins.get("Captures", []), list(ins["LoopVars"])
    while True:
        env = _loop_env(cap_names, caps, names, vals)
        ctx.run_block(cond_block, env, [cond_out])
        if not _predicate(env[cond_out]):
            return {"Out": vals}
        env = _loop_env(cap_names, caps, names, vals)
        ctx.run_block(body_block, env, names)
        vals = [env[n] for n in names]


def _iterate(step, carry, caps, trips):
    """``trips`` iterations of ``step(carry, captures) -> (pred, new
    carry)``, each keeping ``torch.where(pred, new, carry)``, so the loop
    equals the dynamic one once its predicate has turned false: (the last
    carry, [(each iteration's carry, its predicate)])."""
    seen = []
    for _ in range(trips):
        pred, new = step(carry, caps)
        seen.append((carry, pred))
        carry = tuple(torch.where(pred, n, c) for n, c in zip(new, carry))
    return carry, seen


class _BoundedWhile(torch.autograd.Function):
    """``_iterate`` with a backward that walks the iterations back,
    re-running each body on the carry it saw with autograd, and takes the
    body's vjp only where its predicate held: ``torch.where(pred, vjp,
    cotangent)``. A finished iteration so passes its cotangent on as an
    exact identity, and a body with an infinite Jacobian at the fixpoint
    (sqrt at 0) gives no 0 * inf = NaN, as the JAX package's ``lax.cond``
    inside ``lax.scan`` differentiates only the taken branch."""

    @staticmethod
    def forward(fctx, step, n_vars, trips, *vals):
        carry, fctx.seen = _iterate(step, tuple(vals[:n_vars]),
                                    tuple(vals[n_vars:]), trips)
        fctx.step, fctx.n_vars = step, n_vars
        fctx.save_for_backward(*vals[n_vars:])
        fctx.mark_non_differentiable(
            *[c for c in carry if not c.is_floating_point()])
        return carry

    @staticmethod
    def backward(fctx, *cots):
        caps, n_vars = fctx.saved_tensors, fctx.n_vars
        want_caps = fctx.needs_input_grad[3 + n_vars:]
        cap_grads = [None] * len(caps)
        for carry, pred in reversed(fctx.seen):
            leaves = [v.detach().requires_grad_(v.is_floating_point())
                      for v in carry]
            cap_leaves = [v.detach().requires_grad_(
                w and v.is_floating_point()) for v, w in zip(caps, want_caps)]
            with torch.enable_grad():
                _, new = fctx.step(tuple(leaves), tuple(cap_leaves))
            outs, grads_out = [], []
            for o, c in zip(new, cots):
                if c is not None and o.requires_grad:
                    outs.append(o)
                    grads_out.append(c.to(o.dtype))
            every = leaves + cap_leaves
            wrt = [x for x in every if x.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, grads_out,
                                           allow_unused=True)
                       if outs and wrt else [None] * len(wrt))
            vjp = [next(got) if x.requires_grad else None for x in every]
            cots = [None if not v.is_floating_point() else torch.where(
                pred, g if g is not None else torch.zeros_like(v),
                c if c is not None else torch.zeros_like(v))
                for v, g, c in zip(carry, vjp[:n_vars], cots)]
            for j, g in enumerate(vjp[n_vars:]):
                if g is not None:
                    g = torch.where(pred, g, torch.zeros_like(g))
                    cap_grads[j] = g if cap_grads[j] is None \
                        else cap_grads[j] + g
        fctx.seen = None
        return (None, None, None) + tuple(cots) + tuple(
            torch.zeros_like(c) if g is None and w else g
            for g, w, c in zip(cap_grads, want_caps, caps))


@register_op("bounded_while")
def _bounded_while(ctx, ins, attrs):
    """The differentiable while (``maximum_trip_count``): exactly
    ``max_trip_count`` iterations, the predicate kept on the device
    (``_iterate``; its backward in ``_BoundedWhile``)."""
    program = ctx.program
    cond_block = program.block(attrs["cond_block"])
    body_block = program.block(attrs["body_block"])
    names, cond_out = attrs["loop_var_names"], attrs["cond_out_name"]
    cap_names = list(attrs.get("capture_names", []))

    def step(carry, caps):
        env = _loop_env(cap_names, caps, names, carry)
        ctx.run_block(cond_block, env, [cond_out])
        pred = env[cond_out].reshape(())
        env = _loop_env(cap_names, caps, names, carry)
        ctx.run_block(body_block, env, names)
        return pred, tuple(env[n] for n in names)

    loop_vars, caps = list(ins["LoopVars"]), list(ins.get("Captures", []))
    trips = int(attrs["max_trip_count"])
    if not torch.is_grad_enabled():
        return {"Out": list(_iterate(step, tuple(loop_vars), tuple(caps),
                                     trips)[0])}
    return {"Out": list(_BoundedWhile.apply(step, len(names), trips,
                                            *(loop_vars + caps)))}


@register_op("recurrent_scan")
def _recurrent_scan(ctx, ins, attrs):
    """The sub-block once per step over axis 0 of each ``Seq`` (from the
    end with ``is_reverse``), the carry threaded through: the counterpart
    of ``lax.scan``. ``SeqOut`` stacks each step's outputs in time order;
    ``FinalCarry`` is the last carry. Autograd records every step where
    the op runs with it (backpropagation through time)."""
    block = ctx.program.block(attrs["sub_block"])
    seqs = ins.get("Seq", [])
    seq_names = attrs.get("seq_var_names", [])
    carry_names = attrs.get("carry_var_names", [])
    carry_out = attrs.get("carry_out_names", [])
    step_out = attrs.get("step_out_names", [])
    base = dict(zip(attrs.get("extra_var_names", []), ins.get("Extra", [])))
    carry = list(ins.get("Init", []))
    n = seqs[0].shape[0] if seqs else 0
    steps = range(n - 1, -1, -1) if attrs.get("is_reverse", False) \
        else range(n)
    ys = [[None] * n for _ in step_out]
    keep = list(carry_out) + list(step_out)
    for t in steps:
        env = dict(base)
        env.update(zip(carry_names, carry))
        env.update((name, s[t]) for name, s in zip(seq_names, seqs))
        ctx.run_block(block, env, keep)
        carry = [env[c] for c in carry_out]
        for y, name in zip(ys, step_out):
            y[t] = env[name]
    return {"FinalCarry": carry,
            "SeqOut": [torch.stack(y) for y in ys]}


@register_op("select_input", nondiff=("Mask",))
def _select_input(ctx, ins, attrs):
    """``X[Mask]``, selected on the device (``torch.where``)."""
    mask = ins["Mask"][0].reshape(()).long()
    xs = ins["X"]
    out = xs[0]
    for i, x in enumerate(xs[1:], 1):
        out = torch.where(mask == i, x, out)
    return {"Out": out}


@register_op("print", syncs_host=True)
def _print(ctx, ins, attrs):
    """Identity that prints its message and first ``summarize`` values on
    the host (the JAX package's ``jax.debug.print``); gradients pass
    straight through."""
    x = ins["In"][0]
    n = int(attrs.get("summarize", 20))
    shown = x.detach().reshape(-1)[:n] if n > 0 else x.detach()
    print(str(attrs.get("message", "")), shown.cpu().numpy())
    return {"Out": x}


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
