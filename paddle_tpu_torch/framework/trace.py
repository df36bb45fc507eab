"""Per-op pairing of a forward op with its gradient op.

Counterpart of paddle_tpu/framework/trace.py:245-350. There, each forward
op that a ``grad_of`` op names is traced under ``jax.vjp`` and the grad op
later calls the captured vjp function. Here the forward op runs under
``torch.enable_grad()`` on detached copies of the inputs its ``grad_of``
asks a gradient for (``requires_grad_()`` on those slots only, never on a
``nondiff`` slot), and the (inputs, outputs) pair is kept; the ``grad_of``
op calls ``torch.autograd.grad(outputs, inputs, cotangents)`` and, at the
last ``grad_of`` naming that forward op, drops the record, so the graph's
saved tensors free as the backward walks down.
A custom ``torch.autograd.Function`` inside an op (the flash-attention and
LayerNorm kernels) brings its hand-written backward kernel into this
call.

The in-place rule: an op may update an input in place (``OpDef.inplace``:
the fused-Adam kernel writes a parameter and its moments on the card),
and autograd's saved tensors are views of the scope's own tensors, whose
version a write through a raw pointer does not bump. So where a forward
op's record is still live (a later ``grad_of`` names it) when such an op
overwrites one of its inputs (DCGAN: the generator's backward runs
through the discriminator after the discriminator's Adam), the record
keeps a copy of that input, made when the forward runs
(``overwritten_inputs``, decided once per plan from the block). A
program without that order copies nothing. The JAX package needs no
rule: its values are immutable, so its gradient reads the old value.

A ``grad_of`` whose forward op did not run in the same Executor.run (a
pruned program) re-runs that forward from the ``X:`` inputs and
``fwd_attrs`` it carries, under autograd, as the JAX package's
``_trace_grad_op`` does (paddle_tpu/framework/trace.py:296-316). A
recomputed segment is not that case: its ``remat_block`` op runs in the
forward and re-runs its sub-block inside its own backward
(ops/control_flow_ops.py).
"""
import torch

from ..ops.registry import NotPortedError, get_op

EMPTY_VAR = "@EMPTY@"
GRAD_OP_TYPE = "grad_of"


class GradRecord(object):
    """A forward op's differentiable inputs and its outputs, kept from the
    forward op to its ``grad_of``."""
    __slots__ = ("inputs", "outputs")

    def __init__(self, inputs, outputs):
        self.inputs = inputs      # [((slot, index), leaf tensor)]
        self.outputs = outputs    # {slot: [tensor, ...]}


def wanted_grads(block):
    """({forward desc_id: {slot: input indices}}, {forward desc_id: index
    of its last grad_of op}): for each forward op some ``grad_of`` names,
    the input positions asked an ``IG:`` for, and where its record may
    go (``gradients`` over several targets emits one grad_of per target
    for a shared forward op)."""
    want, last = {}, {}
    for i, op in enumerate(block.ops):
        if op.type != GRAD_OP_TYPE:
            continue
        fwd_id = op.attrs["fwd_id"]
        last[fwd_id] = i
        slots = want.setdefault(fwd_id, {})
        for out_slot, names in op.outputs.items():
            if not out_slot.startswith("IG:"):
                continue
            idx = [j for j, n in enumerate(names) if n != EMPTY_VAR]
            slots.setdefault(out_slot[3:], set()).update(idx)
    return want, last


def overwritten_inputs(block, last_grad):
    """{forward desc_id: {slot: input indices}}: for each forward op with a
    record (``last_grad``, from ``wanted_grads``), the inputs (their
    positions among the slot's non-empty names, as the op receives them)
    that an op with ``OpDef.inplace`` slots overwrites after the forward
    op and before its last ``grad_of``. Empty for a program without that
    order."""
    writes, pos = [], {}
    for i, op in enumerate(block.ops):
        if op.type == GRAD_OP_TYPE:
            continue
        pos[op.desc_id] = i
        for slot in get_op(op.type).inplace:
            writes.extend((i, n) for n in op.inputs.get(slot, ()))
    keep = {}
    for fid, last in last_grad.items():
        i = pos.get(fid)
        hit = {n for j, n in writes if i is not None and i < j < last}
        if not hit:
            continue
        for slot, names in block.ops[i].inputs.items():
            names = [n for n in names if n != EMPTY_VAR]
            idx = {k for k, n in enumerate(names) if n in hit}
            if idx:
                keep.setdefault(fid, {})[slot] = idx
    return keep


def _as_list(vals):
    return list(vals) if isinstance(vals, (list, tuple)) else [vals]


def run_recorded(opdef, ins, attrs, ctx, want, keep=None):
    """Run one forward op with autograd on the inputs ``want`` names
    ({slot: indices}), on copies of the inputs ``keep`` names (the
    in-place rule); returns (outputs, GradRecord)."""
    leaves, ins2 = [], {}
    for slot, vals in ins.items():
        vals = list(vals)
        for i in (keep or {}).get(slot, ()):
            vals[i] = vals[i].detach().clone()
        if slot not in opdef.nondiff:
            for i in sorted(want.get(slot, ())):
                if i < len(vals) and vals[i].is_floating_point():
                    vals[i] = vals[i].detach().requires_grad_()
                    leaves.append(((slot, i), vals[i]))
        ins2[slot] = vals
    with torch.enable_grad():
        outs = opdef.fn(ctx, ins2, attrs)
    kept = {slot: _as_list(v) for slot, v in outs.items() if v is not None}
    return outs, GradRecord(leaves, kept)


def _rerun_forward(op, env, ctx):
    """The record of a ``grad_of``'s forward op that did not run: the
    forward re-run from the op's ``X:`` inputs and ``fwd_attrs``, with
    autograd on the inputs its ``IG:`` slots ask for."""
    ins = {slot[2:]: [env[n] for n in names if n != EMPTY_VAR]
           for slot, names in op.inputs.items() if slot.startswith("X:")}
    want = {slot[3:]: {j for j, n in enumerate(names) if n != EMPTY_VAR}
            for slot, names in op.outputs.items() if slot.startswith("IG:")}
    _, rec = run_recorded(get_op(op.attrs["fwd_type"]), ins,
                          op.attrs.get("fwd_attrs", {}), ctx, want)
    return rec


def run_grad_op(op, env, records, ctx, last):
    """The ``grad_of`` op: d(inputs) of its forward op from the cotangents
    its ``OG:`` slots carry. ``last``: no later grad_of names the same
    forward op, so its record (and autograd graph) is dropped. Returns
    {"IG:slot": [tensor, ...]} aligned with the op's output names."""
    fwd_type, fwd_id = op.attrs["fwd_type"], op.attrs["fwd_id"]
    rec = records.pop(fwd_id, None) if last else records.get(fwd_id)
    if rec is None:
        rec = _rerun_forward(op, env, ctx)
        if not last:
            records[fwd_id] = rec
    outs, cots = [], []
    for slot, vals in rec.outputs.items():
        og_names = op.inputs.get("OG:" + slot, [EMPTY_VAR] * len(vals))
        for name, val in zip(og_names, vals):
            if name == EMPTY_VAR or name not in env:
                # no OG: its cotangent is zero, and a zero cotangent adds
                # nothing to the vjp, so the output is left out of it
                continue
            if not val.requires_grad:
                raise NotPortedError(
                    "grad_of(%s): output %r of slot %r carries a gradient, "
                    "but the port computes that output without one (e.g. "
                    "layer_norm's Mean/Variance); its gradient arrives with "
                    "a later slice of paddle_tpu_torch"
                    % (fwd_type, name, slot))
            outs.append(val)
            cots.append(env[name].to(val.dtype))
    leaves = [t for _, t in rec.inputs]
    grads = [None] * len(leaves)
    if outs and leaves:
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True,
                                    retain_graph=not last)
    result = {}
    for ((slot, i), leaf), g in zip(rec.inputs, grads):
        names = op.outputs.get("IG:" + slot)
        if not names or i >= len(names) or names[i] == EMPTY_VAR:
            continue
        # an input the outputs do not depend on gets zeros, as jax.vjp
        # gives them
        result.setdefault("IG:" + slot, [None] * len(names))[i] = \
            g if g is not None else torch.zeros_like(leaf)
    for slot, names in op.outputs.items():
        vals = result.get(slot, [None] * len(names))
        for name, v in zip(names, vals):
            if v is None and name != EMPTY_VAR:
                raise RuntimeError(
                    "grad_of(%s): no gradient produced for %r (slot %s); is "
                    "the input non-differentiable?" % (fwd_type, name, slot))
    return result


__all__ = ["EMPTY_VAR", "GRAD_OP_TYPE", "GradRecord", "wanted_grads",
           "overwritten_inputs", "run_recorded", "run_grad_op"]
