"""Graph-level reverse-mode autodiff on a Program.

Counterpart of paddle_tpu/framework/backward.py (append_backward,
calc_gradient_in_block, gradients): the same algorithm emits the same
ops, so a training program built by either package serializes the same.

  1. slice the block to the ops the loss transitively depends on;
  2. forward-propagate "grad-connected" (reachable from a trainable
     parameter, not stop_gradient, float);
  3. walk the slice in reverse, emitting one generic ``grad_of`` op per
     forward op, and a ``sum`` op where a var has several gradient
     contributions (``_GradAccumulator``; BERT's tied word embedding gets
     one from ``lookup_table`` and one from ``fused_mlm_head_loss``).

The Executor computes each ``grad_of`` from its forward op's autograd
record (framework/trace.py).
"""
from .dtypes import is_float
from .program import grad_var_name
from .trace import EMPTY_VAR, GRAD_OP_TYPE
from ..ops.registry import get_op, has_op

_RENAME = "@RENAME@"


def _producer_sliced_ops(block, target_name):
    """Ops (in order) that target transitively depends on, ending at the
    last producer of target."""
    last = -1
    for i, op in enumerate(block.ops):
        if target_name in op.output_names():
            last = i
    if last < 0:
        raise ValueError("target var %r is not produced by any op in the "
                         "block; cannot differentiate" % target_name)
    needed = {target_name}
    keep = [False] * (last + 1)
    for i in range(last, -1, -1):
        op = block.ops[i]
        if op.type == GRAD_OP_TYPE:
            continue
        if any(o in needed for o in op.output_names()):
            keep[i] = True
            needed.update(op.input_names())
    return [block.ops[i] for i in range(last + 1) if keep[i]]


def _connected_set(block, sliced_ops, roots, no_grad_set):
    connected = set(roots) - no_grad_set
    for op in sliced_ops:
        if has_op(op.type) and not get_op(op.type).differentiable:
            continue
        if not any(n in connected for n in op.input_names()):
            continue
        for n in op.output_names():
            if n in no_grad_set:
                continue
            v = block._find_var_recursive(n)
            if v is not None and v.stop_gradient:
                continue
            if v is not None and not is_float(v.dtype):
                continue
            connected.add(n)
    return connected


class _GradAccumulator(object):
    """Tracks per-var gradient contributions; names them var@GRAD,
    var@GRAD@RENAME@1, ... and emits a sum op when there are several."""

    def __init__(self, block):
        self.block = block
        self.contribs = {}

    def next_name(self, var_name):
        lst = self.contribs.setdefault(var_name, [])
        g = grad_var_name(var_name)
        name = g if not lst else g + _RENAME + str(len(lst))
        lst.append(name)
        return name

    def finalize(self, var_name):
        """The final grad name for var (emitting sum if needed), or None
        if no contribution exists. A single contribution keeps its own
        name: var@GRAD, or a caller's target gradient. (The JAX package
        returns var@GRAD there, a var nothing writes when the target
        gradient was given.)"""
        lst = self.contribs.get(var_name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        g = grad_var_name(var_name)
        self.block.append_op(
            "sum", inputs={"X": list(lst)}, outputs={"Out": [g]},
            attrs={"op_role": "backward"})
        self.contribs[var_name] = [g]
        return g


def _ensure_grad_var(block, base_name, grad_name):
    if not block.has_var(grad_name):
        base = block._find_var_recursive(base_name)
        block.create_var(name=grad_name,
                         shape=base.shape if base is not None else None,
                         dtype=base.dtype if base is not None else "float32",
                         persistable=False, stop_gradient=True)
    return block.vars.get(grad_name)


def calc_gradient_in_block(block, target, roots, no_grad_set,
                           target_grad_name=None):
    """Core engine shared by append_backward() and gradients()."""
    no_grad_set = set(no_grad_set or ())
    sliced = _producer_sliced_ops(block, target.name)
    connected = _connected_set(block, sliced, roots, no_grad_set)
    if target.name not in connected:
        return {}

    acc = _GradAccumulator(block)
    # seed d(target) = 1 (or the user-provided cotangent)
    if target_grad_name is None:
        seed_name = acc.next_name(target.name)
        _ensure_grad_var(block, target.name, seed_name)
        block.append_op(
            "fill_any_like", inputs={"X": [target.name]},
            outputs={"Out": [seed_name]},
            attrs={"value": 1.0, "op_role": "backward"})
    else:
        acc.contribs[target.name] = [target_grad_name]

    for op in reversed(sliced):
        in_names = op.input_names()
        if not any(n in connected and n not in no_grad_set
                   for n in in_names):
            continue
        og = {}
        any_og = False
        for slot, names in op.outputs.items():
            lst = []
            for n in names:
                g = acc.finalize(n) if n in connected or n == target.name \
                    else None
                g = g if g is not None else EMPTY_VAR
                any_og = any_og or g != EMPTY_VAR
                lst.append(g)
            og["OG:" + slot] = lst
        if not any_og:
            continue

        # slots the kernel declares non-differentiable never receive a
        # gradient: no name is registered for them
        nondiff_slots = set(get_op(op.type).nondiff) if has_op(op.type) \
            else set()
        ig = {}
        for slot, names in op.inputs.items():
            lst = []
            for n in names:
                if slot not in nondiff_slots and n in connected and \
                        n not in no_grad_set:
                    gname = acc.next_name(n)
                    _ensure_grad_var(block, n, gname)
                    lst.append(gname)
                else:
                    lst.append(EMPTY_VAR)
            if any(x != EMPTY_VAR for x in lst):
                ig["IG:" + slot] = lst
        if not ig:
            continue

        grad_inputs = {"X:" + slot: names for slot, names in op.inputs.items()}
        grad_inputs.update(og)
        block.append_op(
            GRAD_OP_TYPE, inputs=grad_inputs, outputs=ig,
            attrs={"fwd_type": op.type, "fwd_id": op.desc_id,
                   "fwd_attrs": dict(op.attrs), "op_role": "backward"})

    out = {}
    for r in roots:
        g = acc.finalize(r)
        if g is not None:
            out[r] = g
    return out


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter. Returns [(param_var, grad_var)] (fluid
    backward.append_backward)."""
    block = loss.block
    program = block.program
    if parameter_list is not None:
        roots = [p.name if hasattr(p, "name") else p for p in parameter_list]
    else:
        roots = [p.name for p in program.all_parameters()
                 if getattr(p, "trainable", True)]
    grad_map = calc_gradient_in_block(block, loss, roots,
                                      set(no_grad_set or ()))
    result = []
    for r in roots:
        g = grad_map.get(r)
        if g is None:
            continue
        param = block._find_var_recursive(r)
        gvar = block.vars.get(g) or _ensure_grad_var(block, r, g)
        result.append((param, gvar))
    if not result:
        raise ValueError(
            "append_backward: no parameter receives a gradient from %r "
            "(is every path stop_gradient?)" % loss.name)
    return result


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) (fluid.gradients)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    block = targets[0].block
    roots = [v.name for v in inputs]
    merged = {}
    for t, tg in zip(targets, target_gradients):
        gm = calc_gradient_in_block(
            block, t, roots, set(no_grad_set or ()),
            target_grad_name=tg.name if tg is not None else None)
        for r, g in gm.items():
            if r in merged:
                s = grad_var_name(r) + "@MULTI_TARGET"
                block.append_op("sum", inputs={"X": [merged[r], g]},
                                outputs={"Out": [s]},
                                attrs={"op_role": "backward"})
                _ensure_grad_var(block, r, s)
                merged[r] = s
            else:
                merged[r] = g
    return [block.vars.get(merged[v.name]) if v.name in merged else None
            for v in inputs]


__all__ = ["append_backward", "calc_gradient_in_block", "gradients"]
