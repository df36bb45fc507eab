"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py).

Only ``recompute_segment`` so far: ``cond``, ``while_loop``, ``switch``
and the fluid control-flow classes arrive with the Transformer slice.
"""
from ..framework.program import Variable, default_main_program
from ..layer_helper import LayerHelper


def _collect_captures(blocks_and_outs, bound_names):
    """Outer-scope names the sub-blocks read (read before written, plus
    returned but never defined), beyond ``bound_names``. Listing them as
    the op's explicit inputs is what lets gradients reach them: the
    Executor differentiates an op with respect to its declared inputs."""
    captured, seen = [], set(bound_names)
    for block, out_names in blocks_and_outs:
        defined = set(bound_names)
        for op in block.ops:
            for n in op.input_names():
                if n not in defined and n not in seen and \
                        not n.startswith("@"):
                    captured.append(n)
                    seen.add(n)
            defined.update(op.output_names())
        for n in out_names:
            if n not in defined and n not in seen and not n.startswith("@"):
                captured.append(n)
                seen.add(n)
    return captured


def recompute_segment(fn, inputs, name=None):
    """``fn(*inputs)`` inside a rematerialized segment: the segment's
    activations are not kept for the backward, which runs the segment
    again (``remat_block``, ops/control_flow_ops.py). The parameters and
    outer vars the segment reads are found as captures, so gradients
    still reach them."""
    helper = LayerHelper("recompute", name=name)
    program = default_main_program()
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    inputs = list(inputs)

    block = program._create_block()
    try:
        outs = fn(*inputs)
    finally:
        program._rollback()
    if isinstance(outs, Variable):
        outs = [outs]
    outs = list(outs)

    input_names = {v.name for v in inputs}
    captured = _collect_captures([(block, [v.name for v in outs])],
                                 bound_names=input_names)
    parent = program.current_block()
    cap_vars = []
    for n in captured:
        v = parent._find_var_recursive(n)
        if v is None:
            v = block._find_var_recursive(n)
        cap_vars.append(v)

    in_all = inputs + [v for v in cap_vars if v is not None]
    out_vars = [helper.create_variable_for_type_inference(v.dtype, v.shape)
                for v in outs]
    helper.append_op(
        "remat_block",
        inputs={"In": [v.name for v in in_all]},
        outputs={"Out": [v.name for v in out_vars]},
        attrs={"sub_block": block.idx,
               "in_names": [v.name for v in in_all],
               "out_names": [v.name for v in outs]})
    if len(out_vars) == 1:
        return out_vars[0]
    return out_vars


__all__ = ["recompute_segment"]
