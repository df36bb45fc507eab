"""Counterpart of paddle_tpu/transpiler/details/program_utils.py (ref
transpiler/details/program_utils.py): the helpers the
transpilers use to edit Program IR, against the port's Block/Operator."""

__all__ = ["delete_ops", "find_op_by_input_arg", "find_op_by_output_arg"]


def delete_ops(block, ops):
    doomed = {id(op) for op in ops}
    block.ops[:] = [op for op in block.ops if id(op) not in doomed]
    block.program._version += 1


def find_op_by_input_arg(block, arg_name):
    # Operator.input_names() flattens to VAR names; slot iteration needs
    # the .inputs dict keys
    for index, op in enumerate(block.ops):
        for slot in op.inputs:
            if arg_name in op.input(slot):
                return index
    return -1


def find_op_by_output_arg(block, arg_name, reverse=False):
    ops = list(enumerate(block.ops))
    if reverse:
        ops = reversed(ops)
    for index, op in ops:
        for slot in op.outputs:
            if arg_name in op.output(slot):
                return index
    return -1
