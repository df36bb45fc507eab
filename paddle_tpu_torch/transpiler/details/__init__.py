"""fluid.transpiler.details (counterpart of paddle_tpu/transpiler/
details/): Program manipulation helpers."""
from .program_utils import delete_ops, find_op_by_input_arg, \
    find_op_by_output_arg  # noqa: F401

__all__ = ["delete_ops", "find_op_by_input_arg", "find_op_by_output_arg"]
