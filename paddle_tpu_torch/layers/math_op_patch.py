"""fluid.layers.math_op_patch parity (counterpart of
paddle_tpu/layers/math_op_patch.py; ref layers/math_op_patch.py). The
reference monkey-patches Variable with arithmetic dunders at import
time; here they are defined on framework.program.Variable itself, so
monkey_patch_variable only checks that they are there."""
from ..framework.program import Variable

__all__ = ["monkey_patch_variable"]


def monkey_patch_variable():
    assert hasattr(Variable, "__add__") and hasattr(Variable, "__mul__")
