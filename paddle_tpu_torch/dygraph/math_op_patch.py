"""fluid.dygraph.math_op_patch (counterpart of
paddle_tpu/dygraph/math_op_patch.py). The reference monkey-patches
VarBase with arithmetic dunders at import time; here they are defined on
the eager Variable type itself, so patching is a verified no-op."""
from .base import EagerVariable

__all__ = ["monkey_patch_math_varbase"]


def monkey_patch_math_varbase():
    if not (hasattr(EagerVariable, "__add__") and
            hasattr(EagerVariable, "__mul__")):
        raise AssertionError("EagerVariable lacks its arithmetic operators")
