"""fluid.dygraph.varbase_patch_methods (counterpart of
paddle_tpu/dygraph/varbase_patch_methods.py): VarBase conveniences
(numpy()/backward()/gradient()) are defined directly on the eager
Variable type here; patching is a no-op."""
__all__ = ["monkey_patch_varbase"]


def monkey_patch_varbase():
    pass
