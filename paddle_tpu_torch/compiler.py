"""Module-path alias for fluid.compiler (counterpart of
paddle_tpu/compiler.py; ref python/paddle/fluid/compiler.py)."""
from .framework.compiler import CompiledProgram, BuildStrategy, \
    ExecutionStrategy, CompilePlan  # noqa: F401

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "CompilePlan"]
