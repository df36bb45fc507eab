"""Memory-optimization transpiler (counterpart of paddle_tpu/transpiler/
memory_optimization_transpiler.py; ref python/paddle/fluid/transpiler/
memory_optimization_transpiler.py).

The reference walks op liveness and renames dead vars so buffers get
reused. The port's Executor already frees each value after its last
reader and updates optimizer state in place, and a captured step reuses
its memory pool, so renaming would change nothing but the Program. These
functions validate their arguments, stamp the request on the Program and
leave it unchanged, as the JAX package's do.
"""
from ..framework import program as program_mod

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """Record a buffer-reuse request on the Program (ref :18)."""
    if level != 0 and level != 1:
        raise ValueError("only level 0 and level 1 are supported")
    if not isinstance(input_program, program_mod.Program):
        raise TypeError("memory_optimize expects a Program, got %s" %
                        type(input_program))
    input_program._memory_optimize_requested = True
    input_program._memory_optimize_skip = set(skip_opt_set or ())
    if print_log:
        print("memory_optimize: the Executor frees each value after its "
              "last reader; the Program is unchanged")
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """Early-delete pass (ref :42): the Executor's last-reader frees do
    it; kept as a validated no-op."""
    if not isinstance(input_program, program_mod.Program):
        raise TypeError("release_memory expects a Program, got %s" %
                        type(input_program))
    input_program._release_memory_requested = True
    return input_program
