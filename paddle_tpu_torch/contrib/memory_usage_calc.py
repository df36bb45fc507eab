"""Train-memory estimator (counterpart of
paddle_tpu/contrib/memory_usage_calc.py; fluid's
contrib/memory_usage_calc.py).

``memory_usage(program, batch_size)`` sums the byte size of every
variable in the Program (batch dim -1 resolved to ``batch_size``) and
returns the reference's (low, high) band in MB around it. On the card
the caching allocator reuses freed blocks, so a step's peak
(``torch.cuda.max_memory_allocated``) lands below the static sum.
"""
from ..framework import program as program_mod
from ..framework.dtypes import dtype_size

__all__ = ["memory_usage"]

DEBUG = False

dtype_to_size = None  # kept for reference-API symmetry; see dtype_size


def memory_usage(program, batch_size):
    """Estimate the program's memory demand in MB (ref :46): returns
    (min_MB, max_MB)."""
    if not isinstance(program, program_mod.Program):
        raise TypeError(
            "Calculating Memory Usage requires Program as its Parameter. "
            "But you passed in %s" % type(program))
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    total_memory = 0.0
    processed = set()
    for block in program.blocks:
        for var in block.vars.values():
            if var.name in processed or var.shape is None:
                continue
            processed.add(var.name)
            data_count = 1
            neg_dim_count = 0
            for x in var.shape:
                if x < 0:
                    if neg_dim_count >= 1:
                        raise ValueError(
                            "Var %s has more than one negative dim." %
                            var.name)
                    neg_dim_count = 1
                    data_count *= batch_size * (-x)
                else:
                    data_count *= x
            var_memory = data_count * dtype_size(var.dtype)
            if DEBUG:
                print("%s memory usage: %d" % (var.name, var_memory))
            total_memory += var_memory
    if DEBUG:
        print("total memory usage: %.2f" % total_memory)

    # the reference's +-30% band around the static sum
    min_memory = total_memory * 0.7 / (1024 ** 2)
    max_memory = total_memory * 1.3 / (1024 ** 2)
    return min_memory, max_memory
