"""fluid.dygraph.parallel_helper (counterpart of
paddle_tpu/dygraph/parallel_helper.py; internal env helpers)."""
import os

__all__ = ["_is_data_parallel_mode", "_is_parallel_ctx_initialized"]


def _is_data_parallel_mode():
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1")) > 1


def _is_parallel_ctx_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()
