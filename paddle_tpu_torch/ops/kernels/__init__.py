"""Hand-written CUDA kernels of the port (counterpart of
paddle_tpu/ops/pallas/): each module holds its kernels' wrappers, their
plain PyTorch versions and their launch counters; ``build`` compiles
csrc/ at first use."""
from . import (blockwise_ce, build, flash_attention, fused_adam,  # noqa: F401
               layer_norm)
