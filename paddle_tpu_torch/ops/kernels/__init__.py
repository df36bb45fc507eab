"""Hand-written CUDA kernels of the port (counterpart of
paddle_tpu/ops/pallas/): each module holds its kernels' wrappers, their
plain PyTorch versions and their launch counters; ``build`` compiles
csrc/ at first use."""
from . import build, flash_attention, fused_adam, layer_norm  # noqa: F401
