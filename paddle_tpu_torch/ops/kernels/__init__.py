"""Hand-written CUDA kernels of the port (counterpart of
paddle_tpu/ops/pallas/): each module holds a kernel's wrapper, its plain
PyTorch version and its launch counter; ``build`` compiles csrc/ at first
use."""
from . import build, flash_attention, layer_norm  # noqa: F401
