"""Dygraph (eager/imperative) mode.

Counterpart of paddle_tpu/dygraph/ (reference: python/paddle/fluid/
dygraph/* + paddle/fluid/imperative/). Variables wrap torch tensors on
the guard's device (``guard(place=None)``: ``CUDAPlace(0)`` unless the
caller passes ``CPUPlace()``); torch's autograd is the tape, so
``loss.backward(); opt.minimize(loss)`` runs as in fluid. Layer modules
hold parameters and run the same registered ops as graph mode, so the
hand-written kernels (LayerNorm, flash attention, the fused head,
fused Adam) run eagerly on a CUDA tensor. ``TracedLayer`` captures a
forward into a CUDA graph.
"""
from .base import guard, enabled, to_variable, no_grad, enable_dygraph, \
    disable_dygraph, reset_tape, pause_tape
from .layers import Layer
from .container import Sequential, LayerList, ParameterList
from .nn import (Linear, Conv2D, BatchNorm, Embedding, LayerNorm, Dropout,
                 FC, Conv2DTranspose, Conv3D, Conv3DTranspose, GroupNorm,
                 SpectralNorm, PRelu, NCE, BilinearTensorProduct, RowConv,
                 SequenceConv, TreeConv,
                 Pool2D, GRUUnit)
from .checkpoint import save_dygraph, load_dygraph
from .jit import TracedLayer, dygraph_to_static_graph
from . import optimizers
from . import grad_clip
from .grad_clip import GradClipByValue, GradClipByNorm, GradClipByGlobalNorm
from .parallel import DataParallel, ParallelEnv, prepare_context
from . import learning_rate_scheduler
from .learning_rate_scheduler import (PiecewiseDecay, NaturalExpDecay,
    ExponentialDecay, InverseTimeDecay, PolynomialDecay, CosineDecay,
    NoamDecay, LinearLrWarmup)
