"""Model compression (counterpart of paddle_tpu/contrib/slim/; reference
fluid/contrib/slim).

- prune: mask-based magnitude and structured pruning, sensitivity sweeps
- distill: soft-label, L2 and FSP distillation losses, the teacher merge
  (module-path alias: slim.distillation)
- qat: the quantization-aware training pass (fake-quant ops with a
  straight-through gradient) and its freeze (module-path alias:
  slim.quantization)
- core: the Compressor run loop
- graph: GraphWrapper program introspection
- searcher / nas: the SAController simulated annealing, the LightNAS
  search loop, the controller server and its search agent
- post-training int8 weights live in contrib.quantize
"""
from .prune import (Pruner, MagnitudePruner, StructurePruner, PruneHelper,
                    sensitivity)
from .distill import (soft_label_loss, l2_distill_loss, fsp_matrix,
                      fsp_loss, merge)
from .qat import quant_aware, convert, QUANTIZABLE
from .core import Compressor  # noqa: F401
