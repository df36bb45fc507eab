"""Module-path alias for fluid.backward (ref
python/paddle/fluid/backward.py): graph-level autodiff entry points live
in framework/backward.py; this name exists so ``import
paddle_tpu_torch.backward`` ports 1:1."""
from .framework.backward import append_backward, gradients, \
    calc_gradient_in_block  # noqa: F401

__all__ = ["append_backward", "gradients"]
