"""paddle.batch (counterpart of paddle_tpu/batch.py; ref
python/paddle/batch.py).

The implementation lives in reader.decorator; this module re-exports it
under the reference's module path. Because `import paddle_tpu_torch.batch`
rebinds the package attribute `batch` from the function to this module
(the same footgun the reference had), the module itself is made callable
and delegates to the function, so both spellings work.
"""
import sys
import types

from .reader.decorator import batch

__all__ = ["batch"]


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return batch(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
