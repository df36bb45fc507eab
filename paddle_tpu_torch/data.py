"""fluid.data (counterpart of paddle_tpu/data.py; ref
python/paddle/fluid/data.py).

Unlike ``layers.data`` (which prepends an implicit -1 batch dimension),
``fluid.data`` declares the FULL shape; ``None`` dims mean any size.
Feeds are checked against it at run time by the Executor's feed boundary
(the named rank and shape errors of ``Executor._feed_tensors``).
"""
from .layers import io as _io

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0):
    # layers.io.data defaults stop_gradient=True (feed vars)
    return _io.data(name, [(-1 if s is None else int(s)) for s in shape],
                    dtype=dtype, append_batch_size=False,
                    lod_level=lod_level)
