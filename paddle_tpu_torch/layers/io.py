"""Input layers (counterpart of paddle_tpu/layers/io.py::data)."""
from ..framework.program import default_main_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable. append_batch_size=True prepends -1 (batch),
    as fluid.layers.data does."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().global_block().create_var(
        name=name, shape=tuple(shape), dtype=dtype, is_data=True,
        stop_gradient=stop_gradient, lod_level=lod_level)
