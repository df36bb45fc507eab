"""DataFeeder: python/numpy samples into feed dicts (counterpart of
paddle_tpu/data_feeder.py; ref python/paddle/fluid/data_feeder.py)."""
import numpy as np

from .framework.dtypes import normalize_dtype


def _numpy_dtype(dtype):
    """numpy has no bfloat16: such a feed goes as float32, and the
    Executor casts it to the program's dtype."""
    name = normalize_dtype(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    def feed(self, iterable):
        """iterable: list of samples, each a tuple aligned with feed_list."""
        columns = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            arr = np.stack([np.asarray(x) for x in col])
            out[var.name] = arr.astype(_numpy_dtype(var.dtype), copy=False)
        return out
