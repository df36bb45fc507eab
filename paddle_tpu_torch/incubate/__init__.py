"""fluid.incubate: the data generators (``incubate.data_generator``)."""
from . import data_generator  # noqa: F401
