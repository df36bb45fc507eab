"""fluid.incubate: the data generators (``incubate.data_generator``) and
the fleet package's parameter-server stubs (``incubate.fleet``)."""
from . import data_generator  # noqa: F401
from . import fleet  # noqa: F401
