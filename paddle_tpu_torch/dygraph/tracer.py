"""fluid.dygraph.tracer (counterpart of paddle_tpu/dygraph/tracer.py):
the recording machinery is torch's autograd (dygraph/base.py); Tracer
exposes the live recorded variables as its tape."""
from . import base as _base

__all__ = ["Tracer"]


class Tracer(object):
    """The reference's Tracer wraps the C++ imperative tracer; here
    ``tape`` lists the live variables a recorded op produced (their
    autograd graphs are the tape)."""

    def __init__(self, block=None):
        self._block = block

    @property
    def tape(self):
        return list(_base._tape)
