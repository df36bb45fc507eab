"""fluid.communicator (counterpart of paddle_tpu/communicator.py; ref
python/paddle/fluid/communicator.py).

The reference Communicator drives asynchronous parameter-server sends,
which exist to hide a slow network between trainers and pservers. The
port syncs data-parallel gradients inside the step, so constructing a
Communicator raises with that guidance instead of doing nothing.
"""

__all__ = ["Communicator"]


class Communicator(object):
    def __init__(self, program=None):
        raise NotImplementedError(
            "asynchronous communicator modes have no counterpart in "
            "paddle_tpu_torch: synchronous data parallelism "
            "(CompiledProgram over a device mesh) replaces GEO and "
            "async SGD")
