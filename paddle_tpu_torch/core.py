"""Pragmatic stand-in for fluid.core (counterpart of paddle_tpu/core.py;
the reference's C++ pybind module, ref paddle/fluid/pybind/pybind.cc).
Scripts that reach into core for places or scopes port unchanged: here
``CUDAPlace`` is the port's own CUDA place, ``is_compiled_with_cuda`` is
the package's own (the port is built for CUDA) and
``get_cuda_device_count`` reports torch's devices; kernel-level internals
have no counterpart."""
import torch

from .framework.place import (CPUPlace, CUDAPlace,  # noqa: F401
                              is_compiled_with_cuda)
from .framework.scope import Scope  # noqa: F401
from .lod_tensor import LoDTensor  # noqa: F401


class LoDTensorArray(list):
    """reference core.LoDTensorArray: a growable vector of LoDTensors."""
    def append(self, t):
        list.append(self, t)


# host staging is plain host memory
CUDAPinnedPlace = CPUPlace


def get_cuda_device_count():
    """The CUDA devices torch sees (0 without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


__all__ = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "Scope", "LoDTensor",
           "LoDTensorArray", "is_compiled_with_cuda",
           "get_cuda_device_count"]
