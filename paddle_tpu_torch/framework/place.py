"""Device places.

Counterpart of paddle_tpu/framework/place.py. The port's accelerator is a
CUDA card: ``CUDAPlace`` is the default place, and resolving it without a
CUDA device raises ``NoCUDADeviceError`` rather than running on the CPU.
Only an explicit ``CPUPlace()`` runs on the CPU (the tests do that).
"""
import torch


class NoCUDADeviceError(RuntimeError):
    """A CUDA place was asked for (explicitly or by default) and torch
    sees no CUDA device."""


class Place(object):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self):
        raise NotImplementedError


class CUDAPlace(Place):
    def torch_device(self):
        if not torch.cuda.is_available():
            raise NoCUDADeviceError(
                "%r needs a CUDA device and torch sees none; pass "
                "CPUPlace() explicitly to run on the CPU" % (self,))
        if self.device_id >= torch.cuda.device_count():
            raise NoCUDADeviceError(
                "%r: only %d CUDA device(s) visible"
                % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


class CPUPlace(Place):
    def __init__(self):
        super(CPUPlace, self).__init__(0)

    def torch_device(self):
        return torch.device("cpu")


def _current_expected_place():
    """The place an entry point uses when the caller names none."""
    return CUDAPlace(0)


def resolve_device(place=None):
    """torch.device for *place* (default: ``_current_expected_place()``);
    raises NoCUDADeviceError for a CUDA place without a CUDA device."""
    return (place if place is not None
            else _current_expected_place()).torch_device()


def is_compiled_with_cuda():
    """The port is built for CUDA (the JAX package answers False)."""
    return True
