"""fluid.layers.device parity (counterpart of paddle_tpu/layers/device.py;
ref python/paddle/fluid/layers/device.py: get_places, deprecated even in
the reference)."""
from .. import core
from ..annotations import deprecated
from ..framework.place import CPUPlace, CUDAPlace, NoCUDADeviceError

__all__ = ["get_places"]


@deprecated(since="0.15.0", instead="ParallelExecutor / CompiledProgram")
def get_places(device_count=None, device_type=None):
    """The places of torch's CUDA devices (``device_type`` None, "cuda"
    or "gpu"; NoCUDADeviceError when there is none) or ``[CPUPlace()]``
    for "cpu", cut to ``device_count``."""
    if device_type == "cpu":
        return [CPUPlace()]
    n = core.get_cuda_device_count()
    if n == 0:
        raise NoCUDADeviceError(
            "get_places lists CUDA devices and torch sees none; pass "
            "device_type='cpu' for the CPU")
    places = [CUDAPlace(i) for i in range(n)]
    return places[:device_count] if device_count else places
