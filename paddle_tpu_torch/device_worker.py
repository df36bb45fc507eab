"""Module-path alias for fluid.device_worker (counterpart of
paddle_tpu/device_worker.py; ref python/paddle/fluid/device_worker.py)."""
from .trainer_factory import DeviceWorker, Hogwild, DownpourSGD, \
    Section  # noqa: F401

__all__ = ["DeviceWorker", "Hogwild", "DownpourSGD", "Section"]
