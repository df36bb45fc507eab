"""Module-path alias for fluid.trainer_desc (counterpart of
paddle_tpu/trainer_desc.py; ref python/paddle/fluid/trainer_desc.py)."""
from .trainer_factory import TrainerDesc, MultiTrainer, \
    DistMultiTrainer  # noqa: F401

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer"]
