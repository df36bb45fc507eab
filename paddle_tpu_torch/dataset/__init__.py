"""The fluid Dataset API (counterpart of paddle_tpu/dataset):
DatasetFactory, InMemoryDataset and QueueDataset over the C++ data
plane. The corpus modules of the JAX package (mnist, cifar, wmt16, ...)
are not ported yet; ROADMAP.md lists them."""
from .dataset_api import (DatasetFactory, DatasetBase,  # noqa: F401
                          QueueDataset, InMemoryDataset)

__all__ = ['DatasetFactory', 'DatasetBase', 'QueueDataset',
           'InMemoryDataset']
