"""Dataset package (counterpart of paddle_tpu/dataset). Two namespaces
merge here, as there:

  * the corpus modules (ref python/paddle/dataset/): ``uci_housing``,
    ``mnist``, ``cifar``, ``imikolov``, ``imdb``, ``movielens``,
    ``conll05``, ``wmt14``, ``wmt16``, ``sentiment``, ``flowers``,
    ``mq2007`` and ``voc2012``, with ``image``, ``common`` and
    ``synthetic``: deterministic synthetic payloads in the reference's
    record schemas, numpy only, equal to the JAX package's sample for
    sample;
  * the fluid Dataset API: DatasetFactory, InMemoryDataset and
    QueueDataset over the C++ data plane.
"""
from .dataset_api import (DatasetFactory, DatasetBase,  # noqa: F401
                          QueueDataset, InMemoryDataset)
from . import common  # noqa: F401
from . import synthetic  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import wmt14  # noqa: F401
from . import sentiment  # noqa: F401
from . import wmt16  # noqa: F401
from . import mq2007  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import image  # noqa: F401

__all__ = ['mnist', 'imikolov', 'imdb', 'cifar', 'movielens', 'conll05',
           'sentiment', 'uci_housing', 'wmt14', 'wmt16', 'mq2007',
           'flowers', 'voc2012', 'image', 'common', 'synthetic',
           'DatasetFactory', 'DatasetBase', 'QueueDataset',
           'InMemoryDataset']
