"""contrib (counterpart of paddle_tpu/contrib/): mixed precision
(``mixed_precision.decorate``), the extended optimizers
(``extend_optimizer``: gradient merge, pipeline annotation), the
multi-layer RNN compositions and ``ctr_metric_bundle`` of
``contrib.layers``, the seq2seq decoders of ``contrib.decoder``, the
Book's ``Trainer`` and ``Inferencer``, ``distributed_batch_reader`` and
the program statistics (``summary``, ``memory_usage``,
``op_freq_statistic``), post-training int8 weights (``quantize``), model
compression (``slim``: quant-aware training, pruning, distillation, the
Compressor, the NAS searcher) and ``utils`` (the HDFS and lookup-table
helpers, which point at the port's own save and load)."""
from . import mixed_precision  # noqa: F401
from . import extend_optimizer  # noqa: F401
from . import quantize  # noqa: F401
from . import slim  # noqa: F401
from . import utils  # noqa: F401
from . import layers  # noqa: F401
from . import decoder  # noqa: F401
from . import trainer  # noqa: F401
from . import inferencer  # noqa: F401
from . import reader  # noqa: F401
from .reader import distributed_batch_reader  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .inferencer import Inferencer  # noqa: F401
from . import model_stat  # noqa: F401
from . import memory_usage_calc  # noqa: F401
from . import op_frequence  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
from .model_stat import summary  # noqa: F401
from .op_frequence import op_freq_statistic  # noqa: F401
