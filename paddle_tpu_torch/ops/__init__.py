"""Op kernels of the port; importing this package registers them."""
from . import registry  # noqa: F401
from . import (attention_ops, contrib_ops, control_flow_ops,  # noqa: F401
               crf_ops, detection_ops, detection_train_ops, extras_ops,
               loss_extra_ops, math_ops, metric_ops, misc_ops, nn_ops,
               optimizer_ops, quant_ops, random_ops, rnn_ops, sequence_ops,
               tensor_ops, vision_ops)
