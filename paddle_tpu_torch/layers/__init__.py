"""paddle_tpu_torch.layers — the fluid.layers surface the port has so far."""
from .tensor import (create_parameter, cast, concat,  # noqa: F401
                     sums, assign, fill_constant, zeros_like, ones_like,
                     fill_constant_batch_size_like, argmax, reverse,
                     tensor_array_to_tensor, argmin, argsort,
                     create_global_var, create_tensor, diag, eye, has_inf,
                     has_nan, isfinite, linspace, ones, range, zeros)
from .ops import *           # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .io import (data, py_reader, read_file,  # noqa: F401
                 double_buffer, EOFException, create_py_reader_by_data,
                 load)
from .attention import *     # noqa: F401,F403
from .loss import *          # noqa: F401,F403
from .metric_op import *     # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .rnn import *           # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .vision import *        # noqa: F401,F403
from .extras import *        # noqa: F401,F403
from . import detection  # noqa: F401
from .detection import (  # noqa: F401
    prior_box, density_prior_box, multi_box_head, anchor_generator,
    bipartite_match, target_assign, detection_output, ssd_loss,
    sigmoid_focal_loss, iou_similarity, box_coder, polygon_box_transform,
    yolov3_loss, yolo_box, box_clip, multiclass_nms,
    distribute_fpn_proposals, collect_fpn_proposals, box_decoder_and_assign,
    generate_proposals, roi_align, roi_pool, rpn_target_assign,
    retinanet_target_assign, generate_proposal_labels,
    locality_aware_nms, retinanet_detection_output,
    roi_perspective_transform, generate_mask_labels)
from . import learning_rate_scheduler  # noqa: F401
from .distributions import (Normal, Uniform, Categorical,  # noqa: F401
                            MultivariateNormalDiag)
from . import utils  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup)
# the ``rnn`` function shadows the layers.rnn submodule, as in the JAX
# package and fluid 1.6
from .rnn_api import (RNNCell, GRUCell, LSTMCell, rnn, lstm,  # noqa: F401
                      dynamic_lstmp, Decoder, BeamSearchDecoder,
                      dynamic_decode, beam_search, beam_search_decode)
from . import rnn_api  # noqa: F401
from .layer_function_generator import (generate_layer_fn,  # noqa: F401
    generate_activation_fn, deprecated, autodoc, templatedoc)
from . import layer_function_generator  # noqa: F401
